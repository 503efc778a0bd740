// Flash attention forward and backward for Hopper (sm_90a): the training
// path's attention core, [bh, L, D] per folded (batch, head) row.
//
// Replaces the Pallas TPU kernels of the JAX package
//   distributeddeeplearning_tpu/ops/flash_attention.py  _fwd_kernel  (fwd)
//   distributeddeeplearning_tpu/ops/flash_attention.py  _dq_kernel   (dq)
//   distributeddeeplearning_tpu/ops/flash_attention.py  _dkv_kernel  (dkv)
//
// Semantics (the reference's): s = (scale*q) k^T in fp32; a column is visible
// to row r when col < limit, limit = min(valid_len, vl[bh]) (the static pad
// limit and the runtime per-row key-padding limit, one code path for both),
// and, under causal, col <= r. Hidden scores are a finite -1e30. The forward
// runs the online softmax (m, l, acc in fp32), writes o = acc / max(l, 1e-30)
// in the input type and lse = m + log(max(l, 1e-30)) in fp32. The backward
// recomputes p = exp(s - lse); delta = rowsum(dO * O);
//   dq = scale * sum_k p (dO V^T - delta) K,
//   dk = scale * sum_q (p (dO V^T - delta))^T Q,   dv = sum_q p^T dO.
// The dq kernel computes delta once per row and stores it (fp32 [bh, L]) for
// the dk/dv kernel, which runs after it on the same stream; the JAX dk/dv
// kernel recomputes it per tile, which is the same function.
//
// Design. On the TPU the kv (or q) blocks were a sequential third grid axis
// with the carries in VMEM scratch. Here blocks run in parallel and in no
// order, so the grid is (bh, q-blocks) for fwd and dq and (bh, kv-blocks) for
// dk/dv, and a loop inside the block walks the other axis. Under causal the
// loop stops at the diagonal block; it also stops at the row's column limit,
// so blocks that hold only hidden columns are never read. Tiles are 64 x 64
// in shared memory, converted to fp32 at load (rows padded by one float so
// the column-strided reads are free of bank conflicts); 256 threads each own
// 4 rows x 4 strided columns of a score tile and 4 rows x D/16 strided
// columns of the output accumulator, kept in registers. Row statistics are
// reduced over the 16 lanes that share a row with shuffles. Rows and columns
// past L (a length that is no multiple of 64) are zero-filled and hidden.
//
// Bound. At GPT-2 124M's training shapes (bh = 384, L = 1024, D = 64, bf16,
// causal) the forward moves ~201 MB and does ~51.5 GFLOP of visible-tile
// matrix work: ~256 flops per byte, at the H100's ~295 bf16 tensor-core
// balance point, so its least time is the larger of the two,
// ~0.06 ms (bytes). The backward does 2.5x the forward's matrix work over
// ~2x the bytes. This first version does the matrix work in fp32 on the CUDA
// cores from shared memory, so it runs far from that bound (its times are in
// PERF.md); wgmma with TMA-fed bf16 tiles is the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // finite: exp(kNegInf - m) == 0, no NaN
constexpr int kThreads = 256;
constexpr int kBlock = 64;          // rows of a q tile and of a kv tile
constexpr int kSP = kBlock + 1;     // pitch of a 64 x 64 score tile

enum DType : int { kF32 = 0, kBF16 = 1 };
enum Kernel : int { kFwd = 0, kDq = 1, kDkv = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Max / sum over the 16 lanes of a half-warp (the threads sharing a row).
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [r0, r0 + 64) of src [L, D] -> dst [64, D + 1] fp32, times mul; rows
// past L are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int L, float mul) {
  constexpr int P = D + 1;
  for (int idx = threadIdx.x; idx < kBlock * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int row = r0 + r;
    dst[r * P + d] =
        row < L ? to_f32(src[static_cast<size_t>(row) * D + d]) * mul : 0.f;
  }
}

__device__ __forceinline__ int col_limit(const int* vl, int bh, int limit,
                                         int L) {
  int lim = limit < L ? limit : L;
  if (vl != nullptr) {
    const int v = vl[bh];
    lim = v < lim ? v : lim;
  }
  return lim;
}

// Number of kv tiles a q tile starting at q0 reads: columns < lim, and under
// causal columns <= q0 + 63.
__device__ __forceinline__ int kv_tiles(int q0, int lim, int causal) {
  int end = lim;
  if (causal && q0 + kBlock < end) end = q0 + kBlock;
  return end > 0 ? (end + kBlock - 1) / kBlock : 0;
}

template <int D>
constexpr int fwd_smem_floats() {
  return 3 * kBlock * (D + 1) + kBlock * kSP;
}
template <int D>
constexpr int dq_smem_floats() {
  return 4 * kBlock * (D + 1) + kBlock * kSP;
}
template <int D>
constexpr int dkv_smem_floats() {
  return 4 * kBlock * (D + 1) + 2 * kBlock * kSP + 2 * kBlock;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ vl,
                     T* __restrict__ o, float* __restrict__ lse, int L,
                     int limit, int causal, float scale) {
  constexpr int P = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlock * P;
  float* Vs = Ks + kBlock * P;
  float* Ps = Vs + kBlock * P;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlock;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = static_cast<size_t>(bh) * L * D;
  const int lim = col_limit(vl, bh, limit, L);
  const int nkv = kv_tiles(q0, lim, causal);

  load_tile<T, D>(Qs, q + base, q0, L, scale);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int kb = 0; kb < nkv; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, k + base, k0, L, 1.f);
    load_tile<T, D>(Vs, v + base, k0, L, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * P + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * P + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < lim && (!causal || col <= row);
        s[i][j] = ok ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * kSP + tx + 16 * j] = p;
        rs += p;
      }
      rs = row_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlock; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * kSP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= L) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = o + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] / lc);
    if (tx == 0) lse[static_cast<size_t>(bh) * L + row] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// backward: dq (and delta)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const int* __restrict__ vl, T* __restrict__ dq,
                    float* __restrict__ delta, int L, int limit, int causal,
                    float scale) {
  constexpr int P = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBlock * P;
  float* Ks = dOs + kBlock * P;
  float* Vs = Ks + kBlock * P;
  float* DS = Vs + kBlock * P;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlock;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = static_cast<size_t>(bh) * L * D;
  const int lim = col_limit(vl, bh, limit, L);
  const int nkv = kv_tiles(q0, lim, causal);

  load_tile<T, D>(Qs, q + base, q0, L, scale);
  load_tile<T, D>(dOs, dout + base, q0, L, 1.f);
  __syncthreads();

  float lse_r[4], delta_r[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, row = q0 + r;
    float part = 0.f;
    if (row < L) {
      const T* orow = o + base + static_cast<size_t>(row) * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        part += dOs[r * P + tx + 16 * j] * to_f32(orow[tx + 16 * j]);
    }
    part = row_sum(part);
    delta_r[i] = part;
    lse_r[i] = row < L ? lse[static_cast<size_t>(bh) * L + row] : 0.f;
    if (tx == 0 && row < L) delta[static_cast<size_t>(bh) * L + row] = part;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int kb = 0; kb < nkv; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();
    load_tile<T, D>(Ks, k + base, k0, L, 1.f);
    load_tile<T, D>(Vs, v + base, k0, L, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * P + d];
        dv[i] = dOs[(ty * 4 + i) * P + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * P + d];
        vv[j] = Vs[(tx + 16 * j) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += dv[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < lim && (!causal || col <= row);
        const float p = expf((ok ? s[i][j] : kNegInf) - lse_r[i]);
        DS[(ty * 4 + i) * kSP + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlock; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = DS[(ty * 4 + i) * kSP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kk = Ks[c * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += dsv[i] * kk;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= L) continue;
    T* drow = dq + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      drow[tx + 16 * j] = from_f32<T>(scale * acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ vl, T* __restrict__ dk,
                     T* __restrict__ dv, int L, int limit, int causal,
                     float scale) {
  constexpr int P = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBlock * P;
  float* Qs = Vs + kBlock * P;
  float* dOs = Qs + kBlock * P;
  float* PT = dOs + kBlock * P;
  float* DST = PT + kBlock * kSP;
  float* lse_s = DST + kBlock * kSP;
  float* delta_s = lse_s + kBlock;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlock;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = static_cast<size_t>(bh) * L * D;
  const int lim = col_limit(vl, bh, limit, L);
  const int nq = (L + kBlock - 1) / kBlock;
  // Under causal, q tiles wholly above this kv tile see none of it; a kv
  // tile at or past the column limit is hidden from every row.
  const int qb0 = causal ? k0 / kBlock : 0;
  const int qb1 = k0 < lim ? nq : qb0;

  load_tile<T, D>(Ks, k + base, k0, L, 1.f);
  load_tile<T, D>(Vs, v + base, k0, L, 1.f);

  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int qb = qb0; qb < qb1; ++qb) {
    const int q0 = qb * kBlock;
    __syncthreads();
    // Q scaled: s = (scale q) k^T, and dk = sum ds^T (scale q) carries the
    // reference's factor of scale.
    load_tile<T, D>(Qs, q + base, q0, L, scale);
    load_tile<T, D>(dOs, dout + base, q0, L, 1.f);
    for (int r = tid; r < kBlock; r += kThreads) {
      const int row = q0 + r;
      const size_t at = static_cast<size_t>(bh) * L + row;
      lse_s[r] = row < L ? lse[at] : 0.f;
      delta_s[r] = row < L ? delta[at] : 0.f;
    }
    __syncthreads();

    // Thread owns kv rows c = ty*4 + i and q rows r = tx + 16*j.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty * 4 + i) * P + d];
        vv[i] = Vs[(ty * 4 + i) * P + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(tx + 16 * j) * P + d];
        dov[j] = dOs[(tx + 16 * j) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += kv[i] * qv[j];
          dp[i][j] += vv[i] * dov[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j, row = q0 + r;
        const bool ok = col < lim && (!causal || col <= row);
        const float p = expf((ok ? s[i][j] : kNegInf) - lse_s[r]);
        PT[(ty * 4 + i) * kSP + r] = p;
        DST[(ty * 4 + i) * kSP + r] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kBlock; ++r) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = PT[(ty * 4 + i) * kSP + r];
        dsv[i] = DST[(ty * 4 + i) * kSP + r];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float dd = dOs[r * P + tx + 16 * j];
        const float qq = Qs[r * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][j] += pv[i] * dd;
          dk_acc[i][j] += dsv[i] * qq;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = k0 + ty * 4 + i;
    if (col >= L) continue;
    T* krow = dk + base + static_cast<size_t>(col) * D;
    T* vrow = dv + base + static_cast<size_t>(col) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      krow[tx + 16 * j] = from_f32<T>(dk_acc[i][j]);
      vrow[tx + 16 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Fn>
cudaError_t prepare(Fn fn, int smem_bytes) {
  // Above 48 KB a block's dynamic shared memory needs an opt-in, once per
  // kernel instantiation.
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

template <int D>
long long smem_bytes(int kernel) {
  switch (kernel) {
    case kFwd: return fwd_smem_floats<D>() * 4LL;
    case kDq: return dq_smem_floats<D>() * 4LL;
    case kDkv: return dkv_smem_floats<D>() * 4LL;
    default: return -1;
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* vl, void* o, void* lse, int bh, int L,
                       int limit, int causal, float scale, cudaStream_t s) {
  const int smem = fwd_smem_floats<D>() * 4;
  cudaError_t err = prepare(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (L + kBlock - 1) / kBlock);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(vl),
      static_cast<T*>(o), static_cast<float*>(lse), L, limit, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      const void* vl, void* dq, void* delta, int bh, int L,
                      int limit, int causal, float scale, cudaStream_t s) {
  const int smem = dq_smem_floats<D>() * 4;
  cudaError_t err = prepare(flash_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (L + kBlock - 1) / kBlock);
  flash_dq_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const int*>(vl), static_cast<T*>(dq),
      static_cast<float*>(delta), L, limit, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* vl, void* dk, void* dv, int bh, int L,
                       int limit, int causal, float scale, cudaStream_t s) {
  const int smem = dkv_smem_floats<D>() * 4;
  cudaError_t err = prepare(flash_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (L + kBlock - 1) / kBlock);
  flash_dkv_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(vl), static_cast<T*>(dk), static_cast<T*>(dv),
      L, limit, causal, scale);
  return cudaGetLastError();
}

// Dispatch on (dtype, head_dim): f(T, D) instantiations for float and bf16
// at D = 64 and 128; anything else is refused.
#define DDL_FLASH_DISPATCH(dtype, head_dim, CALL)                    \
  do {                                                               \
    if ((dtype) == kF32 && (head_dim) == 64) return CALL(float, 64); \
    if ((dtype) == kF32 && (head_dim) == 128) return CALL(float, 128); \
    if ((dtype) == kBF16 && (head_dim) == 64)                        \
      return CALL(__nv_bfloat16, 64);                                \
    if ((dtype) == kBF16 && (head_dim) == 128)                       \
      return CALL(__nv_bfloat16, 128);                               \
    return cudaErrorInvalidValue;                                    \
  } while (0)

}  // namespace

extern "C" {

// Dynamic shared memory one thread block of `kernel` (0 fwd, 1 dq, 2 dkv)
// uses at head_dim, in bytes; -1 for a head_dim without an instantiation.
long long ddl_flash_smem_bytes(int kernel, int head_dim) {
  if (head_dim == 64) return smem_bytes<64>(kernel);
  if (head_dim == 128) return smem_bytes<128>(kernel);
  return -1;
}

const char* ddl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() of the launch. q, k, v, o, dout, dq, dk, dv are
// contiguous [bh, L, head_dim] in one type (0 f32, 1 bf16); lse and delta
// [bh, L] f32; vl [bh] i32 or null; limit the static column limit.

int ddl_flash_fwd(const void* q, const void* k, const void* v, const void* vl,
                  void* o, void* lse, int bh, int L, int head_dim, int limit,
                  int causal, float scale, int dtype, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (bh == 0 || L == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DDL_CALL(T, D) \
  launch_fwd<T, D>(q, k, v, vl, o, lse, bh, L, limit, causal, scale, s)
  DDL_FLASH_DISPATCH(dtype, head_dim, DDL_CALL);
#undef DDL_CALL
}

int ddl_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* lse,
                     const void* vl, void* dq, void* delta, int bh, int L,
                     int head_dim, int limit, int causal, float scale,
                     int dtype, void* stream) {
  cudaGetLastError();
  if (bh == 0 || L == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DDL_CALL(T, D)                                                      \
  launch_dq<T, D>(q, k, v, o, dout, lse, vl, dq, delta, bh, L, limit, causal, \
                  scale, s)
  DDL_FLASH_DISPATCH(dtype, head_dim, DDL_CALL);
#undef DDL_CALL
}

int ddl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* vl, void* dk, void* dv, int bh, int L,
                      int head_dim, int limit, int causal, float scale,
                      int dtype, void* stream) {
  cudaGetLastError();
  if (bh == 0 || L == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DDL_CALL(T, D)                                                   \
  launch_dkv<T, D>(q, k, v, dout, lse, delta, vl, dk, dv, bh, L, limit,    \
                   causal, scale, s)
  DDL_FLASH_DISPATCH(dtype, head_dim, DDL_CALL);
#undef DDL_CALL
}

}  // extern "C"
