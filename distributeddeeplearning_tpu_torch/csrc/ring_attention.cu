// Ring attention block kernels for Hopper (sm_90a): one visiting KV block of
// the context-parallel ring folded into this rank's carries, forward and
// backward, [bh, L, D] per folded (batch, head) row. L is the local sequence
// length; the queries' block and the visiting block are both L long.
//
// Replaces the Pallas TPU kernels of the JAX package
//   distributeddeeplearning_tpu/ops/ring_attention_pallas.py
//     _ring_step_kernel  (ring_step: the online-softmax carries)
//     _ring_dq_kernel    (ring_dq:   dq of the visiting block)
//     _ring_dkv_kernel   (ring_dkv:  dk, dv onto the rotating carries)
//
// Semantics (the reference's). mode 0: every score of the block is visible;
// mode 1 (the diagonal block): column c is visible to row r when c <= r.
// Columns and rows past L are hidden. Hidden scores are a finite -1e30.
//   ring_step: s = qf k^T (qf is pre-scaled fp32); m' = max(m, rowmax s),
//     p = exp(s - m'), l' = l exp(m - m') + rowsum p,
//     acc' = acc exp(m - m') + p V; all fp32, carried in and out.
//   ring_dq: p = exp((scale q) k^T - lse), ds = p (dO V^T - delta),
//     dq' = dq + scale ds K.
//   ring_dkv: dv' = dv + p^T dO, dk' = dk + scale ds^T Q.
// delta = rowsum(dO * O) comes in, computed outside the kernels as the
// reference does. The carries are read at the start and written at the end
// of each block, into separate output buffers (the wrapper hands fresh ones).
//
// Design. These are the flash kernels of flash_attention.cu with external
// carries: the grid is (bh, 64-row q tiles) for ring_step and ring_dq and
// (bh, 64-row kv tiles) for ring_dkv, and a loop inside the block walks the
// other axis (to the diagonal tile in mode 1). Tiles are 64 x 64 in fp32
// shared memory (rows padded by one float against bank conflicts); 256
// threads each own 4 rows x 4 strided columns of a score tile and 4 rows x
// D/16 strided columns of the accumulator, in registers, seeded from the
// carries; row statistics are reduced over the 16 lanes that share a row.
// The mode is a runtime argument: which block visits is known at run time.
//
// Bound. At the cp=2 training shapes of GPT-2 124M (bh = 384, L = 512,
// D = 64, bf16 k/v, fp32 carries) a mode-0 ring_step moves ~203 MB (qf and
// acc in/out fp32, k and v bf16): ~0.06 ms at 3.35 TB/s, above its ~25.8
// GFLOP over the bf16 tensor cores (~0.026 ms); the backward kernels move
// 201 MB (dq) and 302 MB (dk/dv), so all three are bound by bytes. This
// first version does the products in fp32 on the CUDA cores from shared
// memory, far from that bound (its times are in PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // finite: exp(kNegInf - m) == 0, no NaN
constexpr int kThreads = 256;
constexpr int kBlock = 64;       // rows of a q tile and of a kv tile
constexpr int kSP = kBlock + 1;  // pitch of a 64 x 64 score tile

enum DType : int { kF32 = 0, kBF16 = 1 };
enum Kernel : int { kStep = 0, kDq = 1, kDkv = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

__device__ __forceinline__ bool visible(int row, int col, int L, int mode) {
  return col < L && (mode == 0 || col <= row);
}

// kv tiles a q tile starting at q0 reads: all of them in mode 0, through
// the diagonal tile in mode 1.
__device__ __forceinline__ int kv_tiles(int q0, int L, int mode) {
  int end = L;
  if (mode && q0 + kBlock < end) end = q0 + kBlock;
  return (end + kBlock - 1) / kBlock;
}

template <int D>
constexpr int step_smem_floats() {
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
// ring_step: the forward carries
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    ring_step_kernel(const float* __restrict__ qf, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ m_in,
                     const float* __restrict__ l_in,
                     const float* __restrict__ acc_in,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     float* __restrict__ acc_out, int L, int mode) {
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
  const size_t rbase = static_cast<size_t>(bh) * L;
  const int nkv = kv_tiles(q0, L, mode);

  load_tile<float, D>(Qs, qf + base, q0, L, 1.f);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const bool in = row < L;
    m[i] = in ? m_in[rbase + row] : kNegInf;
    l[i] = in ? l_in[rbase + row] : 0.f;
    const float* arow = acc_in + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = in ? arow[tx + 16 * j] : 0.f;
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
        s[i][j] = visible(row, col, L, mode) ? s[i][j] : kNegInf;
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
    float* arow = acc_out + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) arow[tx + 16 * j] = acc[i][j];
    if (tx == 0) {
      m_out[rbase + row] = m[i];
      l_out[rbase + row] = l[i];
    }
  }
}

// ---------------------------------------------------------------------------
// ring_dq
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    ring_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const float* __restrict__ dq_in, float* __restrict__ dq_out,
                   int L, int mode, float scale) {
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
  const size_t rbase = static_cast<size_t>(bh) * L;
  const int nkv = kv_tiles(q0, L, mode);

  load_tile<T, D>(Qs, q + base, q0, L, scale);
  load_tile<T, D>(dOs, dout + base, q0, L, 1.f);

  float lse_r[4], delta_r[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_r[i] = row < L ? lse[rbase + row] : 0.f;
    delta_r[i] = row < L ? delta[rbase + row] : 0.f;
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
        const float sv = visible(row, col, L, mode) ? s[i][j] : kNegInf;
        const float p = expf(sv - lse_r[i]);
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
    const size_t at = base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      dq_out[at + c] = dq_in[at + c] + scale * acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// ring_dkv
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    ring_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ dk_in,
                    const float* __restrict__ dv_in,
                    float* __restrict__ dk_out, float* __restrict__ dv_out,
                    int L, int mode, float scale) {
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
  const size_t rbase = static_cast<size_t>(bh) * L;
  const int nq = (L + kBlock - 1) / kBlock;
  // In mode 1, q tiles wholly above this kv tile see none of it.
  const int qb0 = mode ? k0 / kBlock : 0;

  load_tile<T, D>(Ks, k + base, k0, L, 1.f);
  load_tile<T, D>(Vs, v + base, k0, L, 1.f);

  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int qb = qb0; qb < nq; ++qb) {
    const int q0 = qb * kBlock;
    __syncthreads();
    // Q scaled: s = (scale q) k^T, and dk = sum ds^T (scale q) carries the
    // reference's factor of scale.
    load_tile<T, D>(Qs, q + base, q0, L, scale);
    load_tile<T, D>(dOs, dout + base, q0, L, 1.f);
    for (int r = tid; r < kBlock; r += kThreads) {
      const int row = q0 + r;
      lse_s[r] = row < L ? lse[rbase + row] : 0.f;
      delta_s[r] = row < L ? delta[rbase + row] : 0.f;
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
        // Rows past L hold zero q and dO: their p is masked to 0 here so
        // neither product picks them up.
        const bool ok = row < L && visible(row, col, L, mode);
        const float p = ok ? expf(s[i][j] - lse_s[r]) : 0.f;
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
    const size_t at = base + static_cast<size_t>(col) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      dk_out[at + c] = dk_in[at + c] + dk_acc[i][j];
      dv_out[at + c] = dv_in[at + c] + dv_acc[i][j];
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
    case kStep: return step_smem_floats<D>() * 4LL;
    case kDq: return dq_smem_floats<D>() * 4LL;
    case kDkv: return dkv_smem_floats<D>() * 4LL;
    default: return -1;
  }
}

template <typename T, int D>
cudaError_t launch_step(const void* qf, const void* k, const void* v,
                        const void* m_in, const void* l_in, const void* acc_in,
                        void* m_out, void* l_out, void* acc_out, int bh, int L,
                        int mode, cudaStream_t s) {
  const int smem = step_smem_floats<D>() * 4;
  cudaError_t err = prepare(ring_step_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (L + kBlock - 1) / kBlock);
  ring_step_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(qf), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(m_in),
      static_cast<const float*>(l_in), static_cast<const float*>(acc_in),
      static_cast<float*>(m_out), static_cast<float*>(l_out),
      static_cast<float*>(acc_out), L, mode);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* dq_in, void* dq_out, int bh, int L, int mode,
                      float scale, cudaStream_t s) {
  const int smem = dq_smem_floats<D>() * 4;
  cudaError_t err = prepare(ring_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (L + kBlock - 1) / kBlock);
  ring_dq_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(dq_in), static_cast<float*>(dq_out), L, mode,
      scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* dk_in, const void* dv_in, void* dk_out,
                       void* dv_out, int bh, int L, int mode, float scale,
                       cudaStream_t s) {
  const int smem = dkv_smem_floats<D>() * 4;
  cudaError_t err = prepare(ring_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (L + kBlock - 1) / kBlock);
  ring_dkv_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(dk_in), static_cast<const float*>(dv_in),
      static_cast<float*>(dk_out), static_cast<float*>(dv_out), L, mode,
      scale);
  return cudaGetLastError();
}

// Dispatch on (dtype, head_dim): f(T, D) instantiations for float and bf16
// at D = 64 and 128; anything else is refused.
#define DDL_RING_DISPATCH(dtype, head_dim, CALL)                      \
  do {                                                                \
    if ((dtype) == kF32 && (head_dim) == 64) return CALL(float, 64);  \
    if ((dtype) == kF32 && (head_dim) == 128) return CALL(float, 128); \
    if ((dtype) == kBF16 && (head_dim) == 64)                         \
      return CALL(__nv_bfloat16, 64);                                 \
    if ((dtype) == kBF16 && (head_dim) == 128)                        \
      return CALL(__nv_bfloat16, 128);                                \
    return cudaErrorInvalidValue;                                     \
  } while (0)

}  // namespace

extern "C" {

// Dynamic shared memory one thread block of `kernel` (0 step, 1 dq, 2 dkv)
// uses at head_dim, in bytes; -1 for a head_dim without an instantiation.
long long ddl_ring_smem_bytes(int kernel, int head_dim) {
  if (head_dim == 64) return smem_bytes<64>(kernel);
  if (head_dim == 128) return smem_bytes<128>(kernel);
  return -1;
}

const char* ddl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() of the launch. Tensors are contiguous [bh, L,
// head_dim] (or [bh, L] for m, l, lse, delta); k, v (and q, dout in the
// backward) in one type (0 f32, 1 bf16); qf and every carry f32.

int ddl_ring_step(const void* qf, const void* k, const void* v,
                  const void* m_in, const void* l_in, const void* acc_in,
                  void* m_out, void* l_out, void* acc_out, int bh, int L,
                  int head_dim, int mode, int dtype, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (bh == 0 || L == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DDL_CALL(T, D)                                                     \
  launch_step<T, D>(qf, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, bh, \
                    L, mode, s)
  DDL_RING_DISPATCH(dtype, head_dim, DDL_CALL);
#undef DDL_CALL
}

int ddl_ring_dq(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, const void* dq_in,
                void* dq_out, int bh, int L, int head_dim, int mode,
                float scale, int dtype, void* stream) {
  cudaGetLastError();
  if (bh == 0 || L == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DDL_CALL(T, D) \
  launch_dq<T, D>(q, k, v, dout, lse, delta, dq_in, dq_out, bh, L, mode, scale, s)
  DDL_RING_DISPATCH(dtype, head_dim, DDL_CALL);
#undef DDL_CALL
}

int ddl_ring_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 const void* dk_in, const void* dv_in, void* dk_out,
                 void* dv_out, int bh, int L, int head_dim, int mode,
                 float scale, int dtype, void* stream) {
  cudaGetLastError();
  if (bh == 0 || L == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DDL_CALL(T, D)                                                     \
  launch_dkv<T, D>(q, k, v, dout, lse, delta, dk_in, dv_in, dk_out, dv_out, \
                   bh, L, mode, scale, s)
  DDL_RING_DISPATCH(dtype, head_dim, DDL_CALL);
#undef DDL_CALL
}

}  // extern "C"
