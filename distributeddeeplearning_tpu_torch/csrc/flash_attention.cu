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
// so blocks that hold only hidden columns are never read. Rows and columns
// past L (a length that is no multiple of a tile) are zero-filled and hidden.
//
// Two designs share that skeleton.
// - bf16 fwd, dq and dk/dv (namespace tc, on the tile walks of tc_mma.cuh,
//   which the bf16 ring kernels share): the tensor cores. bf16 operands go
//   through mma.sync.m16n8k16 with fp32 accumulators. Tiles arrive in
//   XOR-swizzled shared memory by 16-byte cp.async into a two-slot ring, so
//   the next tile loads while this one is multiplied, and ldmatrix(.trans)
//   reads them without bank conflicts. The forward's block owns 128 q rows
//   (64 at D = 128, where 128 would spill), 4 warps of 16-row strips with
//   Q held as A fragments; S stays in registers, the online softmax runs in
//   log2 units on the fragments (exp2, row reductions over the 4 lanes of a
//   quad), and P goes to bf16 in registers as the A operand of P V. dq's
//   block owns 64 q rows, one strip a warp, with Q and dO held as A
//   fragments: S = Q K^T and dP = dO V^T stay in registers, and dS, as bf16, is the A
//   operand of dQ += dS K; delta is computed in its prologue from the dO
//   tile and O's rows. dk/dv's block owns 64 kv rows with kv rows as the
//   MMA's M: S^T = K Q^T and dP^T = V dO^T, whose accumulators, as bf16,
//   are the A operands of dV += P^T dO and dK += dS^T Q. Only tiles that
//   cross the diagonal or the column limit are masked; the output is staged
//   in shared memory for 16-byte stores. P and dS are rounded to bf16 inside
//   the products, as FA2 does.
// - fp32 (every kernel): the first design, fp32 products on the CUDA cores.
//   Tiles are 64 x 64 in shared memory, converted to fp32 at load (rows
//   padded by one float so the column-strided reads are free of bank
//   conflicts); 256 threads each own 4 rows x 4 strided columns of a score
//   tile and 4 rows x D/16 strided columns of the output accumulator, kept
//   in registers; row statistics are reduced over the 16 lanes that share a
//   row with shuffles. fp32 keeps it because its products must stay fp32
//   end to end: it is the parity path whose losses are held to 1e-4 of the
//   plain route, and no speed path runs it.
//
// Bound. At GPT-2 124M's training shapes (bh = 384, L = 1024, D = 64, bf16,
// causal) the forward moves ~201 MB and does ~51.5 GFLOP of visible-tile
// matrix work: ~256 flops per byte, at the H100's ~295 bf16 tensor-core
// balance point, so its least time is the larger of the two, ~0.06 ms
// (bytes). dq does 1.5x the forward's matrix work over 1.5x its bytes,
// ~0.09 ms (bytes); dk/dv twice the forward's work over 1.5x its bytes, ~0.10 ms
// (operations). mma.sync reaches part of the tensor cores' rate; wgmma fed
// by TMA is the step after this one (times in PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_mma.cuh"

namespace {

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
// bf16 forward and dk/dv on the tensor cores
// ---------------------------------------------------------------------------
//
// The tile core (fragments, swizzled cp.async tiles, the two tile walks) is
// tc_mma.cuh's, shared with the ring kernels; here are the flash kernels'
// edges: the column limit, and o, lse, dk, dv in their output types.

namespace tc {

template <int D, int WM>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int* __restrict__ vl,
                        bf16* __restrict__ o, float* __restrict__ lse, int L,
                        int limit, int causal, float scale) {
  constexpr int BM = kWarps * WM * 16, BN = kKvCols;
  constexpr int DT = D / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* Ks = Qs + BM * D;       // two slots of BN x D
  bf16* Vs = Ks + 2 * BN * D;   // two slots of BN x D

  const int bh = blockIdx.x;
  // The grid's slow axis walks q tiles last-first: under causal the long
  // rows near the end start first and the short ones fill in behind.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * WM * 16;  // the warp's first row in the tile
  const size_t base = static_cast<size_t>(bh) * L * D;
  const int lim = col_limit(vl, bh, limit, L);
  int end = lim;
  if (causal && q0 + BM < end) end = q0 + BM;
  const int nkv = end > 0 ? (end + BN - 1) / BN : 0;

  load_async<BM, D>(Qs, q + base, q0, L);
  cp_async_commit();
  if (nkv > 0) {
    load_async<BN, D>(Ks, k + base, 0, L);
    load_async<BN, D>(Vs, v + base, 0, L);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // Scores in log2 units: x = s * scale * log2(e), softmax by exp2.
  float acc[WM][DT][4], m[WM][2], l[WM][2];
  fwd_walk<D, WM>(Qs, Ks, Vs, k + base, v + base, L, lim, causal, q0, nkv,
                  scale * kLog2e, acc, m, l);

  // Epilogue: o = acc / max(l, 1e-30) staged in the warp's own Q rows (only
  // this warp read them), then stored 16 bytes a lane; lse in fp32.
#pragma unroll
  for (int s = 0; s < WM; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr + 16 * s + g + 8 * h;
      const float lc = fmaxf(quad_sum(l[s][h]), 1e-30f);
      const float inv = 1.f / lc;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<uint32_t*>(Qs + swz<D>(r, d) + 2 * t) =
            pack(acc[s][d][2 * h] * inv, acc[s][d][2 * h + 1] * inv);
      if (t == 0 && q0 + r < L)
        lse[static_cast<size_t>(bh) * L + q0 + r] = m[s][h] * kLn2 + logf(lc);
    }
  __syncwarp();
  store_rows<WM * 16, D>(o + base, Qs, q0, wr, L, lane);
}

template <int D, int BQ, bool KV_REGS>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ vl, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int L, int limit, int causal,
                        float scale) {
  constexpr int BN = kWarps * 16;
  constexpr int DT = D / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);
  bf16* Vs = Ks + BN * D;

  const int bh = blockIdx.x;
  // Under causal the first kv tiles see the most q tiles: they start first.
  const int k0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const size_t base = static_cast<size_t>(bh) * L * D;
  const size_t rbase = static_cast<size_t>(bh) * L;
  const int lim = col_limit(vl, bh, limit, L);
  const int nq = (L + BQ - 1) / BQ;
  // Under causal, q tiles wholly above this kv tile see none of it; a kv
  // tile at or past the column limit is hidden from every row.
  const int qb0 = causal ? k0 / BQ : 0;
  const int qb1 = k0 < lim ? nq : qb0;

  float dka[DT][4], dva[DT][4];
  dkv_walk<D, BQ, KV_REGS>(Ks, q + base, k + base, v + base, dout + base,
                           lse + rbase, delta + rbase, L, lim, causal, k0,
                           qb0, qb1, scale, dka, dva);

  // Epilogue: dk carries the scale once, in fp32; dk and dv are staged in
  // the warp's own K and V rows (only this warp read them), then stored 16
  // bytes a lane.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr + g + 8 * h;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<uint32_t*>(Ks + swz<D>(r, d) + 2 * t) =
          pack(dka[d][2 * h] * scale, dka[d][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(Vs + swz<D>(r, d) + 2 * t) =
          pack(dva[d][2 * h], dva[d][2 * h + 1]);
    }
  }
  __syncwarp();
  store_rows<16, D>(dk + base, Ks, k0, wr, L, lane);
  store_rows<16, D>(dv + base, Vs, k0, wr, L, lane);
}

template <int D, int WM, bool QO_REGS>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ o,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const int* __restrict__ vl, bf16* __restrict__ dq,
                       float* __restrict__ delta, int L, int limit, int causal,
                       float scale) {
  constexpr int BM = kWarps * WM * 16, BN = kKvCols;
  constexpr int DT = D / 8, kChunks = D / 8;
  static_assert(32 % kChunks == 0, "a row's lanes in one warp");
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* dOs = Qs + BM * D;
  bf16* Ks = dOs + BM * D;      // two slots of BN x D
  bf16* Vs = Ks + 2 * BN * D;   // two slots of BN x D
  float* lse_s = reinterpret_cast<float*>(Vs + 2 * BN * D);
  float* dl_s = lse_s + BM;

  const int bh = blockIdx.x;
  // q tiles last-first, as in the forward: under causal the long rows
  // start first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * WM * 16;
  const size_t base = static_cast<size_t>(bh) * L * D;
  const size_t rbase = static_cast<size_t>(bh) * L;
  const int lim = col_limit(vl, bh, limit, L);
  int end = lim;
  if (causal && q0 + BM < end) end = q0 + BM;
  const int nkv = end > 0 ? (end + BN - 1) / BN : 0;

  load_async<BM, D>(Qs, q + base, q0, L);
  load_async<BM, D>(dOs, dout + base, q0, L);
  load_rows_async<BM>(lse_s, lse + rbase, q0, L);
  cp_async_commit();
  if (nkv > 0) {
    load_async<BN, D>(Ks, k + base, 0, L);
    load_async<BN, D>(Vs, v + base, 0, L);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // delta = rowsum(dO * O) in fp32, for this walk and for flash_dkv: the
  // kChunks lanes of a row each take a 16-byte chunk of dO from the tile
  // and of O from global memory, and shuffles sum the row.
#pragma unroll
  for (int i = 0; i < BM * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    float part = 0.f;
    if (q0 + r < L) {
      const uint4 ov = *reinterpret_cast<const uint4*>(
          o + base + static_cast<size_t>(q0 + r) * D + c * 8);
      const uint4 dv = *reinterpret_cast<const uint4*>(dOs + swz<D>(r, c));
      const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(a[e]), y = __bfloat1622float2(b[e]);
        part = fmaf(x.x, y.x, fmaf(x.y, y.y, part));
      }
    }
#pragma unroll
    for (int off = kChunks / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (c == 0) {
      dl_s[r] = part;
      if (q0 + r < L) delta[rbase + q0 + r] = part;
    }
  }
  __syncthreads();

  float dqa[WM][DT][4];
  dq_walk<D, WM, QO_REGS, false>(Qs, dOs, Ks, Vs, lse_s, dl_s, k + base,
                                 v + base, L, lim, causal, q0, nkv,
                                 scale * kLog2e, dqa);

  // Epilogue: dq = scale acc staged in the warp's own Q rows (only this
  // warp read them), then stored 16 bytes a lane.
#pragma unroll
  for (int s = 0; s < WM; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr + 16 * s + g + 8 * h;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<uint32_t*>(Qs + swz<D>(r, d) + 2 * t) =
            pack(dqa[s][d][2 * h] * scale, dqa[s][d][2 * h + 1] * scale);
    }
  __syncwarp();
  store_rows<WM * 16, D>(dq + base, Qs, q0, wr, L, lane);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
constexpr int tc_fwd_smem() {
  return tc::fwd_smem_bytes<D, tc::Shape<D>::kFwdStrips>();
}
template <int D>
constexpr int tc_dkv_smem() {
  return tc::dkv_smem_bytes<D, tc::Shape<D>::kDkvQ>();
}
template <int D>
constexpr int tc_dq_smem() {
  return tc::dq_smem_bytes<D, tc::Shape<D>::kDqStrips>();
}

constexpr long long larger(long long a, long long b) { return a > b ? a : b; }

// The larger of the fp32 and the bf16 instantiations' needs.
template <int D>
long long smem_bytes(int kernel) {
  switch (kernel) {
    case kFwd: return larger(fwd_smem_floats<D>() * 4LL, tc_fwd_smem<D>());
    case kDq: return larger(dq_smem_floats<D>() * 4LL, tc_dq_smem<D>());
    case kDkv: return larger(dkv_smem_floats<D>() * 4LL, tc_dkv_smem<D>());
    default: return -1;
  }
}

template <int D>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          const void* vl, void* o, void* lse, int bh, int L,
                          int limit, int causal, float scale,
                          cudaStream_t s) {
  using tc::bf16;
  constexpr int WM = tc::Shape<D>::kFwdStrips, BM = tc::kWarps * WM * 16;
  if (!aligned16({q, k, v, o})) return cudaErrorMisalignedAddress;
  const int smem = tc_fwd_smem<D>();
  cudaError_t err = prepare(tc::flash_fwd_kernel_tc<D, WM>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (L + BM - 1) / BM);
  tc::flash_fwd_kernel_tc<D, WM><<<grid, tc::kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(vl),
      static_cast<bf16*>(o), static_cast<float*>(lse), L, limit, causal,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const void* lse,
                         const void* vl, void* dq, void* delta, int bh, int L,
                         int limit, int causal, float scale, cudaStream_t s) {
  using tc::bf16;
  constexpr int WM = tc::Shape<D>::kDqStrips, BM = tc::kWarps * WM * 16;
  constexpr bool kRegs = tc::Shape<D>::kDqRegs;
  if (!aligned16({q, k, v, o, dout, dq})) return cudaErrorMisalignedAddress;
  const int smem = tc_dq_smem<D>();
  cudaError_t err = prepare(tc::flash_dq_kernel_tc<D, WM, kRegs>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (L + BM - 1) / BM);
  tc::flash_dq_kernel_tc<D, WM, kRegs><<<grid, tc::kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const int*>(vl), static_cast<bf16*>(dq),
      static_cast<float*>(delta), L, limit, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta,
                          const void* vl, void* dk, void* dv, int bh, int L,
                          int limit, int causal, float scale,
                          cudaStream_t s) {
  using tc::bf16;
  constexpr int BQ = tc::Shape<D>::kDkvQ;
  constexpr bool kRegs = tc::Shape<D>::kDkvRegs;
  if (!aligned16({q, k, v, dout, dk, dv})) return cudaErrorMisalignedAddress;
  const int smem = tc_dkv_smem<D>();
  cudaError_t err = prepare(tc::flash_dkv_kernel_tc<D, BQ, kRegs>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (L + tc::kWarps * 16 - 1) / (tc::kWarps * 16));
  tc::flash_dkv_kernel_tc<D, BQ, kRegs><<<grid, tc::kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(vl), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), L, limit, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* vl, void* o, void* lse, int bh, int L,
                       int limit, int causal, float scale, cudaStream_t s) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_fwd_tc<D>(q, k, v, vl, o, lse, bh, L, limit, causal, scale,
                            s);
  } else {
    const int smem = fwd_smem_floats<D>() * 4;
    cudaError_t err = prepare(flash_fwd_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(bh, (L + kBlock - 1) / kBlock);
    flash_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(vl),
        static_cast<T*>(o), static_cast<float*>(lse), L, limit, causal,
        scale);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      const void* vl, void* dq, void* delta, int bh, int L,
                      int limit, int causal, float scale, cudaStream_t s) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_dq_tc<D>(q, k, v, o, dout, lse, vl, dq, delta, bh, L, limit,
                           causal, scale, s);
  } else {
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
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* vl, void* dk, void* dv, int bh, int L,
                       int limit, int causal, float scale, cudaStream_t s) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_dkv_tc<D>(q, k, v, dout, lse, delta, vl, dk, dv, bh, L,
                            limit, causal, scale, s);
  } else {
    const int smem = dkv_smem_floats<D>() * 4;
    cudaError_t err = prepare(flash_dkv_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(bh, (L + kBlock - 1) / kBlock);
    flash_dkv_kernel<T, D><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const int*>(vl), static_cast<T*>(dk),
        static_cast<T*>(dv), L, limit, causal, scale);
    return cudaGetLastError();
  }
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
