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
// carries: the grid is (bh, q tiles) for ring_step and ring_dq and (bh,
// 64-row kv tiles) for ring_dkv, and a loop inside the block walks the
// other axis (to the diagonal tile in mode 1). The mode is a runtime
// argument: which block visits is known at run time. Two designs:
// - bf16 ring_step, ring_dq and ring_dkv (namespace tc): the flash
//   kernels' tensor-core tile walks of tc_mma.cuh (mma.sync.m16n8k16 bf16
//   -> fp32 fed by 16-byte cp.async into a two-slot swizzled ring,
//   S/P/dP/dS in registers, P and dS rounded to bf16 inside the next
//   product in ring_dkv; ring_step keeps P, and qf at D = 128, as two bf16
//   terms, so its unnormalised acc carry takes no bf16 rounding, and
//   ring_dq keeps dS as two bf16 terms inside dS K, so its dq carry holds
//   the fp32 design's tolerance). The walk starts from an empty state and
//   is merged into the fp32 carries once, in the epilogue, so no carry
//   occupies registers across the loop.
// - fp32 (every kernel): fp32 products on the CUDA cores. Tiles are
//   64 x 64 in fp32 shared memory (rows padded by one float against bank
//   conflicts); 256 threads each own 4 rows x 4 strided columns of a score
//   tile and 4 rows x D/16 strided columns of the accumulator, in
//   registers, seeded from the carries; row statistics are reduced over the
//   16 lanes that share a row. fp32 keeps it because the cp parity gate
//   (losses within 1e-4 of one GPU's) needs fp32 products.
//
// Bound. At the cp=2 training shapes of GPT-2 124M (bh = 384, L = 512,
// D = 64, bf16 k/v, fp32 carries) a mode-0 ring_step moves ~203 MB (qf and
// acc in/out fp32, k and v bf16): ~0.06 ms at 3.35 TB/s, above its ~25.8
// GFLOP over the bf16 tensor cores (~0.026 ms); the backward kernels move
// 201 MB (dq) and 302 MB (dk/dv), so all three are bound by bytes. Their
// times against that bound are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "tc_mma.cuh"

namespace {

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
// bf16 ring_step, ring_dq and ring_dkv on the tensor cores
// ---------------------------------------------------------------------------
//
// The flash kernels' tile walks (tc_mma.cuh) with the ring's edges: every
// column < L is visible in mode 0, col <= row in mode 1 (the walks'
// lim = L, causal = mode), and fp32 carries in and out.

namespace tc {

// ring_step's tiles at head dim D: flash_fwd's strips. qf is the path's
// bf16 q times D^-1/2, which at D = 64 is 2^-3, so one bf16 tile holds it
// exactly; at D = 128 the scale is no power of two and qf goes in as two
// bf16 tiles (fwd_walk's SPLIT_Q). At D = 64 the second term of P takes
// the registers that Q's fragments held in flash_fwd (with them, 255
// registers and a spill), so Q is read from shared memory at each use.
template <int D>
struct StepShape {
  static constexpr int kStrips = Shape<D>::kFwdStrips;
  static constexpr bool kQRegs = D != 64;
  static constexpr bool kSplitQ = D != 64;
};

template <int D>
constexpr int step_tc_smem_bytes() {
  constexpr int WM = StepShape<D>::kStrips;
  return fwd_smem_bytes<D, WM>() +
         (StepShape<D>::kSplitQ ? kWarps * WM * 16 * D * 2 : 0);
}

// Rows [r0, r0 + ROWS) of fp32 src [L, D] into a swizzled bf16 tile, 16
// bytes of bf16 (two float4 loads) a thread per chunk, and with SPLIT what
// the rounding left into a second tile at dst + ROWS * D; rows past L zero.
template <int ROWS, int D, bool SPLIT>
__device__ __forceinline__ void load_f32_as_bf16(bf16* dst, const float* src,
                                                 int r0, int L) {
  constexpr int kChunks = D / 8;
  static_assert(ROWS * kChunks % kThreads == 0, "tile / threads");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    uint4 hi = make_uint4(0u, 0u, 0u, 0u), lo = hi;
    if (r0 + r < L) {
      const float4* s = reinterpret_cast<const float4*>(
          src + static_cast<size_t>(r0 + r) * D + c * 8);
      const float4 a = s[0], b = s[1];
      hi = make_uint4(pack(a.x, a.y), pack(a.z, a.w), pack(b.x, b.y),
                      pack(b.z, b.w));
      if constexpr (SPLIT)
        lo = make_uint4(pack_rest(a.x, a.y, hi.x), pack_rest(a.z, a.w, hi.y),
                        pack_rest(b.x, b.y, hi.z), pack_rest(b.z, b.w, hi.w));
    }
    *reinterpret_cast<uint4*>(dst + swz<D>(r, c)) = hi;
    if constexpr (SPLIT)
      *reinterpret_cast<uint4*>(dst + ROWS * D + swz<D>(r, c)) = lo;
  }
}

// ring_step: the block's q rows run flash_fwd's walk over the visiting
// block from an empty state (m = -inf, l = 0, acc = 0), and the result
// (m_b, l_b, acc_b) is merged into the carries once, at the end:
//   m' = max(m, m_b), a = e^(m - m'), b = e^(m_b - m'),
//   l' = l a + l_b b, acc' = acc a + acc_b b,
// which is the Pallas kernel's fold up to fp32 rounding; no carry is held
// in registers across the walk and acc is read once. Scores are in log2
// units inside (x = qf k^T log2 e), so m crosses the boundary as m log2 e
// in and m' ln 2 out; the first visit's m = -1e30 gives a = 0 (finite, no
// NaN). Unlike flash_fwd, the walk rounds neither P nor Q to bf16: acc is
// not normalised, it grows with l, and a bf16 P inside P V would leave it
// ~0.4% of a row's scale off (1.7x a 2e-2 + 2e-2 |acc| tolerance at the
// cp=2 training shape, by emulation); so P V takes P as two bf16 terms
// (SPLIT_P), and qf comes in as one bf16 tile, exact at D = 64 for the
// path's qf, or as two (StepShape). A qf of other values is rounded to
// bf16 at D = 64.
template <int D, int WM>
__global__ void __launch_bounds__(kThreads)
    ring_step_kernel_tc(const float* __restrict__ qf,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ m_in,
                        const float* __restrict__ l_in,
                        const float* __restrict__ acc_in,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        float* __restrict__ acc_out, int L, int mode) {
  constexpr int BM = kWarps * WM * 16, BN = kKvCols;
  constexpr int DT = D / 8;
  constexpr bool kSplitQ = StepShape<D>::kSplitQ;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);  // (with kSplitQ two) BM x D
  bf16* Ks = Qs + (kSplitQ ? 2 : 1) * BM * D;  // two slots of BN x D
  bf16* Vs = Ks + 2 * BN * D;                   // two slots of BN x D

  const int bh = blockIdx.x;
  // q tiles last-first: in mode 1 the long rows start first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * WM * 16;
  const size_t base = static_cast<size_t>(bh) * L * D;
  const size_t rbase = static_cast<size_t>(bh) * L;
  int end = L;
  if (mode && q0 + BM < end) end = q0 + BM;
  const int nkv = (end + BN - 1) / BN;  // >= 1: column 0 is always visible

  load_async<BN, D>(Ks, k + base, 0, L);
  load_async<BN, D>(Vs, v + base, 0, L);
  cp_async_commit();
  load_f32_as_bf16<BM, D, kSplitQ>(Qs, qf + base, q0, L);  // as tile 0 lands
  __syncthreads();

  float acc[WM][DT][4], m[WM][2], l[WM][2];
  fwd_walk<D, WM, StepShape<D>::kQRegs, kSplitQ, true>(
      Qs, Ks, Vs, k + base, v + base, L, L, mode, q0, nkv, kLog2e, acc, m, l);

  // Epilogue: the merge, fp32 straight from the accumulator layout (a
  // quad's lanes write 32 contiguous bytes of a row per store); rows past L
  // are never written, their neighbours' carries sit there.
#pragma unroll
  for (int s = 0; s < WM; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + wr + 16 * s + g + 8 * h;
      const float lb = quad_sum(l[s][h]);  // every lane takes part
      if (row >= L) continue;
      const float mc = m_in[rbase + row] * kLog2e;
      const float mn = fmaxf(mc, m[s][h]);
      const float a = fast_exp2(mc - mn), b = fast_exp2(m[s][h] - mn);
      const size_t at = base + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const float2 x = *reinterpret_cast<const float2*>(acc_in + at + 8 * d);
        *reinterpret_cast<float2*>(acc_out + at + 8 * d) =
            make_float2(x.x * a + acc[s][d][2 * h] * b,
                        x.y * a + acc[s][d][2 * h + 1] * b);
      }
      if (t == 0) {
        m_out[rbase + row] = mn * kLn2;
        l_out[rbase + row] = l_in[rbase + row] * a + lb * b;
      }
    }
}

// ring_dq: the block's q rows run flash_dq's walk over the visiting block
// (through the diagonal tile in mode 1), with lse and delta read in, then
// add to the carry once: dq' = dq + scale sum dS K, fp32 straight from the
// accumulator layout, rows past L never written. dS enters dS K as two
// bf16 terms (SPLIT_DS): on the diagonal block one term leaves dq outside
// the fp32 design's 2e-3 + 2e-3 |ref|, two use under a tenth of it (the
// emulation in tests/test_torch_ring_attention.py).
template <int D, int WM, bool QO_REGS>
__global__ void __launch_bounds__(kThreads)
    ring_dq_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ dq_in,
                      float* __restrict__ dq_out, int L, int mode,
                      float scale) {
  constexpr int BM = kWarps * WM * 16, BN = kKvCols;
  constexpr int DT = D / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* dOs = Qs + BM * D;
  bf16* Ks = dOs + BM * D;      // two slots of BN x D
  bf16* Vs = Ks + 2 * BN * D;   // two slots of BN x D
  float* lse_s = reinterpret_cast<float*>(Vs + 2 * BN * D);
  float* dl_s = lse_s + BM;

  const int bh = blockIdx.x;
  // q tiles last-first: in mode 1 the long rows start first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = static_cast<size_t>(bh) * L * D;
  const size_t rbase = static_cast<size_t>(bh) * L;
  int end = L;
  if (mode && q0 + BM < end) end = q0 + BM;
  const int nkv = (end + BN - 1) / BN;  // >= 1: column 0 is always visible

  load_async<BM, D>(Qs, q + base, q0, L);
  load_async<BM, D>(dOs, dout + base, q0, L);
  load_rows_async<BM>(lse_s, lse + rbase, q0, L);
  load_rows_async<BM>(dl_s, delta + rbase, q0, L);
  cp_async_commit();
  load_async<BN, D>(Ks, k + base, 0, L);
  load_async<BN, D>(Vs, v + base, 0, L);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  float dqa[WM][DT][4];
  dq_walk<D, WM, QO_REGS, true>(Qs, dOs, Ks, Vs, lse_s, dl_s, k + base,
                                v + base, L, L, mode, q0, nkv,
                                scale * kLog2e, dqa);

#pragma unroll
  for (int s = 0; s < WM; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + warp * WM * 16 + 16 * s + g + 8 * h;
      if (row >= L) continue;
      const size_t at = base + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const float2 x = *reinterpret_cast<const float2*>(dq_in + at + 8 * d);
        *reinterpret_cast<float2*>(dq_out + at + 8 * d) =
            make_float2(x.x + scale * dqa[s][d][2 * h],
                        x.y + scale * dqa[s][d][2 * h + 1]);
      }
    }
}

// ring_dkv: the block's 64 kv rows run flash_dkv's walk over this rank's
// q tiles (from the diagonal tile in mode 1), then add to the carries once:
// dk' = dk + scale sum dS^T Q, dv' = dv + sum P^T dO, fp32 straight from
// the accumulator layout, rows past L never written. lse comes in natural
// log units and goes to log2 inside the walk, as in flash_dkv; P and dS
// are rounded to bf16 inside the products.
template <int D, int BQ, bool KV_REGS>
__global__ void __launch_bounds__(kThreads)
    ring_dkv_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const float* __restrict__ dk_in,
                       const float* __restrict__ dv_in,
                       float* __restrict__ dk_out, float* __restrict__ dv_out,
                       int L, int mode, float scale) {
  constexpr int BN = kWarps * 16;
  constexpr int DT = D / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = static_cast<size_t>(bh) * L * D;
  const size_t rbase = static_cast<size_t>(bh) * L;
  const int nq = (L + BQ - 1) / BQ;

  float dka[DT][4], dva[DT][4];
  dkv_walk<D, BQ, KV_REGS>(Ks, q + base, k + base, v + base, dout + base,
                           lse + rbase, delta + rbase, L, L, mode, k0,
                           mode ? k0 / BQ : 0, nq, scale, dka, dva);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + warp * 16 + g + 8 * h;
    if (row >= L) continue;
    const size_t at = base + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const float2 x = *reinterpret_cast<const float2*>(dk_in + at + 8 * d);
      const float2 y = *reinterpret_cast<const float2*>(dv_in + at + 8 * d);
      *reinterpret_cast<float2*>(dk_out + at + 8 * d) =
          make_float2(x.x + scale * dka[d][2 * h],
                      x.y + scale * dka[d][2 * h + 1]);
      *reinterpret_cast<float2*>(dv_out + at + 8 * d) =
          make_float2(y.x + dva[d][2 * h], y.y + dva[d][2 * h + 1]);
    }
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
constexpr int tc_dkv_smem() {
  return tc::dkv_smem_bytes<D, tc::Shape<D>::kDkvQ>();
}
template <int D>
constexpr int tc_dq_smem() {
  return tc::dq_smem_bytes<D, tc::Shape<D>::kDqStrips>();
}

// The larger of the fp32 and the bf16 instantiations' needs.
template <int D>
long long smem_bytes(int kernel) {
  switch (kernel) {
    case kStep:
      return std::max(step_smem_floats<D>() * 4, tc::step_tc_smem_bytes<D>());
    case kDq: return std::max(dq_smem_floats<D>() * 4, tc_dq_smem<D>());
    case kDkv: return std::max(dkv_smem_floats<D>() * 4, tc_dkv_smem<D>());
    default: return -1;
  }
}

template <int D>
cudaError_t launch_step_tc(const void* qf, const void* k, const void* v,
                           const void* m_in, const void* l_in,
                           const void* acc_in, void* m_out, void* l_out,
                           void* acc_out, int bh, int L, int mode,
                           cudaStream_t s) {
  using tc::bf16;
  constexpr int WM = tc::StepShape<D>::kStrips, BM = tc::kWarps * WM * 16;
  if (!aligned16({qf, k, v, acc_in, acc_out}))
    return cudaErrorMisalignedAddress;
  const int smem = tc::step_tc_smem_bytes<D>();
  cudaError_t err = prepare(tc::ring_step_kernel_tc<D, WM>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (L + BM - 1) / BM);
  tc::ring_step_kernel_tc<D, WM><<<grid, tc::kThreads, smem, s>>>(
      static_cast<const float*>(qf), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(m_in),
      static_cast<const float*>(l_in), static_cast<const float*>(acc_in),
      static_cast<float*>(m_out), static_cast<float*>(l_out),
      static_cast<float*>(acc_out), L, mode);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_step(const void* qf, const void* k, const void* v,
                        const void* m_in, const void* l_in, const void* acc_in,
                        void* m_out, void* l_out, void* acc_out, int bh, int L,
                        int mode, cudaStream_t s) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_step_tc<D>(qf, k, v, m_in, l_in, acc_in, m_out, l_out,
                             acc_out, bh, L, mode, s);
  } else {
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
}

template <int D>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         const void* dq_in, void* dq_out, int bh, int L,
                         int mode, float scale, cudaStream_t s) {
  using tc::bf16;
  constexpr int WM = tc::Shape<D>::kDqStrips, BM = tc::kWarps * WM * 16;
  constexpr bool kRegs = tc::Shape<D>::kRingDqRegs;
  if (!aligned16({q, k, v, dout, dq_in, dq_out}))
    return cudaErrorMisalignedAddress;
  const int smem = tc_dq_smem<D>();
  cudaError_t err = prepare(tc::ring_dq_kernel_tc<D, WM, kRegs>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (L + BM - 1) / BM);
  tc::ring_dq_kernel_tc<D, WM, kRegs><<<grid, tc::kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(dq_in), static_cast<float*>(dq_out), L, mode,
      scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* dq_in, void* dq_out, int bh, int L, int mode,
                      float scale, cudaStream_t s) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_dq_tc<D>(q, k, v, dout, lse, delta, dq_in, dq_out, bh, L,
                           mode, scale, s);
  } else {
    const int smem = dq_smem_floats<D>() * 4;
    cudaError_t err = prepare(ring_dq_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(bh, (L + kBlock - 1) / kBlock);
    ring_dq_kernel<T, D><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const float*>(dq_in), static_cast<float*>(dq_out), L,
        mode, scale);
    return cudaGetLastError();
  }
}

template <int D>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta,
                          const void* dk_in, const void* dv_in, void* dk_out,
                          void* dv_out, int bh, int L, int mode, float scale,
                          cudaStream_t s) {
  using tc::bf16;
  constexpr int BQ = tc::Shape<D>::kDkvQ;
  constexpr bool kRegs = tc::Shape<D>::kDkvRegs;
  if (!aligned16({q, k, v, dout, dk_in, dv_in, dk_out, dv_out}))
    return cudaErrorMisalignedAddress;
  const int smem = tc_dkv_smem<D>();
  cudaError_t err = prepare(tc::ring_dkv_kernel_tc<D, BQ, kRegs>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (L + tc::kWarps * 16 - 1) / (tc::kWarps * 16));
  tc::ring_dkv_kernel_tc<D, BQ, kRegs><<<grid, tc::kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(dk_in), static_cast<const float*>(dv_in),
      static_cast<float*>(dk_out), static_cast<float*>(dv_out), L, mode,
      scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* dk_in, const void* dv_in, void* dk_out,
                       void* dv_out, int bh, int L, int mode, float scale,
                       cudaStream_t s) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_dkv_tc<D>(q, k, v, dout, lse, delta, dk_in, dv_in, dk_out,
                            dv_out, bh, L, mode, scale, s);
  } else {
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
}

// Dispatch on (dtype, head_dim): f(T, D) instantiations for float and bf16
// at D = 64 and 128 (bf16 on the tensor cores, fp32 on the CUDA cores);
// anything else is refused.
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
