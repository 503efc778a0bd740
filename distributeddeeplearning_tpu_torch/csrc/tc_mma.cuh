// The tensor-core tile core for Hopper (sm_90a), shared by the bf16
// attention kernels of flash_attention.cu and ring_attention.cu: the
// mma.sync fragment helpers, the cp.async loads into XOR-swizzled shared
// tiles, the tile shapes, and the three tile walks those kernels are built
// on.
//
// - fwd_walk: a block of q rows walks 64-column kv tiles through a two-slot
//   cp.async ring and folds each into its online-softmax state (acc, m, l)
//   in log2 units. flash_fwd normalises that state at the end;
//   ring_step merges it into the ring's carries.
// - dkv_walk: a block of 64 kv rows walks q tiles through a two-slot ring
//   of Q, dO, lse and delta and accumulates P^T dO and dS^T Q. flash_dkv
//   writes them as bf16; ring_dkv adds them to the rotating fp32 carries.
// - dq_walk: a block of q rows, holding its Q, dO, lse and delta, walks
//   kv tiles through fwd_walk's ring and accumulates dS K. flash_dq writes
//   it as bf16; ring_dq adds it to the fp32 dq carry.
//
// Each kernel library is one translation unit, and this header's code sits
// in that unit's anonymous namespace, as if it were written in the source:
// include it once, before the source's own anonymous namespace. Beside the
// device code are the two launch helpers both sources use.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr float kNegInf = -1e30f;  // finite: exp(kNegInf - m) == 0, no NaN

// The bf16 kernels move 16-byte chunks: every [bh, L, D] operand must start
// on a 16-byte boundary (a misaligned one is refused, not launched).
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

template <typename Fn>
cudaError_t prepare(Fn fn, int smem_bytes) {
  // Above 48 KB a block's dynamic shared memory needs an opt-in, once per
  // kernel instantiation.
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

// mma.sync.m16n8k16 (bf16 in, fp32 accumulate). Per lane, g = lane / 4 and
// t = lane % 4: an A fragment (16 x 16) holds rows g and g + 8 at columns
// 2t, 2t + 1 and 2t + 8, 2t + 9; a B fragment (16 x 8) rows 2t, 2t + 1 and
// 2t + 8, 2t + 9 of column g; the accumulator (16 x 8) rows g and g + 8 at
// columns 2t, 2t + 1. Two neighbouring accumulator tiles are thus one A
// fragment over their 16 columns once packed to bf16, which is how P (and
// dS) feed the next product without leaving registers. Shared tiles are
// bf16 [rows, D] with each 16-byte chunk c of row r stored at chunk
// c ^ (r % 8), so the 8 rows an ldmatrix reads at one logical chunk fall
// in 8 distinct bank groups.

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKvCols = 64;  // forward: kv columns per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of logical 16-byte chunk `c` of row `r` in a swizzled tile.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

// 16 bytes global -> shared; zero-filled (nothing read) when !ok.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a b over one 16 x 8 x 16 tile.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// What bf16 rounding left of (lo, hi), given their packed rounding: the
// second term of a two-term bf16 split, x = bf16(x) + bf16(x - bf16(x))
// to ~2^-16 of x.
__device__ __forceinline__ uint32_t pack_rest(float lo, float hi,
                                              uint32_t packed) {
  const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(&packed);
  return pack(lo - __low2float(r), hi - __high2float(r));
}

// Accumulator tiles 2kk and 2kk + 1 of x as the A fragment of k-chunk kk.
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&x0)[4],
                                     const float (&x1)[4]) {
  a[0] = pack(x0[0], x0[1]);
  a[1] = pack(x0[2], x0[3]);
  a[2] = pack(x1[0], x1[1]);
  a[3] = pack(x1[2], x1[3]);
}
// The second terms of the split whose first terms to_a gave in a.
__device__ __forceinline__ void to_a_rest(uint32_t (&r)[4],
                                          const float (&x0)[4],
                                          const float (&x1)[4],
                                          const uint32_t (&a)[4]) {
  r[0] = pack_rest(x0[0], x0[1], a[0]);
  r[1] = pack_rest(x0[2], x0[3], a[1]);
  r[2] = pack_rest(x1[0], x1[1], a[2]);
  r[3] = pack_rest(x1[2], x1[3], a[3]);
}

// ldmatrix lane addresses. A operand (16 rows x 16, k-chunk kk) from a
// row-major tile; B operand of two n-tiles (rows n0..n0+15 as columns) from
// a tile whose rows are the n index (non-transposed); B operand of two
// n-tiles (columns c..c+15 at k rows k0..k0+15) from a tile whose rows are
// the k index (transposed).
template <int D>
__device__ __forceinline__ uint32_t a_addr(const bf16* s, int r0, int kk,
                                           int lane) {
  return saddr(s + swz<D>(r0 + (lane & 15), 2 * kk + (lane >> 4)));
}
template <int D>
__device__ __forceinline__ uint32_t bn_addr(const bf16* s, int n0, int kk,
                                            int lane) {
  return saddr(s + swz<D>(n0 + (lane & 7) + ((lane >> 4) << 3),
                          2 * kk + ((lane >> 3) & 1)));
}
template <int D>
__device__ __forceinline__ uint32_t bk_addr(const bf16* s, int k0, int cp,
                                            int lane) {
  return saddr(s + swz<D>(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                          2 * cp + (lane >> 4)));
}

// Rows [r0, r0 + ROWS) of src [L, D] into a swizzled tile, asynchronously;
// rows past L zero-filled.
template <int ROWS, int D>
__device__ __forceinline__ void load_async(bf16* dst, const bf16* src, int r0,
                                           int L) {
  constexpr int kChunks = D / 8;
  static_assert(ROWS * kChunks % kThreads == 0, "tile / threads");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const int row = r0 + r;
    const bool ok = row < L;
    cp_async16(saddr(dst + swz<D>(r, c)),
               src + static_cast<size_t>(ok ? row : 0) * D + c * 8, ok);
  }
}

// rows [r0, r0 + N) of a [L] fp32 row vector; past L zero.
template <int N>
__device__ __forceinline__ void load_rows_async(float* dst, const float* src,
                                                int r0, int L) {
  for (int r = threadIdx.x; r < N; r += kThreads) {
    const bool ok = r0 + r < L;
    cp_async4(saddr(dst + r), src + (ok ? r0 + r : 0), ok);
  }
}

// The warp's rows of a staged tile to global rows [r0 + w0, ...), 16 bytes
// a store, rows past L skipped.
template <int ROWS, int D>
__device__ __forceinline__ void store_rows(bf16* dst, const bf16* st, int r0,
                                           int w0, int L, int lane) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = lane; i < ROWS * kChunks; i += 32) {
    const int r = w0 + i / kChunks, c = i % kChunks;
    if (r0 + r < L)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r0 + r) * D +
                                c * 8) =
          *reinterpret_cast<const uint4*>(st + swz<D>(r, c));
  }
}

// 2^x by the SFU's ex2.approx (2 ulp; results below 2^-126 flush to 0,
// and the hidden scores' -1e30 gives 0). exp2f adds range handling around
// the same instruction, ~5% of these kernels' time.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Tile shapes of the bf16 instantiations: the forward's q strips per warp
// (128 rows a block at D = 64, 64 at D = 128, where 128 would spill),
// dk/dv's q tile and whether K and V stay in registers, and dq's q strips
// per warp (two spill) and whether Q and dO stay in registers: in flash_dq
// they do; in ring_dq, whose second dS term needs more registers, they are
// read from shared memory, which keeps it at 168 registers and 3 blocks an
// SM at D = 64 (tools/torch_flash_tiles.py has the variants' times).
template <int D>
struct Shape {
  static constexpr int kFwdStrips = D == 64 ? 2 : 1;
  static constexpr int kDkvQ = D == 64 ? 64 : 32;
  static constexpr bool kDkvRegs = D == 64;
  static constexpr int kDqStrips = 1;
  static constexpr bool kDqRegs = true;
  static constexpr bool kRingDqRegs = false;
};

// ---------------------------------------------------------------------------
// the forward's walk
// ---------------------------------------------------------------------------

// Forward: a block owns BM = 4 warps x WM strips x 16 q rows; the warps
// walk 64-column kv tiles through a two-slot cp.async ring.
template <int D, int WM>
constexpr int fwd_smem_bytes() {
  return (kWarps * WM * 16 * D + 2 * 2 * kKvCols * D) * 2;
}

// The block's q rows [q0, q0 + BM) in the swizzled tile Qs walk kv tiles
// 0 .. nkv - 1 of k, v [L, D] (this row's), through the two slots at Ks and
// Vs; tile 0 must already be committed into slot 0, and Qs visible to every
// warp. Column c is visible to row r when c < lim and, under causal,
// c <= r. On return each warp holds its strips' online-softmax state in
// log2 units (scores x = s * sl2): acc = sum 2^(x - m) v, m the running max
// and l this lane's part of the row sum (quad_sum gives the row's).
// Q_REGS holds Q's fragments in registers across the walk; without it they
// are read from shared memory at each use. Two options trade products for
// rounding (the flash kernels take neither): SPLIT_Q adds S += Qlo K^T for
// a second Q tile Qlo (the bf16 rest of an fp32 Q, at Qs + BM * D), and
// SPLIT_P feeds P V with P split in two bf16 terms, so that neither Q nor P
// is rounded to bf16 (~2^-16 of each left).
template <int D, int WM, bool Q_REGS = true, bool SPLIT_Q = false,
          bool SPLIT_P = false>
__device__ __forceinline__ void fwd_walk(const bf16* Qs, bf16* Ks, bf16* Vs,
                                         const bf16* k, const bf16* v, int L,
                                         int lim, int causal, int q0, int nkv,
                                         float sl2, float (&acc)[WM][D / 8][4],
                                         float (&m)[WM][2],
                                         float (&l)[WM][2]) {
  constexpr int BN = kKvCols;
  constexpr int KC = D / 16, NT = BN / 8, DT = D / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * WM * 16;  // the warp's first row in the tile

  uint32_t qa[WM][KC][4];
  if constexpr (Q_REGS) {
#pragma unroll
    for (int s = 0; s < WM; ++s)
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
        ldsm4(qa[s][kk], a_addr<D>(Qs, wr + 16 * s, kk, lane));
  }

#pragma unroll
  for (int s = 0; s < WM; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[s][h] = kNegInf;
      l[s][h] = 0.f;  // this lane's part of the row sum
    }
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][d][e] = 0.f;
  }

  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * BN;
    const bf16* Kb = Ks + (j & 1) * BN * D;
    const bf16* Vb = Vs + (j & 1) * BN * D;
    if (j + 1 < nkv) {
      load_async<BN, D>(Ks + ((j + 1) & 1) * BN * D, k, k0 + BN, L);
      load_async<BN, D>(Vs + ((j + 1) & 1) * BN * D, v, k0 + BN, L);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed
    __syncthreads();

    // A warp whose rows all lie above the tile's first column sees none of
    // it (causal); it skips the tile.
    if (!causal || k0 <= q0 + wr + WM * 16 - 1) {
      float sc[WM][NT][4];
#pragma unroll
      for (int s = 0; s < WM; ++s)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[s][n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        // Q's fragments without Q_REGS, and Qlo's always (beside Q's in
        // registers they would not fit), from shared memory.
        uint32_t qs[WM][4], ql[WM][4];
#pragma unroll
        for (int s = 0; s < WM; ++s) {
          if constexpr (!Q_REGS)
            ldsm4(qs[s], a_addr<D>(Qs, wr + 16 * s, kk, lane));
          if constexpr (SPLIT_Q)
            ldsm4(ql[s], a_addr<D>(Qs + kWarps * WM * 16 * D, wr + 16 * s,
                                   kk, lane));
        }
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t b[4];
          ldsm4(b, bn_addr<D>(Kb, 16 * p, kk, lane));
#pragma unroll
          for (int s = 0; s < WM; ++s) {
            const uint32_t(&qf)[4] = Q_REGS ? qa[s][kk] : qs[s];
            mma(sc[s][2 * p], qf, b[0], b[1]);
            mma(sc[s][2 * p + 1], qf, b[2], b[3]);
            if constexpr (SPLIT_Q) {
              mma(sc[s][2 * p], ql[s], b[0], b[1]);
              mma(sc[s][2 * p + 1], ql[s], b[2], b[3]);
            }
          }
        }
      }

      // Only tiles that cross the column limit or the warp's diagonal mask.
      const bool masked =
          k0 + BN > lim || (causal && k0 + BN - 1 > q0 + wr);
#pragma unroll
      for (int s = 0; s < WM; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = q0 + wr + 16 * s + g + 8 * h;
          float mx = kNegInf;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float x = sc[s][n][2 * h + e] * sl2;
              if (masked) {
                const int col = k0 + 8 * n + 2 * t + e;
                if (!(col < lim && (!causal || col <= row))) x = kNegInf;
              }
              sc[s][n][2 * h + e] = x;
              mx = fmaxf(mx, x);
            }
          const float m_new = fmaxf(m[s][h], quad_max(mx));
          const float alpha = fast_exp2(m[s][h] - m_new);
          float rs = 0.f;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = fast_exp2(sc[s][n][2 * h + e] - m_new);
              sc[s][n][2 * h + e] = p;
              rs += p;
            }
          l[s][h] = l[s][h] * alpha + rs;
          m[s][h] = m_new;
#pragma unroll
          for (int d = 0; d < DT; ++d) {
            acc[s][d][2 * h] *= alpha;
            acc[s][d][2 * h + 1] *= alpha;
          }
        }

      // O += P V, P straight from the accumulators as bf16 A fragments.
      if constexpr (SPLIT_P) {
        // Strip by strip: the two terms of one strip's P take the registers
        // that one term of every strip takes below, and each V fragment
        // read still feeds four products.
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int s = 0; s < WM; ++s) {
            uint32_t pa[4], pr[4];
            to_a(pa, sc[s][2 * kk], sc[s][2 * kk + 1]);
            to_a_rest(pr, sc[s][2 * kk], sc[s][2 * kk + 1], pa);
#pragma unroll
            for (int cp = 0; cp < DT / 2; ++cp) {
              uint32_t b[4];
              ldsm4_t(b, bk_addr<D>(Vb, 16 * kk, cp, lane));
              mma(acc[s][2 * cp], pa, b[0], b[1]);
              mma(acc[s][2 * cp + 1], pa, b[2], b[3]);
              mma(acc[s][2 * cp], pr, b[0], b[1]);
              mma(acc[s][2 * cp + 1], pr, b[2], b[3]);
            }
          }
      } else {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          uint32_t pa[WM][4];
#pragma unroll
          for (int s = 0; s < WM; ++s)
            to_a(pa[s], sc[s][2 * kk], sc[s][2 * kk + 1]);
#pragma unroll
          for (int cp = 0; cp < DT / 2; ++cp) {
            uint32_t b[4];
            ldsm4_t(b, bk_addr<D>(Vb, 16 * kk, cp, lane));
#pragma unroll
            for (int s = 0; s < WM; ++s) {
              mma(acc[s][2 * cp], pa[s], b[0], b[1]);
              mma(acc[s][2 * cp + 1], pa[s], b[2], b[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // slot j & 1 is free for tile j + 2
  }
}

// ---------------------------------------------------------------------------
// the dk/dv walk
// ---------------------------------------------------------------------------

// dk/dv: a block owns 64 kv rows (16 a warp) and walks q tiles of BQ rows
// from the diagonal (causal) to the end through a two-slot cp.async ring of
// Q, dO, lse and delta. With kv rows as the MMA's M, P^T and dS^T come out
// as accumulators that are the A fragments of dV += P^T dO and
// dK += dS^T Q. KV_REGS keeps the warp's K and V fragments in registers
// across the loop (D = 64); at D = 128 they are read from shared memory at
// each use, to stay clear of spills.
template <int D, int BQ>
constexpr int dkv_smem_bytes() {
  return (2 * kWarps * 16 * D + 2 * 2 * BQ * D) * 2 + 2 * 2 * BQ * 4;
}

// The block's kv rows [k0, k0 + 64) of k, v [L, D] (this row's) walk q
// tiles qb0 .. qb1 - 1 of q, dout [L, D] and lse, delta [L] (natural-log
// lse). Shared memory from Ks on: K and V (64 x D each), then the ring's
// two slots of Q and dO, then of lse and delta. Column c is visible to row
// r when c < lim and, under causal, c <= r. On return dka = sum dS^T Q
// (without the scale) and dva = sum P^T dO over the warp's 16 kv rows; the
// warp's own rows of Ks and Vs are free for staging.
template <int D, int BQ, bool KV_REGS>
__device__ __forceinline__ void dkv_walk(
    bf16* Ks, const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
    const float* lse, const float* delta, int L, int lim, int causal, int k0,
    int qb0, int qb1, float scale, float (&dka)[D / 8][4],
    float (&dva)[D / 8][4]) {
  constexpr int BN = kWarps * 16;
  constexpr int KC = D / 16, NT = BQ / 8, DT = D / 8;
  bf16* Vs = Ks + BN * D;
  bf16* Qs = Vs + BN * D;        // two slots of BQ x D
  bf16* dOs = Qs + 2 * BQ * D;   // two slots of BQ x D
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * D);  // 2 x BQ
  float* dl_s = lse_s + 2 * BQ;                               // 2 x BQ
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;

  auto load_q = [&](int qb, int slot) {
    load_async<BQ, D>(Qs + slot * BQ * D, q, qb * BQ, L);
    load_async<BQ, D>(dOs + slot * BQ * D, dout, qb * BQ, L);
    load_rows_async<BQ>(lse_s + slot * BQ, lse, qb * BQ, L);
    load_rows_async<BQ>(dl_s + slot * BQ, delta, qb * BQ, L);
  };

  load_async<BN, D>(Ks, k, k0, L);
  load_async<BN, D>(Vs, v, k0, L);
  cp_async_commit();
  if (qb0 < qb1) load_q(qb0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  uint32_t ka[KV_REGS ? KC : 1][4], va[KV_REGS ? KC : 1][4];
  if constexpr (KV_REGS) {
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      ldsm4(ka[kk], a_addr<D>(Ks, wr, kk, lane));
      ldsm4(va[kk], a_addr<D>(Vs, wr, kk, lane));
    }
  }

  const float sl2 = scale * kLog2e;
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;

  for (int qb = qb0; qb < qb1; ++qb) {
    const int q0 = qb * BQ, slot = (qb - qb0) & 1;
    const bf16* Qb = Qs + slot * BQ * D;
    const bf16* dOb = dOs + slot * BQ * D;
    const float* lse_b = lse_s + slot * BQ;
    const float* dl_b = dl_s + slot * BQ;
    if (qb + 1 < qb1) load_q(qb + 1, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile qb has landed
    __syncthreads();

    // Causal: a tile whose rows all lie above the warp's first kv row sees
    // none of its columns.
    if (!causal || q0 + BQ - 1 >= k0 + wr) {
      // S^T = K Q^T and dP^T = V dO^T, kv rows as M, q rows as N.
      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        uint32_t kf[4], vf[4];
        if constexpr (KV_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            kf[e] = ka[kk][e];
            vf[e] = va[kk][e];
          }
        } else {
          ldsm4(kf, a_addr<D>(Ks, wr, kk, lane));
          ldsm4(vf, a_addr<D>(Vs, wr, kk, lane));
        }
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t b[4];
          ldsm4(b, bn_addr<D>(Qb, 16 * p, kk, lane));
          mma(st[2 * p], kf, b[0], b[1]);
          mma(st[2 * p + 1], kf, b[2], b[3]);
          ldsm4(b, bn_addr<D>(dOb, 16 * p, kk, lane));
          mma(dpt[2 * p], vf, b[0], b[1]);
          mma(dpt[2 * p + 1], vf, b[2], b[3]);
        }
      }

      // P^T = exp2(S^T scale log2e - lse log2e), dS^T = P^T (dP^T - delta);
      // only tiles that cross the column limit or the diagonal mask.
      const bool masked =
          k0 + wr + 16 > lim || (causal && q0 < k0 + wr + 15);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * n + 2 * t + e;  // q row in the tile
          const float lse2 = lse_b[r] * kLog2e, dl = dl_b[r];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 2 * h + e;
            float p = fast_exp2(fmaf(st[n][i], sl2, -lse2));
            if (masked) {
              const int col = k0 + wr + g + 8 * h;
              if (!(col < lim && (!causal || col <= q0 + r))) p = 0.f;
            }
            st[n][i] = p;
            dpt[n][i] = p * (dpt[n][i] - dl);
          }
        }

      // dV += P^T dO and dK += dS^T Q, both A operands from registers.
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        to_a(pa, st[2 * kk], st[2 * kk + 1]);
        to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int cp = 0; cp < DT / 2; ++cp) {
          uint32_t b[4];
          ldsm4_t(b, bk_addr<D>(dOb, 16 * kk, cp, lane));
          mma(dva[2 * cp], pa, b[0], b[1]);
          mma(dva[2 * cp + 1], pa, b[2], b[3]);
          ldsm4_t(b, bk_addr<D>(Qb, 16 * kk, cp, lane));
          mma(dka[2 * cp], da, b[0], b[1]);
          mma(dka[2 * cp + 1], da, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this slot is free for tile qb + 2
  }
}

// ---------------------------------------------------------------------------
// the dq walk
// ---------------------------------------------------------------------------

// dq: a block owns BM = 4 warps x WM strips x 16 q rows, as the forward's
// does, and walks 64-column kv tiles of K and V through the same two-slot
// ring. With q rows as the MMA's M, S = Q K^T and dP = dO V^T come out as
// accumulators, and dS = P (dP - delta), packed to bf16, is the A operand
// of dQ += dS K, K read transposed as V is in P V: dS never leaves
// registers. Shared memory: Q and dO (BM x D each), the ring's two slots
// of K and of V, then lse and delta of the block's rows.
template <int D, int WM>
constexpr int dq_smem_bytes() {
  return (2 * kWarps * WM * 16 * D + 2 * 2 * kKvCols * D) * 2 +
         2 * kWarps * WM * 16 * 4;
}

// The block's q rows [q0, q0 + BM) in the swizzled tiles Qs and dOs, with
// their lse (natural log) at lse_s and delta at dl_s, walk kv tiles
// 0 .. nkv - 1 of k, v [L, D] (this row's) through the two slots at Ks and
// Vs; tile 0 must already be committed into slot 0, and Qs, dOs, lse_s and
// dl_s visible to every warp. Column c is visible to row r when c < lim
// and, under causal, c <= r. On return dqa = sum dS K over the warp's
// strips, without the scale. QO_REGS holds Q's and dO's fragments in
// registers across the walk; without it they are read from shared memory
// at each use. SPLIT_DS feeds dS K with dS as two bf16 terms (~2^-16 of
// dS left, where one term leaves bf16's 2^-9).
template <int D, int WM, bool QO_REGS, bool SPLIT_DS>
__device__ __forceinline__ void dq_walk(const bf16* Qs, const bf16* dOs,
                                        bf16* Ks, bf16* Vs,
                                        const float* lse_s, const float* dl_s,
                                        const bf16* k, const bf16* v, int L,
                                        int lim, int causal, int q0, int nkv,
                                        float sl2,
                                        float (&dqa)[WM][D / 8][4]) {
  constexpr int BN = kKvCols;
  constexpr int KC = D / 16, NT = BN / 8, DT = D / 8;
  constexpr int RW = QO_REGS ? WM : 1, RK = QO_REGS ? KC : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * WM * 16;  // the warp's first row in the tile

  uint32_t qa[RW][RK][4], oa[RW][RK][4];
  if constexpr (QO_REGS) {
#pragma unroll
    for (int s = 0; s < WM; ++s)
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        ldsm4(qa[s][kk], a_addr<D>(Qs, wr + 16 * s, kk, lane));
        ldsm4(oa[s][kk], a_addr<D>(dOs, wr + 16 * s, kk, lane));
      }
  }

  float lse2[WM][2], dl[WM][2];
#pragma unroll
  for (int s = 0; s < WM; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr + 16 * s + g + 8 * h;
      lse2[s][h] = lse_s[r] * kLog2e;
      dl[s][h] = dl_s[r];
    }
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[s][d][e] = 0.f;
  }

  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * BN;
    const bf16* Kb = Ks + (j & 1) * BN * D;
    const bf16* Vb = Vs + (j & 1) * BN * D;
    if (j + 1 < nkv) {
      load_async<BN, D>(Ks + ((j + 1) & 1) * BN * D, k, k0 + BN, L);
      load_async<BN, D>(Vs + ((j + 1) & 1) * BN * D, v, k0 + BN, L);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed
    __syncthreads();

    // A warp whose rows all lie above the tile's first column sees none of
    // it (causal); it skips the tile.
    if (!causal || k0 <= q0 + wr + WM * 16 - 1) {
      float sc[WM][NT][4], dp[WM][NT][4];
#pragma unroll
      for (int s = 0; s < WM; ++s)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[s][n][e] = dp[s][n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        uint32_t qs[WM][4], os[WM][4];
        if constexpr (!QO_REGS) {
#pragma unroll
          for (int s = 0; s < WM; ++s) {
            ldsm4(qs[s], a_addr<D>(Qs, wr + 16 * s, kk, lane));
            ldsm4(os[s], a_addr<D>(dOs, wr + 16 * s, kk, lane));
          }
        }
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t b[4];
          ldsm4(b, bn_addr<D>(Kb, 16 * p, kk, lane));
#pragma unroll
          for (int s = 0; s < WM; ++s) {
            const uint32_t(&qf)[4] = QO_REGS ? qa[s % RW][kk % RK] : qs[s];
            mma(sc[s][2 * p], qf, b[0], b[1]);
            mma(sc[s][2 * p + 1], qf, b[2], b[3]);
          }
          ldsm4(b, bn_addr<D>(Vb, 16 * p, kk, lane));
#pragma unroll
          for (int s = 0; s < WM; ++s) {
            const uint32_t(&of)[4] = QO_REGS ? oa[s % RW][kk % RK] : os[s];
            mma(dp[s][2 * p], of, b[0], b[1]);
            mma(dp[s][2 * p + 1], of, b[2], b[3]);
          }
        }
      }

      // P = exp2(S scale log2e - lse log2e), dS = P (dP - delta), in place
      // of dP; only tiles that cross the column limit or the warp's
      // diagonal mask.
      const bool masked =
          k0 + BN > lim || (causal && k0 + BN - 1 > q0 + wr);
#pragma unroll
      for (int s = 0; s < WM; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = q0 + wr + 16 * s + g + 8 * h;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 2 * h + e;
              float p = fast_exp2(fmaf(sc[s][n][i], sl2, -lse2[s][h]));
              if (masked) {
                const int col = k0 + 8 * n + 2 * t + e;
                if (!(col < lim && (!causal || col <= row))) p = 0.f;
              }
              dp[s][n][i] = p * (dp[s][n][i] - dl[s][h]);
            }
        }

      // dQ += dS K, dS straight from the accumulators as bf16 A fragments.
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t da[WM][4], dr[SPLIT_DS ? WM : 1][4];
#pragma unroll
        for (int s = 0; s < WM; ++s) {
          to_a(da[s], dp[s][2 * kk], dp[s][2 * kk + 1]);
          if constexpr (SPLIT_DS)
            to_a_rest(dr[s], dp[s][2 * kk], dp[s][2 * kk + 1], da[s]);
        }
#pragma unroll
        for (int cp = 0; cp < DT / 2; ++cp) {
          uint32_t b[4];
          ldsm4_t(b, bk_addr<D>(Kb, 16 * kk, cp, lane));
#pragma unroll
          for (int s = 0; s < WM; ++s) {
            mma(dqa[s][2 * cp], da[s], b[0], b[1]);
            mma(dqa[s][2 * cp + 1], da[s], b[2], b[3]);
            if constexpr (SPLIT_DS) {
              mma(dqa[s][2 * cp], dr[s], b[0], b[1]);
              mma(dqa[s][2 * cp + 1], dr[s], b[2], b[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // slot j & 1 is free for tile j + 2
  }
}

}  // namespace tc

}  // namespace
