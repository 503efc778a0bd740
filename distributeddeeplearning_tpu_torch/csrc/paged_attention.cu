// Paged-attention decode for Hopper (sm_90a): one query token per row,
// read in place from the block-pooled KV cache of the serving engine.
//
// Replaces the Pallas TPU kernels of the JAX package
//   distributeddeeplearning_tpu/ops/paged_attention.py  _decode_kernel
//   distributeddeeplearning_tpu/ops/paged_attention.py  _decode_kernel_q8
// (both launched by the one pallas_call in paged_attention()).
//
// Semantics (same as the reference): row b attends columns 0..seq_lens[b]
// inclusive of its logical sequence (clamped to the table's pages); logical
// page j of row b lives in pool block page_table[b, j]; query head
// g*num_rep + r reads kv group g (GQA, group-major); scores are masked to a
// finite -1e30 past the cursor; the softmax is in fp32 and the output is
// acc / max(l, 1e-30), cast to q's type. An int8 pool carries one f32 scale
// per (slot, kv head) vector, applied on load.
//
// Bound: the call reads sum_b (seq_lens[b] + 1) * kv_heads * D * 2 pool
// elements (plus their scales under int8) and does ~4 flops per element:
// a matrix-vector product, far below Hopper's ~295 flops per byte, so the
// tensor cores buy nothing. Its least time is those bytes over the
// 3.35 TB/s of HBM, and what stands between a kernel and that is keeping
// enough independent loads in flight on every SM.
//
// Design (split-sequence decode, "flash-decoding"). The TPU kernel walked a
// row's pages on a sequential grid axis with the carries in VMEM. Here:
//   - each row's columns are cut into splits of kSplit; the grid is
//     (B * kv_heads, ceil(pages * block_size / kSplit)), from shapes only
//     (the cursors are never read on the host), and a block whose split
//     starts past its row's cursor returns at once;
//   - a block owns one split of one (row, kv group). A thread loads the
//     table entries of its keys beside the cursor, then issues every one
//     of its keys' K and V copies before the first use: 16 bytes of a key
//     row each (the lanes of one row on neighbouring addresses), through
//     cp.async into shared memory as they are stored (bf16, int8 or f32).
//     It reads back only what it copied, so its own wait orders them. The
//     int8 scales are loaded once per key row;
//   - for each of the group's num_rep q heads, in turn over the same staged
//     rows: a lane's partial dot product, an xor-shuffle sum over the lanes
//     of its key, the split's max and exp-sums, and P V summed over the
//     keys by shuffles and a small shared-memory step. The split writes
//     its unnormalised o and its (m, l) to fp32 scratch from the wrapper;
//   - a second small kernel merges a (row, head)'s live splits: each is
//     rescaled by exp(m_s - m_max), the sum is divided by the rescaled l
//     and cast to q's type. m stays finite (-1e30), so no split enters the
//     merge as -inf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_mma.cuh"  // kNegInf, prepare, and tc's cp.async helpers

namespace {

constexpr int kSplit = 128;        // key columns of one split
constexpr int kKeysPerThread = 4;  // 16-byte K and V loads a thread issues

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

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

// 16 bytes of a pool row: kEpl elements, unpacked to fp32.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int kEpl = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kEpl = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // little-endian: element 2i is the low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Chunk<int8_t> {
  static constexpr int kEpl = 16;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] =
            static_cast<float>(static_cast<int8_t>(w[i] >> (8 * j)));
  }
};

// How one split's block is laid out for a pool type and head dim: kLpk
// lanes share a key row (16 bytes each), kKeysPerThread keys a thread.
template <typename TKV, int D>
struct Split {
  static constexpr int kEpl = Chunk<TKV>::kEpl;
  static constexpr int kLpk = D / kEpl;
  static_assert(D % kEpl == 0 && kLpk >= 1 && kLpk <= 32 && 32 % kLpk == 0,
                "a key row must be 16 to 512 bytes, a power of two");
  static constexpr int kWant = kSplit * kLpk / kKeysPerThread;
  static constexpr int kThreads = kWant < 32 ? 32 : (kWant > 512 ? 512 : kWant);
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kKeysPerPass = kThreads / kLpk;
  static constexpr int kPasses = kSplit / kKeysPerPass;
  static_assert(kPasses * kKeysPerPass == kSplit, "split must tile the block");
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One split of one (row, kv group): its num_rep heads' unnormalised o and
// their (m, l), at [b, head, split] of the scratch.
template <typename TQ, typename TKV, int D,
          int kThreads = Split<TKV, D>::kThreads>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ pool_k,
    const TKV* __restrict__ pool_v, const float* __restrict__ scale_k,
    const float* __restrict__ scale_v, const int32_t* __restrict__ page_table,
    const int32_t* __restrict__ seq_lens, float* __restrict__ o_part,
    float* __restrict__ m_part, float* __restrict__ l_part, int num_heads,
    int block_size, int kv_heads, int num_pages, int num_rep, float sm_scale) {
  using S = Split<TKV, D>;
  constexpr int E = S::kEpl;
  constexpr int LPK = S::kLpk;
  constexpr int P = S::kPasses;
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  extern __shared__ uint4 stage[];  // [K, V][kSplit keys][LPK chunks]
  __shared__ float red_m[S::kWarps];
  __shared__ float red_l[S::kWarps];
  __shared__ float red_acc[S::kWarps][D];

  const int b = blockIdx.x / kv_heads;
  const int g = blockIdx.x - b * kv_heads;
  const int split = blockIdx.y;
  const int col0 = split * kSplit;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunk = lane % LPK;  // this lane's 16 bytes of its key row
  const int key0 = warp * (32 / LPK) + lane / LPK;

  // The table entries of this thread's keys load beside the cursor (every
  // entry is a valid block id), so the pool loads wait on one round trip.
  const int32_t* tbl = page_table + static_cast<size_t>(b) * num_pages;
  int blk[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int col = col0 + p * S::kKeysPerPass + key0;
    blk[p] = __ldg(tbl + min(col / block_size, num_pages - 1));
  }
  // The last visible column: the cursor, clamped to the table's pages.
  const int last = min(__ldg(seq_lens + b), num_pages * block_size - 1);
  if (col0 > last) return;  // the whole split lies past the cursor

  // This thread's key rows, and their int8 scales (once per row).
  size_t rows[P];
  float sk[P], sv[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int col = col0 + p * S::kKeysPerPass + key0;
    const bool ok = col <= last;
    const size_t slot = static_cast<size_t>(blk[p]) * block_size +
                        col % block_size;
    rows[p] = ok ? slot * kv_heads + g : 0;
    sk[p] = sv[p] = 0.f;
    if (kQuant && ok) {
      sk[p] = __ldg(scale_k + rows[p]);
      sv[p] = __ldg(scale_v + rows[p]);
    }
  }
  // Every K chunk, then every V chunk, in flight before any is used: two
  // commit groups, so the scores start once K has landed.
  uint4* ks = stage + (key0 * LPK + chunk);
  uint4* vs = ks + kSplit * LPK;
  constexpr int kPassStride = S::kKeysPerPass * LPK;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const bool ok = col0 + p * S::kKeysPerPass + key0 <= last;
    tc::cp_async16(tc::saddr(ks + p * kPassStride),
                   pool_k + rows[p] * D + chunk * E, ok);
  }
  tc::cp_async_commit();
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const bool ok = col0 + p * S::kKeysPerPass + key0 <= last;
    tc::cp_async16(tc::saddr(vs + p * kPassStride),
                   pool_v + rows[p] * D + chunk * E, ok);
  }
  tc::cp_async_commit();
  // Each thread reads back only the chunks it copied: its own wait is all
  // the ordering the stage needs.
  tc::cp_async_wait<1>();  // K has landed; V may still be in flight

  const int n_splits = gridDim.y;
  for (int r = 0; r < num_rep; ++r) {
    const size_t head = static_cast<size_t>(b) * num_heads +
                        static_cast<size_t>(g) * num_rep + r;
    float qf[E];
    const TQ* qh = q + head * D + chunk * E;
#pragma unroll
    for (int e = 0; e < E; ++e) qf[e] = to_f32(qh[e]) * sm_scale;

    float s[P];
    float mx = kNegInf;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float kf[E];
      Chunk<TKV>::unpack(ks[p * kPassStride], kf);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) d = fmaf(qf[e], kf[e], d);
#pragma unroll
      for (int o = LPK / 2; o > 0; o >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      if (kQuant) d *= sk[p];
      const int col = col0 + p * S::kKeysPerPass + key0;
      s[p] = col <= last ? d : kNegInf;
      mx = fmaxf(mx, s[p]);
    }
    mx = warp_max(mx);
    if (lane == 0) red_m[warp] = mx;
    __syncthreads();
    float m = red_m[0];
#pragma unroll
    for (int w = 1; w < S::kWarps; ++w) m = fmaxf(m, red_m[w]);

    tc::cp_async_wait<0>();
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    float l = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float pr = expf(s[p] - m);  // 0 for a masked key
      l += pr;
      const float pv = kQuant ? pr * sv[p] : pr;
      float vf[E];
      Chunk<TKV>::unpack(vs[p * kPassStride], vf);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(pv, vf[e], acc[e]);
    }
    // Sum over the warp's keys: the lanes that hold the same chunk.
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
      l += __shfl_xor_sync(0xffffffffu, l, o);
    }
    if (lane < LPK) {
#pragma unroll
      for (int e = 0; e < E; ++e) red_acc[warp][chunk * E + e] = acc[e];
      if (lane == 0) red_l[warp] = l;
    }
    __syncthreads();
    const size_t at = head * n_splits + split;
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float a = red_acc[0][d];
#pragma unroll
      for (int w = 1; w < S::kWarps; ++w) a += red_acc[w][d];
      o_part[at * D + d] = a;
    }
    if (threadIdx.x == 0) {
      float sum = red_l[0];
#pragma unroll
      for (int w = 1; w < S::kWarps; ++w) sum += red_l[w];
      m_part[at] = m;
      l_part[at] = sum;
    }
    __syncthreads();  // the next head rewrites red_*
  }
}

// One (row, head): the merge of its live splits into the output row.
template <typename TQ>
__global__ void paged_merge_kernel(const float* __restrict__ o_part,
                                   const float* __restrict__ m_part,
                                   const float* __restrict__ l_part,
                                   const int32_t* __restrict__ seq_lens,
                                   TQ* __restrict__ out, int num_heads,
                                   int head_dim, int n_splits, int columns) {
  const size_t bh = blockIdx.x;
  // Splits that hold a visible column: none for a negative cursor or an
  // empty table.
  const int last = min(seq_lens[bh / num_heads], columns - 1);
  const int live = last < 0 ? 0 : last / kSplit + 1;
  const float* m = m_part + bh * n_splits;
  const float* l = l_part + bh * n_splits;
  float m_max = kNegInf;
  for (int s = 0; s < live; ++s) m_max = fmaxf(m_max, m[s]);
  for (int d = threadIdx.x; d < head_dim; d += blockDim.x) {
    float acc = 0.f, sum = 0.f;
    for (int s = 0; s < live; ++s) {
      const float w = expf(m[s] - m_max);
      sum = fmaf(w, l[s], sum);
      acc = fmaf(w, o_part[(bh * n_splits + s) * head_dim + d], acc);
    }
    out[bh * head_dim + d] = from_f32<TQ>(acc / fmaxf(sum, 1e-30f));
  }
}

struct Args {
  const void *q, *pool_k, *pool_v, *scale_k, *scale_v, *page_table, *seq_lens;
  void *out;
  float *o_part, *m_part, *l_part;
  int batch, num_heads, head_dim, block_size, kv_heads, num_pages, num_rep,
      n_splits;
  float sm_scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D>
cudaError_t launch(const Args& a) {
  if (a.n_splits > 0) {  // no pages, no split: the merge writes zeros
    constexpr int kStage = 2 * kSplit * D * static_cast<int>(sizeof(TKV));
    if (kStage > 48 * 1024) {  // f32 pools: the opt-in, as flash does
      const cudaError_t err = prepare(paged_split_kernel<TQ, TKV, D>, kStage);
      if (err != cudaSuccess) return err;
    }
    const dim3 grid(a.batch * a.kv_heads, a.n_splits);
    paged_split_kernel<TQ, TKV, D>
        <<<grid, Split<TKV, D>::kThreads, kStage, a.stream>>>(
            static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.pool_k),
            static_cast<const TKV*>(a.pool_v),
            static_cast<const float*>(a.scale_k),
            static_cast<const float*>(a.scale_v),
            static_cast<const int32_t*>(a.page_table),
            static_cast<const int32_t*>(a.seq_lens), a.o_part, a.m_part,
            a.l_part, a.num_heads, a.block_size, a.kv_heads, a.num_pages,
            a.num_rep, a.sm_scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  paged_merge_kernel<TQ><<<a.batch * a.num_heads, (D + 31) / 32 * 32, 0,
                           a.stream>>>(
      a.o_part, a.m_part, a.l_part, static_cast<const int32_t*>(a.seq_lens),
      static_cast<TQ*>(a.out), a.num_heads, D, a.n_splits,
      a.num_pages * a.block_size);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_dim(const Args& a) {
  switch (a.head_dim) {  // the head dims of the JAX package's model sizes
    case 16:
      return launch<TQ, TKV, 16>(a);
    case 64:
      return launch<TQ, TKV, 64>(a);
    case 128:
      return launch<TQ, TKV, 128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t dispatch_kv(int kv_dtype, const Args& a) {
  switch (kv_dtype) {
    case kF32:
      return dispatch_dim<TQ, float>(a);
    case kBF16:
      return dispatch_dim<TQ, __nv_bfloat16>(a);
    case kI8:
      if (a.scale_k == nullptr || a.scale_v == nullptr)
        return cudaErrorInvalidValue;
      return dispatch_dim<TQ, int8_t>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Key columns of one split: the scratch holds ceil(pages * bs / split)
// splits per (row, head).
int ddl_paged_attention_split() { return kSplit; }

const char* ddl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the split kernel and then the merge on `stream`, and returns
// cudaGetLastError() of the first launch that fails (else of the merge).
// q [B, H, D] (f32 or bf16), pools [NB, bs, KVH, D] (f32, bf16 or int8,
// 16-byte aligned), scales [NB, bs, KVH] f32 (int8 pools only, else null),
// page_table [B, pages] i32, seq_lens [B] i32, out [B, H, D] in q's type;
// the scratch o_part [B, H, n_splits, D], m_part and l_part [B, H,
// n_splits], all f32, with n_splits = ceil(pages * bs / split).
int ddl_paged_attention_decode(const void* q, const void* pool_k,
                               const void* pool_v, const void* scale_k,
                               const void* scale_v, const void* page_table,
                               const void* seq_lens, void* out, void* o_part,
                               void* m_part, void* l_part, int batch,
                               int num_heads, int head_dim, int block_size,
                               int kv_heads, int num_pages, int num_rep,
                               int n_splits, float sm_scale, int q_dtype,
                               int kv_dtype, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this call's
  if (batch == 0) return cudaSuccess;
  if (n_splits != (num_pages * block_size + kSplit - 1) / kSplit)
    return cudaErrorInvalidValue;
  const Args a{q, pool_k, pool_v, scale_k, scale_v, page_table, seq_lens,
               out, static_cast<float*>(o_part), static_cast<float*>(m_part),
               static_cast<float*>(l_part), batch, num_heads, head_dim,
               block_size, kv_heads, num_pages, num_rep, n_splits, sm_scale,
               static_cast<cudaStream_t>(stream)};
  switch (q_dtype) {
    case kF32:
      return dispatch_kv<float>(kv_dtype, a);
    case kBF16:
      return dispatch_kv<__nv_bfloat16>(kv_dtype, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
