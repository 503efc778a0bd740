// Fused AdamW update for Hopper (sm_90a): one launch per (dtype, decay)
// group of parameter leaves, updating p, m and v in place.
//
// Replaces the Pallas TPU kernel of the JAX package
//   distributeddeeplearning_tpu/ops/fused_adamw.py  _kernel
//
// Semantics (the reference's, element by element, fp32):
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + (1 - b2) * g * g
//   delta = -lr * ((m * c1) / (sqrt(v * c2) + eps) + wd * p)
//   p = p + delta
// with c1 = 1 / (1 - b1^t), c2 = 1 / (1 - b2^t) and lr computed on the host
// from the step count (optax's convention: lr at the pre-increment count,
// the bias corrections at the post-increment one). Every product, quotient,
// sum and root is rounded on its own (__fmul_rn and friends, no contraction
// into fused multiply-adds), so the kernel gives the plain torch version's
// numbers bit for bit. The JAX kernel writes delta, new m and new v into
// donated copies; here p, m and v are updated in place, which is the same
// function with no extra buffers.
//
// Design. The TPU kernel ran on (rows, 128) tiles of buckets concatenated
// from the leaves, a layout for VMEM and HBM limits that the card does not
// have. Here the group is a device table of (p, g, m, v, length) per leaf;
// every thread block walks the leaves in order with a grid-stride loop, so
// no leaf is copied or concatenated, and loads are 16-byte float4 where the
// four pointers allow it.
//
// Bound. Per element the update reads p, g, m, v and writes p, m, v: 28 B
// for ~12 flops, far below the card's balance point, so it is memory-bound:
// ~124.4M elements of GPT-2 124M move ~3.5 GB, ~1.04 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float lr, b1, omb1, b2, omb2, c1, c2, eps, wd;
};

__device__ __forceinline__ void adamw_elem(float& p, float g, float& m,
                                           float& v, const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float mhat = __fmul_rn(m, h.c1);
  const float vhat = __fmul_rn(v, h.c2);
  const float u = __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps)),
                            __fmul_rn(h.wd, p));
  p = __fadd_rn(p, __fmul_rn(-h.lr, u));
}

// table: int64 [5, n] -- rows p, g, m, v pointers, then lengths.
__global__ void __launch_bounds__(kThreads)
    fused_adamw_kernel(const long long* __restrict__ table, int n, Hyper h) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  for (int leaf = 0; leaf < n; ++leaf) {
    const long long ap = table[leaf], ag = table[n + leaf];
    const long long am = table[2 * n + leaf], av = table[3 * n + leaf];
    const long long len = table[4 * n + leaf];
    float* p = reinterpret_cast<float*>(ap);
    const float* g = reinterpret_cast<const float*>(ag);
    float* m = reinterpret_cast<float*>(am);
    float* v = reinterpret_cast<float*>(av);
    const bool vec = ((ap | ag | am | av) & 15) == 0;
    const long long nvec = vec ? len / 4 : 0;
    for (long long i = t0; i < nvec; i += stride) {
      float4 pp = reinterpret_cast<float4*>(p)[i];
      const float4 gg = reinterpret_cast<const float4*>(g)[i];
      float4 mm = reinterpret_cast<float4*>(m)[i];
      float4 vv = reinterpret_cast<float4*>(v)[i];
      adamw_elem(pp.x, gg.x, mm.x, vv.x, h);
      adamw_elem(pp.y, gg.y, mm.y, vv.y, h);
      adamw_elem(pp.z, gg.z, mm.z, vv.z, h);
      adamw_elem(pp.w, gg.w, mm.w, vv.w, h);
      reinterpret_cast<float4*>(p)[i] = pp;
      reinterpret_cast<float4*>(m)[i] = mm;
      reinterpret_cast<float4*>(v)[i] = vv;
    }
    for (long long i = nvec * 4 + t0; i < len; i += stride) {
      float pp = p[i], mm = m[i], vv = v[i];
      adamw_elem(pp, g[i], mm, vv, h);
      p[i] = pp;
      m[i] = mm;
      v[i] = vv;
    }
  }
}

}  // namespace

extern "C" {

const char* ddl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One launch over the n leaves of a group on `stream`; returns
// cudaGetLastError() of the launch. table: device int64 [5, n]; blocks: the
// grid size (the wrapper sizes it to the group's element count).
int ddl_fused_adamw(const void* table, int n, int blocks, float lr, float b1,
                    float omb1, float b2, float omb2, float c1, float c2,
                    float eps, float wd, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (n == 0) return cudaSuccess;
  const Hyper h{lr, b1, omb1, b2, omb2, c1, c2, eps, wd};
  fused_adamw_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), n, h);
  return cudaGetLastError();
}

}  // extern "C"
