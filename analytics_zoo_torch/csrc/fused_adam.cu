// Fused Adam update of one float32 parameter leaf, in place, for Hopper
// (sm_90a).
//
// Replaces: analytics_zoo_tpu/ops/fused.py::_adam_kernel
//           (launched from adam_leaf_update through _pallas_moment_call).
//
// Computes, for every element, in the order of the reference's lax branch
// (optax scale_by_adam -> scale_by_learning_rate -> apply_updates):
//   g' = g * clip_scale            (flag 1: l2-norm clipping)
//   g' = clip(g', lo, hi)          (flag 2: constant clipping)
//   g' = g' + wd * p               (flag 4: weight decay)
//   m  = (1 - b1) * g' + b1 * m
//   v  = (1 - b2) * (g' * g') + b2 * v
//   p  = p + step_size * ((m / bc1) / (sqrt(v / bc2) + eps))
// with scal = [clip_scale, step_size, bc1, bc2] read from a 4-float device
// buffer (the TPU kernel reads them from SMEM).  They depend on the step
// count and the gradient norm, both on the device; passing them by value
// would cost a host sync every step.  Every multiply, add, divide and
// square root rounds on its own (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn: no contraction into FMAs), so the result repeats the plain
// PyTorch version's elementwise ops bit for bit.
//
// What bounds it on the H100: p, g, m, v read and p, m, v written, 28 bytes
// an element against ~15 flops, so device memory (3.35 TB/s) bounds it.
//
// Design: one launch per leaf, a grid-stride pass.  Where every pointer is
// 16-byte aligned each thread moves float4s; the last n % 4 elements (or
// all of them, unaligned) take a scalar loop.  Any element count works:
// there is no TPU tile rule here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int CLIP_SCALE = 1, CLIP_CONST = 2, WEIGHT_DECAY = 4;

struct Hyper {
    float b1, c1, b2, c2, eps, wd, lo, hi;
    int flags;
};

__device__ __forceinline__ float clip(float g, float lo, float hi) {
    // jnp.clip / torch.clamp: a NaN stays NaN
    return g < lo ? lo : (g > hi ? hi : g);
}

__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v,
                                         const Hyper& h, float clip_scale,
                                         float step, float bc1, float bc2) {
    if (h.flags & CLIP_SCALE) g = __fmul_rn(g, clip_scale);
    if (h.flags & CLIP_CONST) g = clip(g, h.lo, h.hi);
    if (h.flags & WEIGHT_DECAY) g = __fadd_rn(g, __fmul_rn(h.wd, p));
    m = __fadd_rn(__fmul_rn(h.c1, g), __fmul_rn(h.b1, m));
    v = __fadd_rn(__fmul_rn(h.c2, __fmul_rn(g, g)), __fmul_rn(h.b2, v));
    const float mh = __fdiv_rn(m, bc1);
    const float vh = __fdiv_rn(v, bc2);
    const float u = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), h.eps));
    p = __fadd_rn(p, __fmul_rn(step, u));
}

__global__ void fused_adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                                  float* __restrict__ m, float* __restrict__ v,
                                  const float* __restrict__ scal, long long n,
                                  long long n4, Hyper h) {
    const float clip_scale = scal[0], step = scal[1], bc1 = scal[2], bc2 = scal[3];
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    for (long long i = first; i < n4; i += stride) {
        float4 pv = p4[i], mv = m4[i], vv = v4[i];
        const float4 gv = g4[i];
        adam_one(pv.x, gv.x, mv.x, vv.x, h, clip_scale, step, bc1, bc2);
        adam_one(pv.y, gv.y, mv.y, vv.y, h, clip_scale, step, bc1, bc2);
        adam_one(pv.z, gv.z, mv.z, vv.z, h, clip_scale, step, bc1, bc2);
        adam_one(pv.w, gv.w, mv.w, vv.w, h, clip_scale, step, bc1, bc2);
        p4[i] = pv;
        m4[i] = mv;
        v4[i] = vv;
    }
    for (long long i = 4 * n4 + first; i < n; i += stride)
        adam_one(p[i], g[i], m[i], v[i], h, clip_scale, step, bc1, bc2);
}

int grid_for(long long work) {
    long long blocks = (work + NTHREADS - 1) / NTHREADS;
    const long long cap = 132LL * 16;   // 16 resident blocks on each of 132 SMs
    if (blocks > cap) blocks = cap;
    return (int)(blocks > 0 ? blocks : 1);
}

}  // namespace

extern "C" int zoo_fused_adam(float* p, const float* g, float* m, float* v,
                              const float* scal, long long n, float b1, float c1,
                              float b2, float c2, float eps, float wd, float lo,
                              float hi, int flags, void* stream) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (n <= 0) return (int)cudaSuccess;
    const bool aligned = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                           reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v)) &
                          15) == 0;
    const long long n4 = aligned ? n / 4 : 0;
    const Hyper h{b1, c1, b2, c2, eps, wd, lo, hi, flags};
    fused_adam_kernel<<<grid_for(n4 > 0 ? n4 : n), NTHREADS, 0, s>>>(p, g, m, v, scal,
                                                                     n, n4, h);
    return (int)cudaGetLastError();
}
