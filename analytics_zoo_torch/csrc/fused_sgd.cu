// Fused SGD (+ momentum / Nesterov) update of one float32 parameter leaf,
// in place, for Hopper (sm_90a).
//
// Replaces: analytics_zoo_tpu/ops/fused.py::_sgd_kernel
//           (launched from sgd_leaf_update through _pallas_moment_call).
//
// Computes, for every element, in the order of the reference's lax branch
// (optax add_decayed_weights -> trace -> scale_by_learning_rate ->
// apply_updates):
//   g' = g * clip_scale            (flag 1: l2-norm clipping)
//   g' = clip(g', lo, hi)          (flag 2: constant clipping)
//   g' = g' + wd * p               (flag 4: weight decay)
//   t  = g' + momentum * t         (flag 16: a momentum trace; else u = g')
//   u  = g' + momentum * t         (flag 8: Nesterov; else u = t)
//   p  = p + step_size * u
// with scal = [clip_scale, step_size, -, -] read from a 4-float device
// buffer (the TPU kernel reads them from SMEM), so a step with a schedule
// or an l2-norm clip needs no host sync.  Each operation rounds on its own
// (__fmul_rn, __fadd_rn), so the result repeats the plain PyTorch version
// bit for bit.
//
// What bounds it on the H100: p, g, t read and p, t written, 20 bytes an
// element against a few flops, so device memory (3.35 TB/s) bounds it.
//
// Design: one launch per leaf, a grid-stride pass, float4s where every
// pointer is 16-byte aligned and a scalar loop for the rest.  Any element
// count works.  Without momentum there is no trace and `t` may be null.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int CLIP_SCALE = 1, CLIP_CONST = 2, WEIGHT_DECAY = 4, NESTEROV = 8,
              TRACE = 16;

struct Hyper {
    float momentum, wd, lo, hi;
    int flags;
};

__device__ __forceinline__ float clip(float g, float lo, float hi) {
    // jnp.clip / torch.clamp: a NaN stays NaN
    return g < lo ? lo : (g > hi ? hi : g);
}

__device__ __forceinline__ void sgd_one(float& p, float g, float* t, const Hyper& h,
                                        float clip_scale, float step) {
    if (h.flags & CLIP_SCALE) g = __fmul_rn(g, clip_scale);
    if (h.flags & CLIP_CONST) g = clip(g, h.lo, h.hi);
    if (h.flags & WEIGHT_DECAY) g = __fadd_rn(g, __fmul_rn(h.wd, p));
    float u = g;
    if (h.flags & TRACE) {
        const float tr = __fadd_rn(g, __fmul_rn(h.momentum, *t));
        *t = tr;
        u = (h.flags & NESTEROV) ? __fadd_rn(g, __fmul_rn(h.momentum, tr)) : tr;
    }
    p = __fadd_rn(p, __fmul_rn(step, u));
}

__global__ void fused_sgd_kernel(float* __restrict__ p, const float* __restrict__ g,
                                 float* __restrict__ t, const float* __restrict__ scal,
                                 long long n, long long n4, Hyper h) {
    const float clip_scale = scal[0], step = scal[1];
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    const bool trace = (h.flags & TRACE) != 0;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* t4 = reinterpret_cast<float4*>(t);
    for (long long i = first; i < n4; i += stride) {
        float4 pv = p4[i];
        const float4 gv = g4[i];
        float4 tv = trace ? t4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
        sgd_one(pv.x, gv.x, &tv.x, h, clip_scale, step);
        sgd_one(pv.y, gv.y, &tv.y, h, clip_scale, step);
        sgd_one(pv.z, gv.z, &tv.z, h, clip_scale, step);
        sgd_one(pv.w, gv.w, &tv.w, h, clip_scale, step);
        p4[i] = pv;
        if (trace) t4[i] = tv;
    }
    float unused = 0.f;
    for (long long i = 4 * n4 + first; i < n; i += stride)
        sgd_one(p[i], g[i], trace ? &t[i] : &unused, h, clip_scale, step);
}

int grid_for(long long work) {
    long long blocks = (work + NTHREADS - 1) / NTHREADS;
    const long long cap = 132LL * 16;   // 16 resident blocks on each of 132 SMs
    if (blocks > cap) blocks = cap;
    return (int)(blocks > 0 ? blocks : 1);
}

}  // namespace

extern "C" int zoo_fused_sgd(float* p, const float* g, float* t, const float* scal,
                             long long n, float momentum, float wd, float lo,
                             float hi, int flags, void* stream) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (n <= 0) return (int)cudaSuccess;
    if ((flags & TRACE) && t == nullptr) return (int)cudaErrorInvalidValue;
    const bool aligned = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                           reinterpret_cast<uintptr_t>(t)) & 15) == 0;
    const long long n4 = aligned ? n / 4 : 0;
    const Hyper h{momentum, wd, lo, hi, flags};
    fused_sgd_kernel<<<grid_for(n4 > 0 ? n4 : n), NTHREADS, 0, s>>>(p, g, t, scal, n, n4,
                                                                    h);
    return (int)cudaGetLastError();
}
