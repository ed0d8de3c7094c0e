// Fused Adam update of every float32 leaf of a step in one launch, in
// place, for Hopper (sm_90a).
//
// Replaces: analytics_zoo_tpu/ops/fused.py::_adam_kernel
//           (launched from adam_leaf_update through _pallas_moment_call,
//           once a leaf).
//
// Computes, for every element, in the order of the reference's lax branch
// (optax scale_by_adam -> scale_by_learning_rate -> apply_updates):
//   g' = g * clip_scale            (flag 1: l2-norm clipping)
//   g' = clip(g', lo, hi)          (flag 2: constant clipping)
//   g' = g' + wd * p               (flag 4: weight decay)
//   m  = (1 - b1) * g' + b1 * m
//   v  = (1 - b2) * (g' * g') + b2 * v
//   p  = p + step_size * ((m / bc1) / (sqrt(v / bc2) + eps))
// Every multiply, add, divide and square root rounds on its own
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: no contraction into FMAs),
// so the result repeats the plain PyTorch version's elementwise ops bit for
// bit.
//
// What bounds it on the H100: p, g, m, v read and p, m, v written, 28 bytes
// an element against ~15 flops, so device memory (3.35 TB/s) bounds it.
//
// Design (multi_tensor.cuh): one launch a step for every leaf, the leaf
// table by value as a kernel parameter, one block a chunk of 2048
// elements of one leaf, float4s where the leaf is aligned.  The step's
// scalars (count + 1, bc1, bc2, clip_scale) are computed by every block
// from the count, the gradient norm and the step size in device memory, so
// a step without clipping and at a constant learning rate is this one
// kernel: no prologue of small launches, no host sync.  A small leaf (a
// 2-element bias) costs one block, not one launch.

#include "multi_tensor.cuh"

namespace {

struct Hyper {
    float b1, c1, b2, c2, eps, wd, lo, hi;
    int flags;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v,
                                         const Hyper& h, const mt::Scalars& s) {
    if (h.flags & mt::CLIP_SCALE) g = __fmul_rn(g, s.clip_scale);
    if (h.flags & mt::CLIP_CONST) g = mt::clip(g, h.lo, h.hi);
    if (h.flags & mt::WEIGHT_DECAY) g = __fadd_rn(g, __fmul_rn(h.wd, p));
    m = __fadd_rn(__fmul_rn(h.c1, g), __fmul_rn(h.b1, m));
    v = __fadd_rn(__fmul_rn(h.c2, __fmul_rn(g, g)), __fmul_rn(h.b2, v));
    const float mh = __fdiv_rn(m, s.bc1);
    const float vh = __fdiv_rn(v, s.bc2);
    const float u = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), h.eps));
    p = __fadd_rn(p, __fmul_rn(s.step, u));
}

__device__ __forceinline__ void adam_four(float4& p, const float4& g, float4& m,
                                          float4& v, const Hyper& h,
                                          const mt::Scalars& s) {
    adam_one(p.x, g.x, m.x, v.x, h, s);
    adam_one(p.y, g.y, m.y, v.y, h, s);
    adam_one(p.z, g.z, m.z, v.z, h, s);
    adam_one(p.w, g.w, m.w, v.w, h, s);
}

// (THREADS, 2): with the block size alone ptxas held the kernel to 78
// registers and spilled; two blocks an SM leave it 128, and it takes 72
// without a spill (0.89 of the bound at BERT-base's leaves against 0.75,
// NVIDIA H100 80GB HBM3, 700 W).
template <int CAP>
__global__ void __launch_bounds__(mt::THREADS, 2)
    multi_adam_kernel(const mt::Table<4, CAP> t, const Hyper h, const mt::Step st) {
    const mt::Scalars s = mt::load_scalars(st, h.flags, h.b1, h.b2);
    const long long c = blockIdx.x;
    if (c >= t.chunks) return;
    const int i = mt::find_leaf(t, c);
    float* p = reinterpret_cast<float*>(t.leaf[i].ptr[0]);
    const float* g = reinterpret_cast<const float*>(t.leaf[i].ptr[1]);
    float* m = reinterpret_cast<float*>(t.leaf[i].ptr[2]);
    float* v = reinterpret_cast<float*>(t.leaf[i].ptr[3]);
    const long long lo = (c - t.leaf[i].first) * mt::CHUNK;
    const long long n = t.leaf[i].n;
    const long long hi = lo + mt::CHUNK < n ? lo + mt::CHUNK : n;
    long long tail = lo;
    if (t.leaf[i].aligned) {
        const int nv = (int)((hi - lo) >> 2);
        float4* p4 = reinterpret_cast<float4*>(p + lo);
        const float4* g4 = reinterpret_cast<const float4*>(g + lo);
        float4* m4 = reinterpret_cast<float4*>(m + lo);
        float4* v4 = reinterpret_cast<float4*>(v + lo);
        float4 pv[mt::VEC], gv[mt::VEC], mv[mt::VEC], vv[mt::VEC];
#pragma unroll
        for (int k = 0; k < mt::VEC; ++k) {
            const int j = threadIdx.x + k * mt::THREADS;
            if (j < nv) {
                pv[k] = p4[j];
                gv[k] = g4[j];
                mv[k] = m4[j];
                vv[k] = v4[j];
            }
        }
#pragma unroll
        for (int k = 0; k < mt::VEC; ++k) {
            const int j = threadIdx.x + k * mt::THREADS;
            if (j < nv) {
                adam_four(pv[k], gv[k], mv[k], vv[k], h, s);
                p4[j] = pv[k];
                m4[j] = mv[k];
                v4[j] = vv[k];
            }
        }
        tail = lo + 4LL * nv;
    }
    for (long long e = tail + threadIdx.x; e < hi; e += mt::THREADS)
        adam_one(p[e], g[e], m[e], v[e], h, s);
}

template <int CAP>
int launch(const long long* rows, int leaves, const Hyper& h, const mt::Step& st,
           cudaStream_t stream) {
    mt::Table<4, CAP> t;   // the launch copies it by value
    if (!mt::fill(t, rows, leaves)) return (int)cudaErrorInvalidValue;
    const unsigned grid = t.chunks > 0 ? (unsigned)t.chunks : 1u;
    multi_adam_kernel<CAP><<<grid, mt::THREADS, 0, stream>>>(t, h, st);
    return (int)cudaGetLastError();
}

}  // namespace

// rows: `leaves` rows of mt::Leaf<4> (p, g, m, v, n, first, aligned).
// Either scal (the 4 scalars) or count and count_out are given; gnorm under
// flag 1; step_ptr or step_value; scal_out may be null.
extern "C" int zoo_multi_adam(const long long* rows, int leaves, const float* scal,
                              const int* count, int* count_out, const float* gnorm,
                              const float* step_ptr, float* scal_out, float step_value,
                              float clip_norm, float b1, float c1, float b2, float c2,
                              float eps, float wd, float lo, float hi, int flags,
                              void* stream) {
    if (scal == nullptr && (count == nullptr || count_out == nullptr))
        return (int)cudaErrorInvalidValue;
    if ((flags & mt::CLIP_SCALE) && scal == nullptr && gnorm == nullptr)
        return (int)cudaErrorInvalidValue;
    const Hyper h{b1, c1, b2, c2, eps, wd, lo, hi, flags};
    const mt::Step st{scal,     count,      count_out, gnorm,
                      step_ptr, scal_out,   step_value, clip_norm};
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (leaves <= mt::SMALL) return launch<mt::SMALL>(rows, leaves, h, st, s);
    return launch<mt::LARGE>(rows, leaves, h, st, s);
}
