// Fused SGD (+ momentum / Nesterov) update of every float32 leaf of a step
// in one launch, in place, for Hopper (sm_90a).
//
// Replaces: analytics_zoo_tpu/ops/fused.py::_sgd_kernel
//           (launched from sgd_leaf_update through _pallas_moment_call,
//           once a leaf).
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
// Each operation rounds on its own (__fmul_rn, __fadd_rn), so the result
// repeats the plain PyTorch version bit for bit.
//
// What bounds it on the H100: p, g, t read and p, t written, 20 bytes an
// element (12 without momentum: no trace) against a few flops, so device
// memory (3.35 TB/s) bounds it.
//
// Design (multi_tensor.cuh): one launch a step for every leaf, the leaf
// table by value as a kernel parameter, one block a chunk of 2048
// elements of one leaf, float4s where the leaf is aligned.  The clip
// scale and the step size are computed by every block from the gradient
// norm and the step size in device memory, so a step without clipping and
// at a constant learning rate is this one kernel.  Without momentum a
// row's trace pointer is 0 and no trace is read or written.

#include "multi_tensor.cuh"

namespace {

struct Hyper {
    float momentum, wd, lo, hi;
    int flags;
};

__device__ __forceinline__ void sgd_one(float& p, float g, float& t, const Hyper& h,
                                        const mt::Scalars& s) {
    if (h.flags & mt::CLIP_SCALE) g = __fmul_rn(g, s.clip_scale);
    if (h.flags & mt::CLIP_CONST) g = mt::clip(g, h.lo, h.hi);
    if (h.flags & mt::WEIGHT_DECAY) g = __fadd_rn(g, __fmul_rn(h.wd, p));
    float u = g;
    if (h.flags & mt::TRACE) {
        const float tr = __fadd_rn(g, __fmul_rn(h.momentum, t));
        t = tr;
        u = (h.flags & mt::NESTEROV) ? __fadd_rn(g, __fmul_rn(h.momentum, tr)) : tr;
    }
    p = __fadd_rn(p, __fmul_rn(s.step, u));
}

__device__ __forceinline__ void sgd_four(float4& p, const float4& g, float4& t,
                                         const Hyper& h, const mt::Scalars& s) {
    sgd_one(p.x, g.x, t.x, h, s);
    sgd_one(p.y, g.y, t.y, h, s);
    sgd_one(p.z, g.z, t.z, h, s);
    sgd_one(p.w, g.w, t.w, h, s);
}

// (THREADS, 2), as the Adam kernel: 0.89 of the bound at BERT-base's
// leaves against 0.86 (NVIDIA H100 80GB HBM3, 700 W).
template <int CAP>
__global__ void __launch_bounds__(mt::THREADS, 2)
    multi_sgd_kernel(const mt::Table<3, CAP> t, const Hyper h, const mt::Step st) {
    const mt::Scalars s = mt::load_scalars(st, h.flags, 0.0f, 0.0f);
    const long long c = blockIdx.x;
    if (c >= t.chunks) return;
    const int i = mt::find_leaf(t, c);
    const bool trace = (h.flags & mt::TRACE) != 0;
    float* p = reinterpret_cast<float*>(t.leaf[i].ptr[0]);
    const float* g = reinterpret_cast<const float*>(t.leaf[i].ptr[1]);
    float* tr = reinterpret_cast<float*>(t.leaf[i].ptr[2]);
    const long long lo = (c - t.leaf[i].first) * mt::CHUNK;
    const long long n = t.leaf[i].n;
    const long long hi = lo + mt::CHUNK < n ? lo + mt::CHUNK : n;
    long long tail = lo;
    if (t.leaf[i].aligned) {
        const int nv = (int)((hi - lo) >> 2);
        float4* p4 = reinterpret_cast<float4*>(p + lo);
        const float4* g4 = reinterpret_cast<const float4*>(g + lo);
        float4* t4 = reinterpret_cast<float4*>(tr + lo);
        float4 pv[mt::VEC], gv[mt::VEC], tv[mt::VEC];
#pragma unroll
        for (int k = 0; k < mt::VEC; ++k) {
            const int j = threadIdx.x + k * mt::THREADS;
            if (j < nv) {
                pv[k] = p4[j];
                gv[k] = g4[j];
                tv[k] = trace ? t4[j] : make_float4(0.f, 0.f, 0.f, 0.f);
            }
        }
#pragma unroll
        for (int k = 0; k < mt::VEC; ++k) {
            const int j = threadIdx.x + k * mt::THREADS;
            if (j < nv) {
                sgd_four(pv[k], gv[k], tv[k], h, s);
                p4[j] = pv[k];
                if (trace) t4[j] = tv[k];
            }
        }
        tail = lo + 4LL * nv;
    }
    for (long long e = tail + threadIdx.x; e < hi; e += mt::THREADS) {
        float unused = 0.f;
        sgd_one(p[e], g[e], trace ? tr[e] : unused, h, s);
    }
}

template <int CAP>
int launch(const long long* rows, int leaves, const Hyper& h, const mt::Step& st,
           cudaStream_t stream) {
    mt::Table<3, CAP> t;   // the launch copies it by value
    if (!mt::fill(t, rows, leaves)) return (int)cudaErrorInvalidValue;
    if (h.flags & mt::TRACE)
        for (int i = 0; i < leaves; ++i)
            if (t.leaf[i].ptr[2] == 0) return (int)cudaErrorInvalidValue;
    const unsigned grid = t.chunks > 0 ? (unsigned)t.chunks : 1u;
    multi_sgd_kernel<CAP><<<grid, mt::THREADS, 0, stream>>>(t, h, st);
    return (int)cudaGetLastError();
}

}  // namespace

// rows: `leaves` rows of mt::Leaf<3> (p, g, trace or 0, n, first,
// aligned).  scal (the 4 scalars) or the sources: gnorm under flag 1,
// step_ptr or step_value.
extern "C" int zoo_multi_sgd(const long long* rows, int leaves, const float* scal,
                             const float* gnorm, const float* step_ptr, float step_value,
                             float clip_norm, float momentum, float wd, float lo, float hi,
                             int flags, void* stream) {
    if ((flags & mt::CLIP_SCALE) && scal == nullptr && gnorm == nullptr)
        return (int)cudaErrorInvalidValue;
    const Hyper h{momentum, wd, lo, hi, flags};
    const mt::Step st{scal,     nullptr, nullptr,    gnorm,
                      step_ptr, nullptr, step_value, clip_norm};
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (leaves <= mt::SMALL) return launch<mt::SMALL>(rows, leaves, h, st, s);
    return launch<mt::LARGE>(rows, leaves, h, st, s);
}
