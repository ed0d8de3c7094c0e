// Multi-tensor launch of the fused optimizer updates (fused_adam.cu,
// fused_sgd.cu): one launch updates every float32 leaf of a step.
//
// The leaf table.  Each row holds one leaf's NPTR pointers (Adam: p, g, m,
// v; SGD: p, g, trace or 0), its element count, its first chunk in a
// prefix over fixed-size chunks of CHUNK elements, and whether all of its
// pointers are 16-byte aligned.  analytics_zoo_torch/ops/multi_tensor.py
// builds the rows (int64, in this order) and mirrors CHUNK and LARGE; the
// host entry checks them and copies them into a Table.
//
// How the table reaches the kernel: by value, as a kernel parameter.
// CUDA 12.1 and later take 32,764 bytes of parameters on sm_70 and up, so
// a table of LARGE leaves (56 bytes a leaf for Adam) goes with the launch:
// no host-to-device copy, no sync.  CUDA copies a kernel's whole
// parameter block at every launch, so a table of at most SMALL leaves
// takes an instantiation whose parameters fit in 4 KB.
//
// Work a block: one chunk of one leaf.  The block finds its leaf by binary
// search over the prefix.  Where the leaf is aligned the chunk moves
// float4s (CHUNK / 4 / THREADS of them a thread, all loads issued before
// any arithmetic); otherwise it takes the scalar path.  The leaf's last
// chunk takes its n % 4 tail on the scalar path.
//
// The step's scalars.  The one-leaf entry gives them in a 4-float device
// buffer [clip_scale, step_size, bc1, bc2].  The multi-tensor update
// gives the sources instead and every block computes them the way the
// plain PyTorch version does (ops/fused.py), so they agree bit for bit:
//   count_inc  = count < INT32_MAX ? count + 1 : count   (safe_increment)
//   bc         = 1 - powf(b, (float)count_inc)            (1 - b ** count)
//   clip_scale = clamp((1 / (gnorm + 1e-12)) * a, max=1)  (a / t is
//                t.reciprocal() * a in PyTorch; a NaN norm stays NaN)
//   step_size  = *step_ptr (a schedule's 0-dim tensor) or step_value.
// Block 0 writes count_inc to count_out.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#if CUDART_VERSION < 12010
#error "the multi-tensor tables need CUDA 12.1 or later (kernel parameters above 4 KB)"
#endif

namespace mt {

constexpr int CHUNK = 2048;                  // elements a block takes
constexpr int THREADS = 256;
constexpr int VEC = CHUNK / 4 / THREADS;     // float4s a thread takes
constexpr int SMALL = 64;                    // leaves whose table fits in 4 KB
constexpr int LARGE = 512;                   // leaves a launch takes at most

constexpr int CLIP_SCALE = 1, CLIP_CONST = 2, WEIGHT_DECAY = 4, NESTEROV = 8,
              TRACE = 16;

template <int NPTR>
struct Leaf {
    long long ptr[NPTR];
    long long n;
    long long first;      // the leaf's first chunk in this launch
    long long aligned;    // 1: every pointer of the leaf 16-byte aligned
};

template <int NPTR, int CAP>
struct Table {
    long long leaves;
    long long chunks;
    Leaf<NPTR> leaf[CAP];
};

struct Step {
    const float* scal;      // one-leaf entry: the 4 scalars; else null
    const int* count;       // Adam's count before the step; null for SGD
    int* count_out;         // the count after the step (block 0 writes it)
    const float* gnorm;     // the global gradient norm (flag CLIP_SCALE)
    const float* step_ptr;  // a schedule's step size; null: step_value
    float* scal_out;        // when given, block 0 writes the 4 scalars here
    float step_value;       // a constant step size (the negative lr)
    float clip_norm;        // the l2-norm clip's bound
};

struct Scalars {
    float clip_scale, step, bc1, bc2;
};

__device__ __forceinline__ float clip(float g, float lo, float hi) {
    // jnp.clip / torch.clamp: a NaN stays NaN
    return g < lo ? lo : (g > hi ? hi : g);
}

__device__ __forceinline__ Scalars load_scalars(const Step& s, int flags, float b1,
                                                float b2) {
    Scalars r;
    const bool first = blockIdx.x == 0 && threadIdx.x == 0;
    if (s.scal != nullptr) {
        r = Scalars{s.scal[0], s.scal[1], s.scal[2], s.scal[3]};
    } else {
        r.clip_scale = 1.0f;
        if (flags & CLIP_SCALE) {
            const float inv = __fdiv_rn(1.0f, __fadd_rn(*s.gnorm, (float)1e-12));
            const float c = __fmul_rn(inv, s.clip_norm);
            r.clip_scale = c > 1.0f ? 1.0f : c;   // not fminf: NaN stays NaN
        }
        r.step = s.step_ptr != nullptr ? *s.step_ptr : s.step_value;
        r.bc1 = r.bc2 = 1.0f;
        if (s.count != nullptr) {
            const int c = *s.count;
            const int inc = c < INT_MAX ? c + 1 : c;
            r.bc1 = __fsub_rn(1.0f, powf(b1, (float)inc));
            r.bc2 = __fsub_rn(1.0f, powf(b2, (float)inc));
            if (first) *s.count_out = inc;
        }
    }
    if (first && s.scal_out != nullptr) {
        s.scal_out[0] = r.clip_scale;
        s.scal_out[1] = r.step;
        s.scal_out[2] = r.bc1;
        s.scal_out[3] = r.bc2;
    }
    return r;
}

// The last leaf whose first chunk is at most c (the table holds no empty
// leaf, so that leaf holds chunk c).
template <int NPTR, int CAP>
__device__ __forceinline__ int find_leaf(const Table<NPTR, CAP>& t, long long c) {
    int a = 0, b = (int)t.leaves - 1;
    while (a < b) {
        const int mid = (a + b + 1) >> 1;
        if (t.leaf[mid].first <= c) a = mid;
        else b = mid - 1;
    }
    return a;
}

// Copy `leaves` host rows into `t` and check them: a non-empty leaf, the
// prefix over chunks, the alignment flag against the pointers.  Returns
// false on a row the kernel must not take.
template <int NPTR, int CAP>
bool fill(Table<NPTR, CAP>& t, const long long* rows, int leaves) {
    if (leaves < 0 || leaves > CAP) return false;
    if (leaves > 0) memcpy(t.leaf, rows, sizeof(Leaf<NPTR>) * (size_t)leaves);
    t.leaves = leaves;
    long long next = 0;
    for (int i = 0; i < leaves; ++i) {
        const Leaf<NPTR>& l = t.leaf[i];
        if (l.n <= 0 || l.first != next || l.ptr[0] == 0 || l.ptr[1] == 0) return false;
        uintptr_t bits = 0;
        for (int k = 0; k < NPTR; ++k) bits |= (uintptr_t)l.ptr[k];
        if (l.aligned != 0 && ((bits & 15) != 0 || l.aligned != 1)) return false;
        next += (l.n + CHUNK - 1) / CHUNK;
    }
    if (next > INT_MAX) return false;
    t.chunks = next;
    return true;
}

}  // namespace mt
