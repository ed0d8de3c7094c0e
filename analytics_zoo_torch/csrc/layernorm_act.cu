// Fused LayerNorm -> activation, float32, for Hopper (sm_90a).
//
// Replaces: analytics_zoo_tpu/ops/fused.py::_layernorm_act_kernel
//           (launched from layernorm_act).
//
// Computes, for each row x of a (rows, d) matrix:
//   mean = sum(x) / d;  var = sum((x - mean)^2) / d      (biased, as jnp.var)
//   y = (x - mean) / sqrtf(var + eps) * gamma + beta
//   y = gelu_tanh(y) when act == 1 (the reference's lax order: the affine
//   result first, then the activation)
//
// What bounds it on the H100: one read of x and one write of y (8 bytes
// an element) against ~20 flops, so device memory bounds it at many rows.
// At the serving shape (8, 768) the kernel is one block on one SM, and its
// time is dependent latency: the launch, one round trip to device memory,
// two warp reductions and the stores.
//
// Design: one warp per row (8 rows per 256-thread block).  Where a row
// fits in registers (d % 4 == 0, 16-byte aligned, d <= 4096), each lane
// loads its share of the row once, as V float4s (V = ceil(d / 128), a
// template argument the launch picks at run time), every load issued
// before the first use, and gamma and beta with them where V <= 8; the
// mean and then the squared deviations (two-pass, as the reference) are
// summed from those registers and reduced with warp shuffles, and the row
// is written.  Wider or unaligned rows take the looped branch of the same
// kernel: lanes stride the row with float4 loads where d % 4 == 0, else
// scalars, in three passes (mean, squared deviations, write), passes two
// and three re-reading the row from L1/L2.  The register path and the
// looped float4 branch sum in the same order and give the same result.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int ROWS_PER_BLOCK = NTHREADS / 32;

// Each step rounds on its own (no fused multiply-add contraction), so the
// result repeats the plain version's elementwise ops bit for bit.
__device__ __forceinline__ float gelu_tanh(float u) {
    const float c = 0.7978845608028654f;   // sqrt(2/pi) rounded to float32
    const float u3 = __fmul_rn(__fmul_rn(u, u), u);
    const float inner = __fadd_rn(u, __fmul_rn(0.044715f, u3));
    const float cdf = __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(__fmul_rn(c, inner))));
    return __fmul_rn(u, cdf);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ float finish(float xv, float mean, float denom,
                                        float g, float b, int act) {
    const float y = __fadd_rn(__fmul_rn(__fdiv_rn(__fsub_rn(xv, mean), denom), g), b);
    return act ? gelu_tanh(y) : y;
}

__device__ __forceinline__ float4 finish4(float4 x, float mean, float denom,
                                          float4 g, float4 b, int act) {
    return make_float4(finish(x.x, mean, denom, g.x, b.x, act),
                       finish(x.y, mean, denom, g.y, b.y, act),
                       finish(x.z, mean, denom, g.z, b.z, act),
                       finish(x.w, mean, denom, g.w, b.w, act));
}

__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

// One row from registers: lane l holds columns 4l + 128i .. +3, i < V.
template <int V>
__device__ __forceinline__ void row_in_registers(const float* __restrict__ xr,
                                                 const float* __restrict__ gamma,
                                                 const float* __restrict__ beta,
                                                 float* __restrict__ orow, int d,
                                                 float eps, int act, int lane) {
    constexpr bool EARLY = V <= 8;                 // gamma and beta loaded with x
    float4 xv[V], gv[EARLY ? V : 1], bv[EARLY ? V : 1];
#pragma unroll
    for (int i = 0; i < V; ++i) {
        const int c = lane * 4 + 128 * i;
        if (c < d) {
            xv[i] = load4(xr + c);
            if constexpr (EARLY) {
                gv[i] = load4(gamma + c);
                bv[i] = load4(beta + c);
            }
        }
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i)
        if (lane * 4 + 128 * i < d) s += (xv[i].x + xv[i].y) + (xv[i].z + xv[i].w);
    const float mean = warp_sum(s) / (float)d;

    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
        if (lane * 4 + 128 * i < d) {
            const float a = xv[i].x - mean, b = xv[i].y - mean;
            const float e = xv[i].z - mean, f = xv[i].w - mean;
            ss += (a * a + b * b) + (e * e + f * f);
        }
    }
    const float var = warp_sum(ss) / (float)d;
    const float denom = sqrtf(var + eps);

#pragma unroll
    for (int i = 0; i < V; ++i) {
        const int c = lane * 4 + 128 * i;
        if (c < d) {
            float4 g, b;
            if constexpr (EARLY) {
                g = gv[i];
                b = bv[i];
            } else {
                g = load4(gamma + c);
                b = load4(beta + c);
            }
            *reinterpret_cast<float4*>(orow + c) = finish4(xv[i], mean, denom, g, b, act);
        }
    }
}

// One row in three looped passes: float4 loads (VEC) or scalars.
template <bool VEC>
__device__ __forceinline__ void row_looped(const float* __restrict__ xr,
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ beta,
                                           float* __restrict__ orow, int d,
                                           float eps, int act, int lane) {
    float s = 0.f;
    if (VEC) {
        for (int c = lane * 4; c < d; c += 128) {
            const float4 v = load4(xr + c);
            s += (v.x + v.y) + (v.z + v.w);
        }
    } else {
        for (int c = lane; c < d; c += 32) s += xr[c];
    }
    const float mean = warp_sum(s) / (float)d;

    float ss = 0.f;
    if (VEC) {
        for (int c = lane * 4; c < d; c += 128) {
            const float4 v = load4(xr + c);
            const float a = v.x - mean, b = v.y - mean, e = v.z - mean, f = v.w - mean;
            ss += (a * a + b * b) + (e * e + f * f);
        }
    } else {
        for (int c = lane; c < d; c += 32) {
            const float a = xr[c] - mean;
            ss += a * a;
        }
    }
    const float var = warp_sum(ss) / (float)d;
    const float denom = sqrtf(var + eps);

    if (VEC) {
        for (int c = lane * 4; c < d; c += 128)
            *reinterpret_cast<float4*>(orow + c) =
                finish4(load4(xr + c), mean, denom, load4(gamma + c), load4(beta + c), act);
    } else {
        for (int c = lane; c < d; c += 32)
            orow[c] = finish(xr[c], mean, denom, gamma[c], beta[c], act);
    }
}

// V > 0: the row in registers, V float4s a lane; V == 0: the looped float4
// branch; V < 0: the looped scalar branch
template <int V>
__global__ void layernorm_act_kernel(const float* __restrict__ x,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta,
                                     float* __restrict__ out, int rows, int d,
                                     float eps, int act) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
    if (row >= rows) return;   // whole warp leaves together
    const float* xr = x + (size_t)row * d;
    float* orow = out + (size_t)row * d;
    if constexpr (V > 0)
        row_in_registers<V>(xr, gamma, beta, orow, d, eps, act, lane);
    else
        row_looped<V == 0>(xr, gamma, beta, orow, d, eps, act, lane);
}

template <int V>
void launch(int blocks, cudaStream_t s, const float* x, const float* gamma,
            const float* beta, float* out, int rows, int d, float eps, int act) {
    layernorm_act_kernel<V><<<blocks, NTHREADS, 0, s>>>(x, gamma, beta, out, rows, d,
                                                        eps, act);
}

}  // namespace

extern "C" int zoo_layernorm_act(const float* x, const float* gamma,
                                 const float* beta, float* out, int rows,
                                 int d, float eps, int act, void* stream) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (rows <= 0 || d <= 0) return (int)cudaSuccess;
    const int blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                           reinterpret_cast<uintptr_t>(gamma) |
                           reinterpret_cast<uintptr_t>(beta) |
                           reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    if (d % 4 != 0 || !aligned) {
        launch<-1>(blocks, s, x, gamma, beta, out, rows, d, eps, act);
        return (int)cudaGetLastError();
    }
    // the float4s a lane holds: the smallest instantiated count >= d / 128
    const int v = (d + 127) / 128;
    if (v <= 8) {
        switch (v) {
            case 1: launch<1>(blocks, s, x, gamma, beta, out, rows, d, eps, act); break;
            case 2: launch<2>(blocks, s, x, gamma, beta, out, rows, d, eps, act); break;
            case 3: launch<3>(blocks, s, x, gamma, beta, out, rows, d, eps, act); break;
            case 4: launch<4>(blocks, s, x, gamma, beta, out, rows, d, eps, act); break;
            case 5: launch<5>(blocks, s, x, gamma, beta, out, rows, d, eps, act); break;
            case 6: launch<6>(blocks, s, x, gamma, beta, out, rows, d, eps, act); break;
            case 7: launch<7>(blocks, s, x, gamma, beta, out, rows, d, eps, act); break;
            default: launch<8>(blocks, s, x, gamma, beta, out, rows, d, eps, act); break;
        }
    } else if (v <= 12) {
        launch<12>(blocks, s, x, gamma, beta, out, rows, d, eps, act);
    } else if (v <= 16) {
        launch<16>(blocks, s, x, gamma, beta, out, rows, d, eps, act);
    } else if (v <= 24) {
        launch<24>(blocks, s, x, gamma, beta, out, rows, d, eps, act);
    } else if (v <= 32) {
        launch<32>(blocks, s, x, gamma, beta, out, rows, d, eps, act);
    } else {
        launch<0>(blocks, s, x, gamma, beta, out, rows, d, eps, act);
    }
    return (int)cudaGetLastError();
}
