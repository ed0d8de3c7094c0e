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
// an element) against ~20 flops, so device memory bounds it.
//
// Design: one warp per row (8 rows per 256-thread block).  Lanes stride
// the row with float4 loads where d % 4 == 0, else scalars.  Pass one
// sums for the mean, pass two sums the squared deviations (two-pass, as
// the reference), pass three writes; passes two and three re-read the
// row from L1/L2, so device memory still sees one read.  Warp shuffles
// reduce.

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

template <bool VEC>
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

    float s = 0.f;
    if (VEC) {
        for (int c = lane * 4; c < d; c += 128) {
            const float4 v = *reinterpret_cast<const float4*>(xr + c);
            s += (v.x + v.y) + (v.z + v.w);
        }
    } else {
        for (int c = lane; c < d; c += 32) s += xr[c];
    }
    const float mean = warp_sum(s) / (float)d;

    float ss = 0.f;
    if (VEC) {
        for (int c = lane * 4; c < d; c += 128) {
            const float4 v = *reinterpret_cast<const float4*>(xr + c);
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
        for (int c = lane * 4; c < d; c += 128) {
            const float4 v = *reinterpret_cast<const float4*>(xr + c);
            const float4 g = *reinterpret_cast<const float4*>(gamma + c);
            const float4 b = *reinterpret_cast<const float4*>(beta + c);
            float4 y;
            y.x = finish(v.x, mean, denom, g.x, b.x, act);
            y.y = finish(v.y, mean, denom, g.y, b.y, act);
            y.z = finish(v.z, mean, denom, g.z, b.z, act);
            y.w = finish(v.w, mean, denom, g.w, b.w, act);
            *reinterpret_cast<float4*>(orow + c) = y;
        }
    } else {
        for (int c = lane; c < d; c += 32)
            orow[c] = finish(xr[c], mean, denom, gamma[c], beta[c], act);
    }
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
    if (d % 4 == 0 && aligned)
        layernorm_act_kernel<true><<<blocks, NTHREADS, 0, s>>>(
            x, gamma, beta, out, rows, d, eps, act);
    else
        layernorm_act_kernel<false><<<blocks, NTHREADS, 0, s>>>(
            x, gamma, beta, out, rows, d, eps, act);
    return (int)cudaGetLastError();
}
