// Fused bias-add -> tanh-GeLU epilogue, float32, for Hopper (sm_90a).
//
// Replaces: analytics_zoo_tpu/ops/fused.py::_bias_gelu_kernel
//           (launched from bias_gelu).
//
// Computes out[r, c] = gelu_tanh(x[r, c] + bias[c]) in the order of
// jax.nn.gelu(approximate=True):
//   u = x + b;  out = u * (0.5 * (1 + tanhf(sqrt(2/pi) * (u + 0.044715 * u^3))))
//
// What bounds it on the H100: one read of x and one write of out (8 bytes
// an element) against a few dozen flops, so device memory (3.35 TB/s)
// bounds it.
//
// Design: a grid-stride elementwise pass.  Where d % 4 == 0 (and the
// pointers are 16-byte aligned) each thread moves float4s, so a warp
// reads 512 contiguous bytes; the bias row stays in L1/L2.  Otherwise a
// scalar pass does the same work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;

// Each step rounds on its own (no fused multiply-add contraction), so the
// result repeats the plain version's elementwise ops bit for bit.
__device__ __forceinline__ float gelu_tanh(float u) {
    const float c = 0.7978845608028654f;   // sqrt(2/pi) rounded to float32
    const float u3 = __fmul_rn(__fmul_rn(u, u), u);
    const float inner = __fadd_rn(u, __fmul_rn(0.044715f, u3));
    const float cdf = __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(__fmul_rn(c, inner))));
    return __fmul_rn(u, cdf);
}

__global__ void bias_gelu_vec4(const float4* __restrict__ x,
                               const float4* __restrict__ bias,
                               float4* __restrict__ out, long long n4, int d4) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
         i += (long long)gridDim.x * blockDim.x) {
        const float4 xv = x[i];
        const float4 bv = bias[i % d4];
        float4 r;
        r.x = gelu_tanh(__fadd_rn(xv.x, bv.x));
        r.y = gelu_tanh(__fadd_rn(xv.y, bv.y));
        r.z = gelu_tanh(__fadd_rn(xv.z, bv.z));
        r.w = gelu_tanh(__fadd_rn(xv.w, bv.w));
        out[i] = r;
    }
}

__global__ void bias_gelu_scalar(const float* __restrict__ x,
                                 const float* __restrict__ bias,
                                 float* __restrict__ out, long long n, int d) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x)
        out[i] = gelu_tanh(__fadd_rn(x[i], bias[i % d]));
}

int grid_for(long long work) {
    long long blocks = (work + NTHREADS - 1) / NTHREADS;
    const long long cap = 132LL * 16;   // 16 resident blocks on each of 132 SMs
    if (blocks > cap) blocks = cap;
    return (int)(blocks > 0 ? blocks : 1);
}

}  // namespace

extern "C" int zoo_bias_gelu(const float* x, const float* bias, float* out,
                             int rows, int d, void* stream) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const long long n = (long long)rows * d;
    if (n <= 0) return (int)cudaSuccess;
    const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                           reinterpret_cast<uintptr_t>(bias) |
                           reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    if (d % 4 == 0 && aligned) {
        const long long n4 = n / 4;
        bias_gelu_vec4<<<grid_for(n4), NTHREADS, 0, s>>>(
            reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(bias),
            reinterpret_cast<float4*>(out), n4, d / 4);
    } else {
        bias_gelu_scalar<<<grid_for(n), NTHREADS, 0, s>>>(x, bias, out, n, d);
    }
    return (int)cudaGetLastError();
}
