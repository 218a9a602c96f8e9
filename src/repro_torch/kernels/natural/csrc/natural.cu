// Shifted natural compression for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of the reference package:
//   shifted_natural_kernel  <- src/repro/kernels/natural/kernel.py
//                              shifted_natural_2d (body _shifted_natural_kernel)
//
// out = h + C_nat(g - h), elementwise: C_nat rounds |g - h| to the power
// of two below it or, with probability equal to the mantissa's fraction,
// to the one above (the uniform u decides), keeping the sign.
//
// The function is one pass and memory-bound: per element it reads g, h
// (4 bytes each in f32, 2 in bf16) and u (4 bytes) and writes out, about
// 15 operations against 16 bytes in f32 -- far below the card's ratio of
// operations to bytes.  So the design is about bytes: one thread per 4
// elements, 16-byte loads of g, h, u and a 16-byte store in f32 (8-byte
// ones for bf16 g, h, out), a grid-stride loop over the whole (rows, 128)
// array.  The reference's row tile (block_rows) has no meaning here: the
// result depends only on the element.
//
// Bitwise contract with the plain PyTorch version (ref.py):
//   * f32 arithmetic, bf16 widened exactly on load and rounded to nearest
//     even on store (__float2bfloat16_rn, as torch's .to(bfloat16));
//   * subnormal g, h, g - h and out are flushed to zero of their sign,
//     explicitly (ftz below), as XLA on the CPU flushes them when it runs
//     the reference.  The library is built WITHOUT -ftz=true, which would
//     also flush inside the other kernels;
//   * the exponent and 2^e come from the float's bits, and p_up = a/2^e - 1
//     is the mantissa's fraction -- all exact, no log2/exp2;
//   * h + q is one IEEE add (__fadd_rn: nothing to contract);
//   * NaN and +-inf propagate: a NaN difference gives NaN, an infinite
//     one +-inf, and 2^(e+1) past the largest float is inf.
//
// Each entry returns cudaGetLastError() after its launch; the Python
// wrapper raises when that is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kThreads = 256;
constexpr float kTiny = 1.17549435e-38f;  // 2^-126, the smallest normal f32

__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < kTiny ? copysignf(0.0f, v) : v;
}

__device__ __forceinline__ float natural_one(float g, float h, float u) {
  g = ftz(g);
  h = ftz(h);
  const float x = ftz(__fsub_rn(g, h));
  const float a = fabsf(x);
  float q;
  if (a == 0.0f) {
    q = 0.0f;
  } else if (!isfinite(a)) {
    q = a;  // inf stays inf, NaN stays NaN
  } else {
    const unsigned int bits = __float_as_uint(a);
    const float lo = __uint_as_float(bits & 0xff800000u);            // 2^e
    const float p_up =
        __fsub_rn(__uint_as_float((bits & 0x007fffffu) | 0x3f800000u), 1.0f);
    q = (u < p_up) ? __fmul_rn(lo, 2.0f) : lo;
  }
  return ftz(__fadd_rn(h, copysignf(q, x)));
}

__global__ void __launch_bounds__(kThreads)
natural_f32_kernel(const float4* __restrict__ g, const float4* __restrict__ h,
                   const float4* __restrict__ u, float4* __restrict__ out,
                   int64_t n_vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_vec; i += stride) {
    const float4 gv = g[i];
    const float4 hv = h[i];
    const float4 uv = u[i];
    float4 o;
    o.x = natural_one(gv.x, hv.x, uv.x);
    o.y = natural_one(gv.y, hv.y, uv.y);
    o.z = natural_one(gv.z, hv.z, uv.z);
    o.w = natural_one(gv.w, hv.w, uv.w);
    out[i] = o;
  }
}

// bf16 g, h, out: 4 elements (8 bytes) per thread, u still f32.
__global__ void __launch_bounds__(kThreads)
natural_bf16_kernel(const uint2* __restrict__ g, const uint2* __restrict__ h,
                    const float4* __restrict__ u, uint2* __restrict__ out,
                    int64_t n_vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_vec; i += stride) {
    const uint2 graw = g[i];
    const uint2 hraw = h[i];
    const float4 uv = u[i];
    const float2 g01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&graw.x));
    const float2 g23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&graw.y));
    const float2 h01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hraw.x));
    const float2 h23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hraw.y));
    const __nv_bfloat162 o01 = __floats2bfloat162_rn(
        natural_one(g01.x, h01.x, uv.x), natural_one(g01.y, h01.y, uv.y));
    const __nv_bfloat162 o23 = __floats2bfloat162_rn(
        natural_one(g23.x, h23.x, uv.z), natural_one(g23.y, h23.y, uv.w));
    uint2 o;
    o.x = *reinterpret_cast<const unsigned int*>(&o01);
    o.y = *reinterpret_cast<const unsigned int*>(&o23);
    out[i] = o;
  }
}

int grid_for(int64_t n_vec) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n_vec + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 16;  // 16 blocks of 256 per SM
  return static_cast<int>(want < cap ? want : cap);
}

}  // namespace

extern "C" {

// g, h, out: (rows, 128) f32 (bf16 = 0) or bf16 (bf16 = 1); u: (rows, 128) f32.
int shifted_natural_2d(const void* g, const void* h, const void* u, void* out,
                       long long rows, int bf16, void* stream) {
  const int64_t n_vec = static_cast<int64_t>(rows) * (kLane / 4);
  const int grid = grid_for(n_vec);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    natural_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint2*>(g), static_cast<const uint2*>(h),
        static_cast<const float4*>(u), static_cast<uint2*>(out), n_vec);
  } else {
    natural_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float4*>(g), static_cast<const float4*>(h),
        static_cast<const float4*>(u), static_cast<float4*>(out), n_vec);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* natural_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
