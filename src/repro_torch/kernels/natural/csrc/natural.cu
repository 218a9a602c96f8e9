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
// natural_message (no reference kernel: the port's own, for the round):
// m = decode(encode(g - h)) of the plain NaturalCompression codec
// (core/compressors.py), one worker's row of DIANA's message Q(g - h),
// elementwise and bit for bit the codec's round trip with the same u:
//   * x = g - h as the plain path subtracts: g and h NOT flushed first,
//     one IEEE subtraction in f32 (bf16 g, h: widened exactly, the
//     difference rounded to nearest even to bf16, as torch's bf16 `g - h`),
//     then x flushed (the codec's ftz);
//   * the codec's floor a = max(|x|, 2^-126) (TINY), e and p_hi read from
//     the bits of a, the element rounds up where u < p_hi; the code e + up
//     decodes to copysign(2^code, x), and code 128 (2^127 rounded up) to
//     +-inf (the decode's `code > 127 -> inf`);
//   * x == +-0 gives +0 (sign(x) = 0: 0 * 2^-126); NaN gives +0
//     (nan_to_num: code 0, sign 0); +-inf gives +-inf (code 32767, clamped
//     to 128).
// It reads g, h (4 bytes each in f32, 2 in bf16) and u (4) and writes the
// message once: 16 bytes an element in f32.  A worker's row of a W-stacked
// leaf need not start 16-byte aligned, so the host picks a head of 0-3
// elements after which g, h, u and out are all aligned for 16-byte (f32;
// 8-byte bf16 g, h, out) vector accesses, done one element a thread like
// the tail; where no such head exists (rows misaligned against u) every
// element goes the scalar way.  The vector loop keeps kUnroll vectors of
// each input in flight per thread, with streaming cache hints (each byte
// is read or written once).  On qwen3's embedding leaf (155,582,464
// elements, H100 80GB HBM3) an unroll of 1, 2, 4 or 8 runs within 0.6% of
// 0.86 ms, 86% of the 0.743 ms bound; a plain copy (8 bytes an element)
// reaches 89%.
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

// -- natural_message --------------------------------------------------------

constexpr int kUnroll = 2;
constexpr unsigned int kInfBits = 0x7f800000u;

// One element of decode(encode(x)), x the (rounded) difference g - h, with
// the codec's special cases written out from its own lines.
__device__ __forceinline__ float message_one(float x, float u) {
  x = ftz(x);                                   // xf = ftz(x)
  if (isnan(x)) return 0.0f;                    // nan_to_num: code 0, sign 0
  if (x == 0.0f) return 0.0f;                   // sign(+-0) = 0: +0
  if (isinf(x)) return x;                       // code 32767 -> 128: +-inf
  const float a = fmaxf(fabsf(x), kTiny);       // clamp_min(|xf|, TINY)
  const unsigned int bits = __float_as_uint(a);
  const int e = static_cast<int>(bits >> 23) - 127;
  const float p_hi =
      __fsub_rn(__uint_as_float((bits & 0x007fffffu) | 0x3f800000u), 1.0f);
  const int code = e + ((u < p_hi) ? 1 : 0);
  const float mag = code > 127
      ? __uint_as_float(kInfBits)
      : __uint_as_float(static_cast<unsigned int>(code + 127) << 23);
  return copysignf(mag, x);                     // sign(xf) * mag
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned int b16) {
  return __uint_as_float(b16 << 16);
}

__device__ __forceinline__ unsigned int float_to_bf16_bits(float v) {
  return static_cast<unsigned int>(
      __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// g - h as the plain path computes it, in f32 or through bf16.
__device__ __forceinline__ float diff_f32(float g, float h) {
  return __fsub_rn(g, h);
}

__device__ __forceinline__ float diff_bf16(unsigned int g16, unsigned int h16) {
  const float d = __fsub_rn(bf16_bits_to_float(g16), bf16_bits_to_float(h16));
  return bf16_bits_to_float(float_to_bf16_bits(d));
}

// Elements [0, head) and [tail, n), one a thread, grid-stride.
__device__ __forceinline__ int64_t scalar_index(int64_t s, int64_t head,
                                                int64_t tail) {
  return s < head ? s : tail + (s - head);
}

__global__ void __launch_bounds__(kThreads)
message_f32_kernel(const float* __restrict__ g, const float* __restrict__ h,
                   const float* __restrict__ u, float* __restrict__ out,
                   int64_t n, int64_t head, int64_t n_vec) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tail = head + 4 * n_vec;
  const int64_t n_scalar = head + (n - tail);
  for (int64_t s = tid; s < n_scalar; s += stride) {
    const int64_t i = scalar_index(s, head, tail);
    __stcs(out + i, message_one(diff_f32(__ldcs(g + i), __ldcs(h + i)),
                                __ldcs(u + i)));
  }
  const float4* gv = reinterpret_cast<const float4*>(g + head);
  const float4* hv = reinterpret_cast<const float4*>(h + head);
  const float4* uv = reinterpret_cast<const float4*>(u + head);
  float4* ov = reinterpret_cast<float4*>(out + head);
  for (int64_t base = tid; base < n_vec; base += stride * kUnroll) {
    float4 ga[kUnroll], ha[kUnroll], ua[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = base + k * stride;
      if (i < n_vec) {
        ga[k] = __ldcs(gv + i);
        ha[k] = __ldcs(hv + i);
        ua[k] = __ldcs(uv + i);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = base + k * stride;
      if (i < n_vec) {
        float4 o;
        o.x = message_one(diff_f32(ga[k].x, ha[k].x), ua[k].x);
        o.y = message_one(diff_f32(ga[k].y, ha[k].y), ua[k].y);
        o.z = message_one(diff_f32(ga[k].z, ha[k].z), ua[k].z);
        o.w = message_one(diff_f32(ga[k].w, ha[k].w), ua[k].w);
        __stcs(ov + i, o);
      }
    }
  }
}

__device__ __forceinline__ unsigned int message_pair(unsigned int g2,
                                                     unsigned int h2,
                                                     float u0, float u1) {
  const float lo = message_one(diff_bf16(g2 & 0xffffu, h2 & 0xffffu), u0);
  const float hi = message_one(diff_bf16(g2 >> 16, h2 >> 16), u1);
  return float_to_bf16_bits(lo) | (float_to_bf16_bits(hi) << 16);
}

// bf16 g, h, out (4 elements = 8 bytes a vector), u f32.
__global__ void __launch_bounds__(kThreads)
message_bf16_kernel(const unsigned short* __restrict__ g,
                    const unsigned short* __restrict__ h,
                    const float* __restrict__ u,
                    unsigned short* __restrict__ out,
                    int64_t n, int64_t head, int64_t n_vec) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tail = head + 4 * n_vec;
  const int64_t n_scalar = head + (n - tail);
  for (int64_t s = tid; s < n_scalar; s += stride) {
    const int64_t i = scalar_index(s, head, tail);
    const float m = message_one(diff_bf16(__ldcs(g + i), __ldcs(h + i)),
                                __ldcs(u + i));
    __stcs(out + i, static_cast<unsigned short>(float_to_bf16_bits(m)));
  }
  const uint2* gv = reinterpret_cast<const uint2*>(g + head);
  const uint2* hv = reinterpret_cast<const uint2*>(h + head);
  const float4* uv = reinterpret_cast<const float4*>(u + head);
  uint2* ov = reinterpret_cast<uint2*>(out + head);
  for (int64_t base = tid; base < n_vec; base += stride * kUnroll) {
    uint2 ga[kUnroll], ha[kUnroll];
    float4 ua[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = base + k * stride;
      if (i < n_vec) {
        ga[k] = __ldcs(gv + i);
        ha[k] = __ldcs(hv + i);
        ua[k] = __ldcs(uv + i);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = base + k * stride;
      if (i < n_vec) {
        uint2 o;
        o.x = message_pair(ga[k].x, ha[k].x, ua[k].x, ua[k].y);
        o.y = message_pair(ga[k].y, ha[k].y, ua[k].z, ua[k].w);
        __stcs(ov + i, o);
      }
    }
  }
}

// The head (0-3 elements) after which g, h, out (vec_bytes apart a vector)
// and u (16) are all aligned; -1 where there is none.
int aligned_head(const void* g, const void* h, const void* u, const void* out,
                 int elem_bytes) {
  const int vec_bytes = 4 * elem_bytes;
  for (int k = 0; k < 4; ++k) {
    const uintptr_t off = static_cast<uintptr_t>(k) * elem_bytes;
    if ((reinterpret_cast<uintptr_t>(g) + off) % vec_bytes == 0 &&
        (reinterpret_cast<uintptr_t>(h) + off) % vec_bytes == 0 &&
        (reinterpret_cast<uintptr_t>(out) + off) % vec_bytes == 0 &&
        (reinterpret_cast<uintptr_t>(u) + 4 * k) % 16 == 0) {
      return k;
    }
  }
  return -1;
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

// g, h, out: n elements, f32 (bf16 = 0) or bf16 (bf16 = 1), any alignment
// of their element type; u: n f32.  out = decode(encode(g - h)) of the
// natural codec with the uniforms u.
int natural_message(const void* g, const void* h, const void* u, void* out,
                    long long n, int bf16, void* stream) {
  if (n <= 0) return 0;
  const int elem = bf16 ? 2 : 4;
  const int found = aligned_head(g, h, u, out, elem);
  int64_t head = found < 0 ? n : (found < n ? found : n);
  const int64_t n_vec = (n - head) / 4;
  const int64_t n_scalar = head + (n - head - 4 * n_vec);
  const int64_t work = (n_vec + kUnroll - 1) / kUnroll;
  const int grid = grid_for(work > n_scalar ? work : n_scalar);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    message_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const unsigned short*>(g),
        static_cast<const unsigned short*>(h), static_cast<const float*>(u),
        static_cast<unsigned short*>(out), n, head, n_vec);
  } else {
    message_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(h),
        static_cast<const float*>(u), static_cast<float*>(out), n, head,
        n_vec);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* natural_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
