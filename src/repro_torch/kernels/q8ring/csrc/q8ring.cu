// Blockwise int8 codec kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of the reference package:
//   q8_quantize_kernel        <- src/repro/kernels/q8ring/kernel.py
//                                q8_quantize_2d (body _q8_quantize_kernel)
//   q8_quantize_chunk_kernel  <- src/repro/kernels/q8ring/kernel.py
//                                q8_quantize_chunk_3d (body _q8_chunk_kernel)
//   q8_dequant_add_kernel     <- src/repro/kernels/q8ring/kernel.py
//                                q8_dequant_add_2d (body _q8_dequant_add_kernel)
//
// All three are memory-bound: a handful of operations per element against
//   quantize:     9 bytes per element (4 of x, 4 of u, 1 of q), plus one
//                 f32 scale per tile -- the chunk variant reads x from one
//                 chunk of an (n, rows, 128) ring buffer, so the same;
//   dequant-add:  9 bytes per element (1 of q, 4 of acc, 4 of out), or 5
//                 without an accumulator (plain decode).
// So the design is about bytes: 16-byte loads of x/u/acc/out and 4-byte
// stores of q, one thread block per scale tile for the quantize (its
// max-|x| reduction never leaves the block), one element group per
// thread for the dequant.  The quantize reads its tile twice (max, then
// quantize); the second read comes from L1/L2, since a tile is at most
// 32 KiB at the default 64 rows.  Pipelining the loads (cp.async/TMA) is
// later work.
//
// The ring-hop variant takes its chunk id from DEVICE memory (on the TPU
// it arrives by scalar prefetch): every block loads it and offsets its
// loads by id * rows * 128, so no f32 copy of the chunk is made and the
// ring's precomputed id table costs no host-to-device copy per launch.
// Both quantize kernels run one tile body (quantize_tile), so their scale
// and rounding contract cannot drift apart.
//
// Bitwise contract with the plain PyTorch versions (ref.py):
//   * scale = max(max|x|, 1e-30) * f32(1/127): the reference writes
//     `/ 127` and XLA compiles division by that constant into a multiply
//     by its f32 reciprocal, which is what the reference computes;
//   * y = x / scale is an IEEE division: build WITHOUT --use_fast_math
//     (which makes `/` approximate and flushes denormals);
//   * the int8 convert saturates to [-128, 127] and maps NaN to 0, as
//     XLA's convert does; max|x| propagates NaN as jnp.max does;
//   * dequant-add is one rounding, __fmaf_rn(q, scale, acc) -- the
//     reference's interpreted kernel contracts acc + q * scale into an
//     FMA, and the plain version computes the correctly rounded fma.
//     Without an accumulator it is __fmul_rn(q, scale), which equals
//     fma(q, scale, +0) for every q since scale > 0.
//
// Each entry returns cudaGetLastError() after its launch; the Python
// wrapper raises when that is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kThreads = 256;
constexpr float kInvLevels = 1.0f / 127.0f;  // 0.00787401572f, as XLA folds it
constexpr float kScaleFloor = 1e-30f;

// NaN-propagating max (fmaxf drops NaN; jnp.max and torch.amax keep it)
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_nanmax(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float abs_max4(float4 v) {
  return nanmax(nanmax(fabsf(v.x), fabsf(v.y)), nanmax(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ signed char quantize_one(float x, float u, float scale) {
  const float y = x / scale;  // IEEE division
  const float lo = floorf(y);
  float q = lo + ((u < (y - lo)) ? 1.0f : 0.0f);
  if (q != q) q = 0.0f;
  q = fminf(fmaxf(q, -128.0f), 127.0f);
  return static_cast<signed char>(static_cast<int>(q));
}

// One (block_rows, 128) tile, run by the whole thread block: scale =
// max(max|x|, floor) * (1/127), then the stochastic round of x / scale.
// tile_vec = block_rows * 32 float4s.
__device__ __forceinline__ void quantize_tile(const float4* __restrict__ xt,
                                              const float4* __restrict__ ut,
                                              char4* __restrict__ qt,
                                              float* __restrict__ scale_out,
                                              int tile_vec) {
  float m = 0.0f;
  for (int i = threadIdx.x; i < tile_vec; i += kThreads) {
    m = nanmax(m, abs_max4(xt[i]));
  }
  __shared__ float warp_max[kThreads / 32];
  __shared__ float tile_scale;
  m = warp_nanmax(m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0.0f;
    v = warp_nanmax(v);
    if (threadIdx.x == 0) {
      const float scale = __fmul_rn(nanmax(v, kScaleFloor), kInvLevels);
      tile_scale = scale;
      *scale_out = scale;
    }
  }
  __syncthreads();
  const float scale = tile_scale;

  for (int i = threadIdx.x; i < tile_vec; i += kThreads) {
    const float4 xv = xt[i];
    const float4 uv = ut[i];
    char4 o;
    o.x = quantize_one(xv.x, uv.x, scale);
    o.y = quantize_one(xv.y, uv.y, scale);
    o.z = quantize_one(xv.z, uv.z, scale);
    o.w = quantize_one(xv.w, uv.w, scale);
    qt[i] = o;
  }
}

// One thread block per tile.
__global__ void __launch_bounds__(kThreads)
q8_quantize_kernel(const float4* __restrict__ x, const float4* __restrict__ u,
                   char4* __restrict__ q, float* __restrict__ scales,
                   int tile_vec) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile_vec;
  quantize_tile(x + base, u + base, q + base, scales + blockIdx.x, tile_vec);
}

// One thread block per tile of chunk *chunk_id of the (n, rows, 128) ring
// buffer; chunk_vec = rows * 32 float4s.  An id outside [0, n) reads
// nothing: its tiles get q = 0 and a NaN scale, so a bad id shows in the
// result instead of reading out of bounds (the plain version raises).
__global__ void __launch_bounds__(kThreads)
q8_quantize_chunk_kernel(const float4* __restrict__ chunks,
                         const float4* __restrict__ u,
                         const int* __restrict__ chunk_id,
                         char4* __restrict__ q, float* __restrict__ scales,
                         int n, int64_t chunk_vec, int tile_vec) {
  const int id = *chunk_id;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile_vec;
  if (id < 0 || id >= n) {
    for (int i = threadIdx.x; i < tile_vec; i += kThreads) {
      q[base + i] = make_char4(0, 0, 0, 0);
    }
    if (threadIdx.x == 0) scales[blockIdx.x] = __int_as_float(0x7fc00000);
    return;
  }
  quantize_tile(chunks + id * chunk_vec + base, u + base, q + base,
                scales + blockIdx.x, tile_vec);
}

// One group of 4 elements per thread; acc may be null (plain decode).
__global__ void __launch_bounds__(kThreads)
q8_dequant_add_kernel(const char4* __restrict__ q, const float* __restrict__ scales,
                      const float4* __restrict__ acc, float4* __restrict__ out,
                      int64_t n_vec, int tile_vec) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  const float s = scales[i / tile_vec];
  const char4 c = q[i];
  float4 o;
  if (acc != nullptr) {
    const float4 a = acc[i];
    o.x = __fmaf_rn(static_cast<float>(c.x), s, a.x);
    o.y = __fmaf_rn(static_cast<float>(c.y), s, a.y);
    o.z = __fmaf_rn(static_cast<float>(c.z), s, a.z);
    o.w = __fmaf_rn(static_cast<float>(c.w), s, a.w);
  } else {
    o.x = __fmul_rn(static_cast<float>(c.x), s);
    o.y = __fmul_rn(static_cast<float>(c.y), s);
    o.z = __fmul_rn(static_cast<float>(c.z), s);
    o.w = __fmul_rn(static_cast<float>(c.w), s);
  }
  out[i] = o;
}

}  // namespace

extern "C" {

// x, u: (rows, 128) f32; q: (rows, 128) int8; scales: (rows / block_rows) f32.
int q8_quantize_2d(const void* x, const void* u, void* q, void* scales,
                   long long rows, int block_rows, void* stream) {
  const long long tiles = rows / block_rows;
  q8_quantize_kernel<<<static_cast<unsigned int>(tiles), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(u),
      static_cast<char4*>(q), static_cast<float*>(scales),
      block_rows * (kLane / 4));
  return static_cast<int>(cudaGetLastError());
}

// chunks: (n, rows, 128) f32; u: (rows, 128) f32; chunk_id: one int32 in
// device memory; q: (rows, 128) int8; scales: (rows / block_rows) f32.
int q8_quantize_chunk_3d(const void* chunks, const void* u,
                         const void* chunk_id, void* q, void* scales, int n,
                         long long rows, int block_rows, void* stream) {
  const long long tiles = rows / block_rows;
  q8_quantize_chunk_kernel<<<static_cast<unsigned int>(tiles), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(chunks), static_cast<const float4*>(u),
      static_cast<const int*>(chunk_id), static_cast<char4*>(q),
      static_cast<float*>(scales), n, static_cast<int64_t>(rows) * (kLane / 4),
      block_rows * (kLane / 4));
  return static_cast<int>(cudaGetLastError());
}

// q: (rows, 128) int8; scales: (rows / block_rows) f32; acc (nullable) and
// out: (rows, 128) f32.
int q8_dequant_add_2d(const void* q, const void* scales, const void* acc,
                      void* out, long long rows, int block_rows, void* stream) {
  const int64_t n_vec = static_cast<int64_t>(rows) * (kLane / 4);
  const int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  q8_dequant_add_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char4*>(q), static_cast<const float*>(scales),
      static_cast<const float4*>(acc), static_cast<float4*>(out), n_vec,
      block_rows * (kLane / 4));
  return static_cast<int>(cudaGetLastError());
}

const char* q8ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
