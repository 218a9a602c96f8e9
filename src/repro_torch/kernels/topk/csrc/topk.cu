// Block Top-K sparsification for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of the reference package:
//   block_topk_kernel  <- src/repro/kernels/topk/kernel.py
//                         block_topk_2d (body _block_topk_kernel)
//
// Each (block_rows, 128) row block keeps its entries with |x| >= lo and
// zeroes the rest; lo comes from 32 bisection steps on
// count(|x| >= mid) >= k, from lo = 0, hi = max|x|, mid = 0.5 * (lo + hi).
//
// Bounds on this card: the bytes are one read of x and one write of the
// output (8 bytes per element in f32), the operations 32 steps of a
// compare and an add per element.  Both are small; what costs is that
// every step is a reduction over the whole block whose result every
// thread needs before the next step: 32 dependent block-wide sums.  The
// design: one thread block (256 threads) per row block, the block's
// values held in registers for all 32 steps (at most 64 rows = 8192
// elements = 32 per thread, 16-byte loads), a step's count summed by
// __reduce_add_sync within each warp and through shared memory across
// the 8 warps -- double-buffered, so one barrier per step.  Many row
// blocks are resident on an SM at once (up to 8 of 256 threads), so one
// block's reductions overlap another's.  The block is read from device
// memory once and written once.
//
// Bitwise contract with the plain PyTorch version (ref.py,
// block_topk_bisect_ref):
//   * magnitudes and midpoints below 2^-126 count as zero (explicit
//     flush, as XLA on the CPU flushes them when it runs the reference;
//     the library is built without -ftz=true);
//   * mid = RN(RN(lo + hi) * 0.5): __fadd_rn then __fmul_rn, nothing to
//     contract;
//   * max|x| propagates NaN (fmaxf would drop it), so a block holding a
//     NaN keeps lo = 0: every finite entry is kept, the NaN written 0;
//   * the counts are exact integers; kept entries are copied bit for bit
//     (bf16 stays bf16).
//
// Each entry returns cudaGetLastError() after its launch; the Python
// wrapper raises when that is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;                       // rows of a block held
constexpr int kVecs = kMaxRows * kLane / 4 / kThreads;  // 8 groups of 4
constexpr int kIters = 32;
constexpr float kTiny = 1.17549435e-38f;           // 2^-126

__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < kTiny ? copysignf(0.0f, v) : v;
}

// NaN-propagating max (fmaxf drops NaN; jnp.max and torch.amax keep it)
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct F32x4 {
  using Raw = float4;
  __device__ static void widen(const Raw& r, float v[4]) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  __device__ static Raw select(const Raw& r, const bool keep[4]) {
    return make_float4(keep[0] ? r.x : 0.0f, keep[1] ? r.y : 0.0f,
                       keep[2] ? r.z : 0.0f, keep[3] ? r.w : 0.0f);
  }
};

struct BF16x4 {
  using Raw = uint2;  // 4 bf16, element 0 in the low half of .x
  __device__ static void widen(const Raw& r, float v[4]) {
    v[0] = __uint_as_float(r.x << 16);
    v[1] = __uint_as_float(r.x & 0xffff0000u);
    v[2] = __uint_as_float(r.y << 16);
    v[3] = __uint_as_float(r.y & 0xffff0000u);
  }
  __device__ static Raw select(const Raw& r, const bool keep[4]) {
    const unsigned int m0 = (keep[0] ? 0x0000ffffu : 0u) | (keep[1] ? 0xffff0000u : 0u);
    const unsigned int m1 = (keep[2] ? 0x0000ffffu : 0u) | (keep[3] ? 0xffff0000u : 0u);
    return make_uint2(r.x & m0, r.y & m1);
  }
};

// One thread block per (block_rows, 128) row block; n_vec = block_rows * 32
// groups of 4 elements, at most kThreads * kVecs.
template <typename V>
__global__ void __launch_bounds__(kThreads)
block_topk_kernel(const typename V::Raw* __restrict__ x,
                  typename V::Raw* __restrict__ out, int n_vec, int k) {
  using Raw = typename V::Raw;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n_vec;
  const int t = threadIdx.x;

  Raw raw[kVecs];
  float a[kVecs][4];
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int i = t + j * kThreads;
    if (i < n_vec) {
      raw[j] = x[base + i];
      float v[4];
      V::widen(raw[j], v);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        a[j][c] = ftz(fabsf(v[c]));
        m = nanmax(m, a[j][c]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) a[j][c] = -1.0f;  // never >= mid >= 0
    }
  }

  __shared__ float warp_max[kWarps];
  __shared__ int warp_cnt[2][kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if ((t & 31) == 0) warp_max[t >> 5] = m;
  __syncthreads();
  float hi = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) hi = nanmax(hi, warp_max[w]);
  float lo = 0.0f;

  for (int s = 0; s < kIters; ++s) {
    const float mid = ftz(__fmul_rn(__fadd_rn(lo, hi), 0.5f));
    unsigned int cnt = 0;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) cnt += (a[j][c] >= mid) ? 1u : 0u;
    }
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if ((t & 31) == 0) warp_cnt[s & 1][t >> 5] = static_cast<int>(cnt);
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_cnt[s & 1][w];
    if (total >= k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }

#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int i = t + j * kThreads;
    if (i < n_vec) {
      bool keep[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) keep[c] = a[j][c] >= lo;
      out[base + i] = V::select(raw[j], keep);
    }
  }
}

}  // namespace

extern "C" {

// x, out: (rows, 128) f32 (bf16 = 0) or bf16 (bf16 = 1); one thread block
// per block_rows rows, block_rows in [1, 64] dividing rows.
int block_topk_2d(const void* x, void* out, long long rows, int block_rows,
                  int k, int bf16, void* stream) {
  if (block_rows < 1 || block_rows > kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned int blocks = static_cast<unsigned int>(rows / block_rows);
  const int n_vec = block_rows * (kLane / 4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    block_topk_kernel<BF16x4><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint2*>(x), static_cast<uint2*>(out), n_vec, k);
  } else {
    block_topk_kernel<F32x4><<<blocks, kThreads, 0, s>>>(
        static_cast<const float4*>(x), static_cast<float4*>(out), n_vec, k);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
