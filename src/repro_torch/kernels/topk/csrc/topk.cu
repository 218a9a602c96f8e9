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
// output (8 bytes per element in f32); the operations are a few integer
// instructions an element and radix pass.  The bytes bound it.
//
// The design does not bisect over the data.  For mid >= 0,
// count(a >= mid) >= k holds exactly when kth >= mid, kth the k-th largest
// of a = ftz(|x|); so lo depends only on (kth, max a), and one thread
// replays the 32 steps on those two scalars.  kth is found exactly by a
// radix select on the keys bits(a): non-negative floats, so their bit
// patterns order as unsigned integers (a NaN's above +inf's), and bit 31
// is 0.  From the top, each pass counts a digit of the keys whose higher
// digits equal the prefix chosen so far in a shared-memory histogram
// (atomics), then the block scans the bins from the top for the digit at
// which the running count reaches the k still wanted.  Digits are
// kDigit = 8 bits (the first is the exponent), so f32 takes 4 passes and
// bf16 (16 meaningful bits) 2; a pass costs 3 barriers, against the
// bisection's 32 dependent block-wide counts.  (Measured on an H100:
// 11- and 12-bit first digits, and a leader's atomic for the lanes of a
// warp that share a bin, were no faster; PERF.md.)
//
// So that the select does not leave the memory idle, the kernel is
// persistent: kCtasPerSm = 3 blocks of 256 threads an SM (80 registers
// a thread), each looping over row blocks, with the next row block
// brought into shared memory by a 1-D bulk copy (cp.async.bulk,
// completing on an mbarrier; two stages of up to 64 x 128 elements)
// while the current one is selected.  A thread holds the keys of its 32
// elements in registers; the output is the stage's values, masked,
// stored from registers.
//
// Bitwise contract with the plain PyTorch version (ref.py,
// block_topk_bisect_ref; block_topk_kth_ref models this algorithm):
//   * magnitudes and midpoints below 2^-126 count as zero (explicit
//     flush, as XLA on the CPU flushes them when it runs the reference;
//     the library is built without -ftz=true);
//   * mid = RN(RN(lo + hi) * 0.5): __fadd_rn then __fmul_rn, nothing to
//     contract;
//   * max|x| propagates NaN (the largest key is a NaN's), so a block
//     holding a NaN keeps lo = 0: every finite entry is kept, the NaN
//     written 0;
//   * k <= 0 raises lo at every step and k above the block's size never
//     does, as the counts would; padding lanes hold a key that no prefix
//     matches and that loses every max;
//   * kept entries are copied bit for bit (bf16 stays bf16).
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
constexpr int kCtasPerSm = 3;                      // persistent blocks an SM
constexpr int kMaxRows = 64;                       // rows of a block held
constexpr int kVecs = kMaxRows * kLane / 4 / kThreads;  // 8 groups of 4
constexpr int kIters = 32;
constexpr float kTiny = 1.17549435e-38f;           // 2^-126
constexpr unsigned int kTinyBits = 0x00800000u;    // its bits
constexpr unsigned int kPadKey = 0xffffffffu;      // a padding lane's key
constexpr int kDigit = 8;                          // widest digit
constexpr int kBins = 1 << kDigit;
constexpr int kBinsPerThread = kBins > kThreads ? kBins / kThreads : 1;

__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < kTiny ? copysignf(0.0f, v) : v;
}

// bits(ftz(|v|)): ordered as the magnitudes, bit 31 clear
__device__ __forceinline__ unsigned int key_of(float v) {
  const unsigned int b = __float_as_uint(v) & 0x7fffffffu;
  return b < kTinyBits ? 0u : b;
}

struct F32x4 {
  using Raw = float4;
  static constexpr int kLow = 0;    // key bits below this are 0
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
  static constexpr int kLow = 16;
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

// bytes of one stage: a row block of kMaxRows rows
template <typename V>
__host__ __device__ constexpr int stage_bytes() {
  return kMaxRows * kLane / 4 * static_cast<int>(sizeof(typename V::Raw));
}

// the width of the digit below bit `top`: kDigit, or what is left
__host__ __device__ constexpr int digit_width(int top, int low) {
  return top - low < kDigit ? top - low : kDigit;
}

template <typename V>
__host__ __device__ constexpr int passes() {
  return (31 - V::kLow + kDigit - 1) / kDigit;
}

// --- the bulk copy and its mbarrier (PTX) ---------------------------------

__device__ __forceinline__ unsigned int smem_addr(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
}

// `bytes` from global `src` to shared `dst`; completes a phase of `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned int parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n}"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// --- the kernel -----------------------------------------------------------

struct Shared {
  unsigned int hist[2][kBins];
  int warp_max[kWarps];
  unsigned int warp_tot[kWarps];
  unsigned int sel[2];              // prefix chosen, k still wanted
  float lo;
  uint64_t full[2];                 // stage s's data has landed
};

// The radix select of the k-th largest key of the block (1 <= k <= its
// size): the key >> V::kLow.  Expects hist[0] zeroed and visible.
template <typename V>
__device__ __forceinline__ unsigned int radix_select(
    const unsigned int (&key)[kVecs][4], unsigned int want, Shared& sh) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  unsigned int prefix = 0;          // the key's bits above `top`
  int top = 31;
#pragma unroll
  for (int p = 0; p < passes<V>(); ++p) {
    const int w = digit_width(top, V::kLow);
    const int s = top - w;
    const int nbins = 1 << w;
    unsigned int* h = sh.hist[p & 1];
    if (p + 1 < passes<V>()) {      // the next pass's bins; last read a pass ago
      const int next = 1 << digit_width(s, V::kLow);
#pragma unroll
      for (int b = 0; b < kBinsPerThread; ++b) {
        const int i = t * kBinsPerThread + b;
        if (i < next) sh.hist[(p + 1) & 1][i] = 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned int kk = key[j][c];
        if ((kk >> top) == prefix) {
          atomicAdd(&h[(kk >> s) & static_cast<unsigned int>(nbins - 1)], 1u);
        }
      }
    }
    __syncthreads();

    // thread t holds bins [first, first + per): their counts, then the
    // count of every key above them (higher digits sit at higher t)
    const int per = nbins > kThreads ? nbins / kThreads : 1;
    const int first = t * per;
    unsigned int mine[kBinsPerThread];
    unsigned int own = 0;
#pragma unroll
    for (int b = 0; b < kBinsPerThread; ++b) {
      mine[b] = (b < per && first < nbins) ? h[first + b] : 0u;
      own += mine[b];
    }
    unsigned int incl = own;        // suffix sum over the warp's lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned int y = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += y;
    }
    if (lane == 0) sh.warp_tot[warp] = incl;
    __syncthreads();
    unsigned int above = incl - own;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) above += v > warp ? sh.warp_tot[v] : 0u;
    if (above < want && want <= above + own) {   // exactly one thread
      unsigned int run = above;
      bool found = false;
#pragma unroll
      for (int b = kBinsPerThread - 1; b >= 0; --b) {
        if (b < per && !found) {
          if (run + mine[b] >= want) {
            found = true;
            sh.sel[0] = (prefix << w) | static_cast<unsigned int>(first + b);
            sh.sel[1] = want - run;
          } else {
            run += mine[b];
          }
        }
      }
    }
    __syncthreads();
    prefix = sh.sel[0];
    want = sh.sel[1];
    top = s;
  }
  return prefix;
}

// Persistent: block b of the grid takes row blocks b, b + gridDim.x, ...;
// n_vec = block_rows * 32 groups of 4 elements, at most kThreads * kVecs.
template <typename V>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
block_topk_kernel(const typename V::Raw* __restrict__ x,
                  typename V::Raw* __restrict__ out, int n_vec, int k,
                  int n_blocks) {
  using Raw = typename V::Raw;
  extern __shared__ __align__(128) unsigned char stages[];
  __shared__ Shared sh;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned int bytes = static_cast<unsigned int>(n_vec * sizeof(Raw));
  const bool select = k >= 1 && k <= 4 * n_vec;   // else lo needs no kth

  if (t == 0) {
    mbar_init(&sh.full[0]);
    mbar_init(&sh.full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    bulk_load(stages, x + static_cast<int64_t>(blockIdx.x) * n_vec, bytes,
              &sh.full[0]);
  }

  int it = 0;
  for (int blk = blockIdx.x; blk < n_blocks; blk += gridDim.x, ++it) {
    const int st = it & 1;
    const Raw* data = reinterpret_cast<const Raw*>(stages + st * stage_bytes<V>());
#pragma unroll
    for (int b = 0; b < kBinsPerThread; ++b) {
      if (t * kBinsPerThread + b < kBins) sh.hist[0][t * kBinsPerThread + b] = 0u;
    }
    mbar_wait(&sh.full[st], (it >> 1) & 1);

    unsigned int key[kVecs][4];
    int m = -1;                     // largest key; a padding lane's is -1
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int i = t + j * kThreads;
      if (i < n_vec) {
        float v[4];
        V::widen(data[i], v);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          key[j][c] = key_of(v[c]);
          m = max(m, static_cast<int>(key[j][c]));
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) key[j][c] = kPadKey;
      }
    }
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) sh.warp_max[warp] = m;
    __syncthreads();                // every thread is past the other stage
    const int next = blk + gridDim.x;
    if (t == 0 && next < n_blocks) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bulk_load(stages + (st ^ 1) * stage_bytes<V>(),
                x + static_cast<int64_t>(next) * n_vec, bytes,
                &sh.full[st ^ 1]);
    }

    const unsigned int kth_bits =
        select ? radix_select<V>(key, static_cast<unsigned int>(k), sh) : 0u;

    // the 32 bisection steps on (kth, max a), by one thread
    if (t == 0) {
      int mx = sh.warp_max[0];
#pragma unroll
      for (int v = 1; v < kWarps; ++v) mx = max(mx, sh.warp_max[v]);
      const float kth = __uint_as_float(kth_bits << V::kLow);
      float lo = 0.0f;
      float hi = __int_as_float(mx);
      for (int s = 0; s < kIters; ++s) {
        const float mid = ftz(__fmul_rn(__fadd_rn(lo, hi), 0.5f));
        const bool up = select ? mid <= kth : k <= 0;
        lo = up ? mid : lo;
        hi = up ? hi : mid;
      }
      sh.lo = lo;
    }
    __syncthreads();
    const float lo = sh.lo;

    const int64_t base = static_cast<int64_t>(blk) * n_vec;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int i = t + j * kThreads;
      if (i < n_vec) {
        bool keep[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) keep[c] = __uint_as_float(key[j][c]) >= lo;
        out[base + i] = V::select(data[i], keep);
      }
    }
  }
}

template <typename V>
int launch(const void* x, void* out, int n_blocks, int n_vec, int k,
           cudaStream_t stream) {
  constexpr int smem = 2 * stage_bytes<V>();
  cudaError_t err = cudaFuncSetAttribute(
      block_topk_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0;
  int sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = n_blocks < sms * kCtasPerSm ? n_blocks : sms * kCtasPerSm;
  using Raw = typename V::Raw;
  block_topk_kernel<V><<<grid, kThreads, smem, stream>>>(
      static_cast<const Raw*>(x), static_cast<Raw*>(out), n_vec, k, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, out: (rows, 128) f32 (bf16 = 0) or bf16 (bf16 = 1), 16-byte
// aligned; row blocks of block_rows rows, block_rows in [1, 64] dividing
// rows.
int block_topk_2d(const void* x, void* out, long long rows, int block_rows,
                  int k, int bf16, void* stream) {
  if (block_rows < 1 || block_rows > kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_blocks = static_cast<int>(rows / block_rows);
  const int n_vec = block_rows * (kLane / 4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<BF16x4>(x, out, n_blocks, n_vec, k, s)
              : launch<F32x4>(x, out, n_blocks, n_vec, k, s);
}

const char* topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
