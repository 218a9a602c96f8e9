// RWKV-6 WKV recurrence for Hopper (sm_90a), forward and backward, plain C
// interface.
//
// Replaces the Pallas TPU kernel of the reference package:
//   wkv6_fwd_kernel  <- src/repro/kernels/wkv6/kernel.py wkv6_pallas
//                       (body _wkv6_kernel)
//   wkv6_bwd_kernel  -- the TPU kernel has no backward; this one is the
//                       port's own, the reverse recurrence of
//                       repro_torch/kernels/wkv6/ref.py wkv6_bwd_ref.
//
// Per (batch * head) row, with the K x V f32 state S, zero before t = 0:
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
// The rank-1 sequential form, as the TPU kernel keeps it (the chunked
// matrix form's factored decays overflow for extreme data-dependent w).
//
// What bounds it on this card: neither bytes nor operations but latency.
// Each row is T dependent steps of ~3 K V flops; at the training shape
// (80 rows, T = 128, K = V = 64) that is 80 blocks on 132 SMs, one step
// after another, while the bytes (~14 MB forward) would take ~4 us.  The
// design is the simple one: one thread block per row, so the recurrence
// never leaves the block and needs no cross-block sync; and no load from
// device memory on a step's critical path (each kernel fetches its next
// stage of inputs while it computes the current one).
//
// Forward: V threads, thread j keeps column j of S in registers (K floats);
// r, k, w, v of fwd_stage steps are staged in shared memory (r, k, w read
// as broadcasts), so a step is K fused multiply-adds per thread and no
// sync; the next stage's loads go to registers and land meanwhile.
// When asked (ckpt != null) it saves S_{t-1} at every t % kCkptEvery == 0
// into a scratch buffer (BH, ceil(T / kCkptEvery), K, V) for the backward.
// r, k, v, w f32 or bf16 (upcast on load, as the TPU kernel does); u,
// state and outputs f32.  Any T >= 1: no chunk divisibility (the TPU's
// T % chunk was a VMEM tiling limit).
//
// Backward (f32): K threads, thread i keeps ROW i of the state gradient
// dS in registers (V floats), so the three sums over j (dr, dk, dw) stay
// inside a thread; the one sum over i (dv) goes through shared memory
// (padded rows, no bank conflicts).  It walks the checkpoint chunks in
// reverse, copying the next chunk's inputs and saved state into shared
// memory (cp.async, double-buffered) while it works on the current one:
// from the saved state it recomputes S_{t-1} for the chunk's kCkptEvery
// steps into shared memory (each thread its own row), then runs the
// reverse recurrence:
//     dr_t[i] = sum_j dy_t[j] (S_{t-1}[i,j] + u_i k_t[i] v_t[j])
//     dk_t[i] = sum_j dS_t[i,j] v_t[j] + u_i r_t[i] (dy_t . v_t)
//     dv_t[j] = sum_i dS_t[i,j] k_t[i] + (sum_i r_t[i] u_i k_t[i]) dy_t[j]
//     dw_t[i] = sum_j dS_t[i,j] S_{t-1}[i,j]
//     du[i]  += r_t[i] k_t[i] (dy_t . v_t)        (per row; the caller sums
//                                                   over the batch)
//     dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T
// The state update is written with explicit roundings (__fmul_rn,
// __fmaf_rn) in both kernels, so the recomputed S_{t-1} is bitwise the
// forward's.  Built without --use_fast_math.
//
// Each entry returns cudaGetLastError() after its launch; the Python
// wrapper raises when that is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCkptEvery = 8;   // steps between saved states (ref.py CKPT_EVERY)

// forward: steps staged at once, so that each thread fetches 16 of each of
// r, k, w per stage (16 steps at K = V = 64)
template <int K, int V>
__host__ __device__ constexpr int fwd_stage() { return 16 * V / K; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Start the loads of the forward stage starting at t0 (n steps) into this
// thread's registers; they are in flight until the registers are read.
template <int K, int V, typename T>
__device__ __forceinline__ void fwd_fetch(const T* __restrict__ r,
                                          const T* __restrict__ k,
                                          const T* __restrict__ w,
                                          const T* __restrict__ v, int n,
                                          float (&pr)[16], float (&pk)[16],
                                          float (&pw)[16],
                                          float (&pv)[fwd_stage<K, V>()]) {
  const int j = threadIdx.x;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int e = j + q * V;
    if (e < n * K) {
      pr[q] = to_f32(r[e]);
      pk[q] = to_f32(k[e]);
      pw[q] = to_f32(w[e]);
    }
  }
#pragma unroll
  for (int q = 0; q < fwd_stage<K, V>(); ++q) {
    if (q < n) pv[q] = to_f32(v[q * V + j]);
  }
}

template <int K, int V, typename T>
__global__ void __launch_bounds__(V)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const float* __restrict__ u, float* __restrict__ y,
                float* __restrict__ s_fin, float* __restrict__ ckpt, int n_t) {
  constexpr int kS = fwd_stage<K, V>();
  __shared__ float sr[kS * K], sk[kS * K], sw[kS * K], sv[kS * V], su[K];
  const int j = threadIdx.x;
  const int64_t bh = blockIdx.x;
  const int64_t rk_base = bh * n_t * K;
  const int64_t v_base = bh * n_t * V;
  const int n_ckpt = (n_t + kCkptEvery - 1) / kCkptEvery;
  for (int i = j; i < K; i += V) su[i] = u[bh * K + i];

  float s[K];
#pragma unroll
  for (int i = 0; i < K; ++i) s[i] = 0.0f;

  float pr[16], pk[16], pw[16], pv[kS];
  fwd_fetch<K, V>(r + rk_base, k + rk_base, w + rk_base, v + v_base,
                  min(kS, n_t), pr, pk, pw, pv);
  for (int t0 = 0; t0 < n_t; t0 += kS) {
    const int n = min(kS, n_t - t0);
    __syncthreads();  // every thread is done with the previous stage
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int e = j + q * V;
      if (e < n * K) {
        sr[e] = pr[q];
        sk[e] = pk[q];
        sw[e] = pw[q];
      }
    }
#pragma unroll
    for (int q = 0; q < kS; ++q) {
      if (q < n) sv[q * V + j] = pv[q];
    }
    __syncthreads();
    if (t0 + kS < n_t) {  // the next stage's loads land during this one
      const int64_t t1 = t0 + kS;
      fwd_fetch<K, V>(r + rk_base + t1 * K, k + rk_base + t1 * K,
                      w + rk_base + t1 * K, v + v_base + t1 * V,
                      min(kS, n_t - static_cast<int>(t1)), pr, pk, pw, pv);
    }
    for (int tt = 0; tt < n; ++tt) {
      const int t = t0 + tt;
      if (ckpt != nullptr && t % kCkptEvery == 0) {
        float* c = ckpt + (bh * n_ckpt + t / kCkptEvery) * K * V + j;
#pragma unroll
        for (int i = 0; i < K; ++i) c[i * V] = s[i];
      }
      const float vj = sv[tt * V + j];
      const float* rt = sr + tt * K;
      const float* kt = sk + tt * K;
      const float* wt = sw + tt * K;
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float kv = __fmul_rn(kt[i], vj);
        acc = __fmaf_rn(rt[i], __fmaf_rn(su[i], kv, s[i]), acc);
        s[i] = __fmaf_rn(wt[i], s[i], kv);
      }
      y[v_base + static_cast<int64_t>(t) * V + j] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) s_fin[(bh * K + i) * V + j] = s[i];
}

// 4-byte asynchronous copy global -> shared (no registers, no wait)
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// floats of one staged backward chunk: r, k, w, then v, dy
template <int K, int V>
__host__ __device__ constexpr int bwd_stage_floats() { return kCkptEvery * (3 * K + 2 * V); }

// floats of dynamic shared memory the backward takes
template <int K, int V>
__host__ __device__ constexpr int bwd_smem_floats() {
  return (kCkptEvery + 3) * K * (V + 1)   // S_{t-1}, dv partials, checkpoint
         + 2 * bwd_stage_floats<K, V>()   // staged inputs, double-buffered
         + K;                             // u
}

// Start copying chunk c's inputs into `stage` and its saved state into
// `ck` (rows padded to V + 1); the whole block takes part.
template <int K, int V>
__device__ __forceinline__ void bwd_fetch(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ dy, const float* __restrict__ ckpt,
    float* stage, float* ck, int64_t bh, int n_t, int n_ckpt, int c) {
  constexpr int C = kCkptEvery;
  const int i = threadIdx.x;
  const int t0 = c * C;
  const int n = min(C, n_t - t0);
  const int64_t rk = (bh * n_t + t0) * K;
  const int64_t vv = (bh * n_t + t0) * V;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int e = i + q * K;
    if (e < n * K) {
      cp_async4(stage + e, r + rk + e);
      cp_async4(stage + C * K + e, k + rk + e);
      cp_async4(stage + 2 * C * K + e, w + rk + e);
    }
  }
#pragma unroll
  for (int q = 0; q < C * V / K; ++q) {
    const int e = i + q * K;
    if (e < n * V) {
      cp_async4(stage + 3 * C * K + e, v + vv + e);
      cp_async4(stage + 3 * C * K + C * V + e, dy + vv + e);
    }
  }
  const float* cs = ckpt + (bh * n_ckpt + c) * K * V;
#pragma unroll 8
  for (int q = 0; q < V; ++q) {
    const int e = i + q * K;
    cp_async4(ck + (e / V) * (V + 1) + e % V, cs + e);
  }
  cp_async_commit();
}

template <int K, int V>
__global__ void __launch_bounds__(K)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ dy,
                const float* __restrict__ ckpt,
                const float* __restrict__ ds_fin, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du, int n_t) {
  constexpr int C = kCkptEvery;
  constexpr int VP = V + 1;  // odd row pitch: a warp's rows hit 32 banks
  extern __shared__ float smem[];
  float* states = smem;                            // [C][K][VP]
  float* part = states + C * K * VP;               // [2][K][VP]
  float* ck = part + 2 * K * VP;                   // [K][VP]
  float* stages = ck + K * VP;                     // [2][bwd_stage_floats]
  float* su = stages + 2 * bwd_stage_floats<K, V>();  // [K]

  const int i = threadIdx.x;
  const int64_t bh = blockIdx.x;
  const int64_t rk_base = bh * n_t * K;
  const int64_t v_base = bh * n_t * V;
  const int n_ckpt = (n_t + C - 1) / C;
  const float ui = u[bh * K + i];
  su[i] = ui;

  float ds[V];  // row i of dS_t
#pragma unroll
  for (int j = 0; j < V; ++j) {
    ds[j] = ds_fin != nullptr ? ds_fin[(bh * K + i) * V + j] : 0.0f;
  }
  float du_acc = 0.0f;
  int p = 0;  // which half of `part` this step writes

  // chunk c's inputs are staged in half (c & 1) of `stages`
  bwd_fetch<K, V>(r, k, v, w, dy, ckpt,
                  stages + ((n_ckpt - 1) & 1) * bwd_stage_floats<K, V>(), ck,
                  bh, n_t, n_ckpt, n_ckpt - 1);
  for (int c = n_ckpt - 1; c >= 0; --c) {
    const int t0 = c * C;
    const int n = min(C, n_t - t0);
    const float* stage = stages + (c & 1) * bwd_stage_floats<K, V>();
    const float* st_r = stage;                     // [C][K]
    const float* st_k = stage + C * K;
    const float* st_w = stage + 2 * C * K;
    const float* st_v = stage + 3 * C * K;         // [C][V]
    const float* st_dy = st_v + C * V;
    cp_async_wait_all();
    __syncthreads();  // chunk c's inputs have landed, for every thread

    float s[V];  // S_{t0-1}, row i
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = ck[i * VP + j];
    __syncthreads();  // ck is read: the next chunk's copies may start
    if (c > 0) {
      bwd_fetch<K, V>(r, k, v, w, dy, ckpt,
                      stages + ((c - 1) & 1) * bwd_stage_floats<K, V>(), ck,
                      bh, n_t, n_ckpt, c - 1);
    }

    // S_{t-1} for t = t0 .. t0 + n - 1, row i, into this thread's rows
    for (int tt = 0; tt < n; ++tt) {
      float* row = states + (tt * K + i) * VP;
      const float kt = st_k[tt * K + i];
      const float wt = st_w[tt * K + i];
      const float* vt = st_v + tt * V;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        row[j] = s[j];
        s[j] = __fmaf_rn(wt, s[j], __fmul_rn(kt, vt[j]));
      }
    }

    for (int tt = n - 1; tt >= 0; --tt) {
      const int t = t0 + tt;
      const float* row = states + (tt * K + i) * VP;
      const float* vt = st_v + tt * V;
      const float* dyt = st_dy + tt * V;
      const float rt = st_r[tt * K + i];
      const float kt = st_k[tt * K + i];
      const float wt = st_w[tt * K + i];
      float dyv = 0.0f;
#pragma unroll
      for (int j = 0; j < V; ++j) dyv = __fmaf_rn(dyt[j], vt[j], dyv);
      float rku = 0.0f;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        rku = __fmaf_rn(st_r[tt * K + q] * su[q], st_k[tt * K + q], rku);
      }
      float a = 0.0f, b = 0.0f, cw = 0.0f;
      float* pt = part + (p * K + i) * VP;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float sp = row[j];
        a = __fmaf_rn(dyt[j], sp, a);
        b = __fmaf_rn(ds[j], vt[j], b);
        cw = __fmaf_rn(ds[j], sp, cw);
        pt[j] = ds[j] * kt;
        ds[j] = __fmaf_rn(wt, ds[j], rt * dyt[j]);
      }
      const int64_t o = rk_base + static_cast<int64_t>(t) * K + i;
      dr[o] = a + ui * kt * dyv;
      dk[o] = b + ui * rt * dyv;
      dw[o] = cw;
      du_acc += rt * kt * dyv;
      __syncthreads();  // this step's dv partials are all written
      const float* pp = part + p * K * VP;
      for (int j = i; j < V; j += K) {
        float sum = 0.0f;
#pragma unroll
        for (int q = 0; q < K; ++q) sum += pp[q * VP + j];
        dv[v_base + static_cast<int64_t>(t) * V + j] = sum + rku * dyt[j];
      }
      p ^= 1;  // the next step writes the other half: one sync per step
    }
  }
  du[bh * K + i] = du_acc;
}

template <int K, int V, typename T>
int launch_fwd(const void* r, const void* k, const void* v, const void* w,
               const void* u, void* y, void* s_fin, void* ckpt, int bh,
               int n_t, cudaStream_t stream) {
  wkv6_fwd_kernel<K, V, T><<<bh, V, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<float*>(s_fin), static_cast<float*>(ckpt), n_t);
  return static_cast<int>(cudaGetLastError());
}

template <int K, typename T>
int dispatch_fwd_v(const void* r, const void* k, const void* v, const void* w,
                   const void* u, void* y, void* s_fin, void* ckpt, int bh,
                   int n_t, int n_v, cudaStream_t stream) {
  switch (n_v) {
    case 16: return launch_fwd<K, 16, T>(r, k, v, w, u, y, s_fin, ckpt, bh, n_t, stream);
    case 32: return launch_fwd<K, 32, T>(r, k, v, w, u, y, s_fin, ckpt, bh, n_t, stream);
    case 64: return launch_fwd<K, 64, T>(r, k, v, w, u, y, s_fin, ckpt, bh, n_t, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_fwd(const void* r, const void* k, const void* v, const void* w,
                 const void* u, void* y, void* s_fin, void* ckpt, int bh,
                 int n_t, int n_k, int n_v, cudaStream_t stream) {
  switch (n_k) {
    case 16: return dispatch_fwd_v<16, T>(r, k, v, w, u, y, s_fin, ckpt, bh, n_t, n_v, stream);
    case 32: return dispatch_fwd_v<32, T>(r, k, v, w, u, y, s_fin, ckpt, bh, n_t, n_v, stream);
    case 64: return dispatch_fwd_v<64, T>(r, k, v, w, u, y, s_fin, ckpt, bh, n_t, n_v, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int K, int V>
int launch_bwd(const float* const* in, float* const* out, int bh, int n_t,
               cudaStream_t stream) {
  constexpr int bytes = bwd_smem_floats<K, V>() * static_cast<int>(sizeof(float));
  static_assert(bytes <= 232448, "backward shared memory above the 227 KB a block may use");
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<K, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_kernel<K, V><<<bh, K, bytes, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], out[0], out[1],
      out[2], out[3], out[4], n_t);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int dispatch_bwd_v(const float* const* in, float* const* out, int bh, int n_t,
                   int n_v, cudaStream_t stream) {
  switch (n_v) {
    case 16: return launch_bwd<K, 16>(in, out, bh, n_t, stream);
    case 32: return launch_bwd<K, 32>(in, out, bh, n_t, stream);
    case 64: return launch_bwd<K, 64>(in, out, bh, n_t, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// r, k, w: (bh, n_t, n_k); v: (bh, n_t, n_v), all f32 (bf16 == 0) or all
// bf16 (bf16 == 1); u: (bh, n_k) f32.  y: (bh, n_t, n_v) f32; s_fin:
// (bh, n_k, n_v) f32; ckpt: (bh, ceil(n_t / 8), n_k, n_v) f32 or null.
// n_k and n_v in {16, 32, 64}.
int wkv6_forward(const void* r, const void* k, const void* v, const void* w,
                 const void* u, void* y, void* s_fin, void* ckpt, int bh,
                 int n_t, int n_k, int n_v, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return dispatch_fwd<__nv_bfloat16>(r, k, v, w, u, y, s_fin, ckpt, bh, n_t,
                                       n_k, n_v, s);
  }
  return dispatch_fwd<float>(r, k, v, w, u, y, s_fin, ckpt, bh, n_t, n_k, n_v,
                             s);
}

// All f32.  r, k, w, dr, dk, dw: (bh, n_t, n_k); v, dy, dv: (bh, n_t, n_v);
// u, du: (bh, n_k); ckpt: the forward's; ds_fin: (bh, n_k, n_v) or null.
int wkv6_backward(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* dy, const void* ckpt,
                  const void* ds_fin, void* dr, void* dk, void* dv, void* dw,
                  void* du, int bh, int n_t, int n_k, int n_v, void* stream) {
  const float* in[8] = {
      static_cast<const float*>(r),  static_cast<const float*>(k),
      static_cast<const float*>(v),  static_cast<const float*>(w),
      static_cast<const float*>(u),  static_cast<const float*>(dy),
      static_cast<const float*>(ckpt), static_cast<const float*>(ds_fin)};
  float* out[5] = {static_cast<float*>(dr), static_cast<float*>(dk),
                   static_cast<float*>(dv), static_cast<float*>(dw),
                   static_cast<float*>(du)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_k) {
    case 16: return dispatch_bwd_v<16>(in, out, bh, n_t, n_v, s);
    case 32: return dispatch_bwd_v<32>(in, out, bh, n_t, n_v, s);
    case 64: return dispatch_bwd_v<64>(in, out, bh, n_t, n_v, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
