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
// At the training shape (80 rows, T = 128, K = V = 64) a row is T
// dependent steps over a 64 x 64 state, while the bytes (~14 MB forward)
// would take ~4 us.  The lever is that both recurrences are elementwise:
// S[i,j] and dS[i,j] each follow their own scalar chain, and the sums over
// i or j appear only in the outputs, which nothing feeds back.  So each
// thread keeps a small tile of the state in registers, where a step is
// one multiply and one add of its own, and the sums over the tile's
// neighbours are taken off that chain: each step leaves its partial sums
// in shared memory, and the block adds them once per stage of steps.
// Every sum runs in a fixed order and no atomics are used: the same inputs
// give the same bits on every call.
//
// The state update rounds as the plain version does, w * S then + k v
// (__fmul_rn, __fadd_rn, in both kernels): a fused w * S + k v drifts one
// rounding a step from it where w is within an ulp of 1, which over T
// steps leaves the tolerance.  The backward recomputes S_{t-1} the same
// way, so it is bitwise the forward's; dS updates as w * dS then + r dy.
// Built without --use_fast_math.
//
// Forward: one block per (row, 16 columns of S): 4 blocks a row at V = 64,
// which never meet, since y_t[j] sums over i only.  A thread holds 8 rows
// of one column; a warp is 2 row groups x 16 columns, so r, k, w are read
// from shared memory as 16-byte broadcasts.  Per step a thread adds its 8
// rows' share of y_t[j] into one partial; the K / 8 partials of a column
// are added once per stage of kFwdStage steps.  Stages are
// double-buffered: while one is computed on, the next one's inputs are
// copied into shared memory (cp.async, 16 bytes a copy, in the inputs' own
// type), so a stage costs one barrier.  When asked (ckpt != null) it saves
// S_{t-1} at every
// t % kCkptEvery == 0 into a scratch buffer (BH, ceil(T / kCkptEvery), K,
// V) for the backward.  r, k, v, w f32 or bf16 (upcast on load, as the TPU
// kernel does); u, state and outputs f32.  Any T >= 1: past the end a
// stage holds steps that leave the state as it is.
//
// Backward (f32): one block of K V / 8 threads per row (512 at 64 x 64); a
// thread holds a 2 x 4 tile (rows i0, i0 + 1; columns j0 .. j0 + 3).  It
// walks the checkpoint chunks in reverse, copying the next chunk's inputs
// into shared memory (cp.async, double-buffered) and the next saved tile
// into registers while it works on the current one.  From the saved state
// each thread recomputes its tile of S_{t-1} for the chunk's kCkptEvery
// steps, in registers, then runs the reverse recurrence:
//     dr_t[i] = sum_j dy_t[j] (S_{t-1}[i,j] + u_i k_t[i] v_t[j])
//     dk_t[i] = sum_j dS_t[i,j] v_t[j] + u_i r_t[i] (dy_t . v_t)
//     dv_t[j] = sum_i dS_t[i,j] k_t[i] + (sum_i r_t[i] u_i k_t[i]) dy_t[j]
//     dw_t[i] = sum_j dS_t[i,j] S_{t-1}[i,j]
//     du[i]  += r_t[i] k_t[i] (dy_t . v_t)        (per row; the caller sums
//                                                   over the batch)
//     dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T
// Per step a thread stores its shares of the three sums over j (over its
// 4 columns, for 2 rows) and of the sum over i (over its 2 rows, for 4
// columns) and goes on: no shuffle and no barrier inside the step loop.
// After the chunk one barrier, then each thread adds the shares of two
// outputs in order and writes them: half the threads a pair of rows of
// dr, dk, dw, the other half a pair of columns of dv.
//
// Each entry returns cudaGetLastError() after its launch; the Python
// wrapper raises when that is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCkptEvery = 8;   // steps between saved states (ref.py CKPT_EVERY)
constexpr unsigned kFull = 0xffffffffu;

// The wrappers pass sequences and checkpoints that start 16-byte aligned
// (they copy a view that does not); with K, V in {16, 32, 64} every row
// then does too.

// 16-byte asynchronous copy global -> shared (no registers, no wait); both
// addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// n elements (a multiple of 16 bytes) from src to dst by the block's nt
// threads; both 16-byte aligned
template <typename T>
__device__ __forceinline__ void cp_async_span(T* dst, const T* src, int n,
                                              int nt) {
  constexpr int E = 16 / sizeof(T);
#pragma unroll 1
  for (int e = E * threadIdx.x; e < n; e += E * nt) cp_async16(dst + e, src + e);
}

// Eight consecutive values from shared memory as f32 (16-byte aligned)
__device__ __forceinline__ void lds8(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void lds8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const unsigned q[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&q[c]);
    o[2 * c] = __low2float(h);
    o[2 * c + 1] = __high2float(h);
  }
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------- forward

constexpr int kFwdCols = 16;   // columns of S per block
constexpr int kFwdRows = 8;    // rows of S per thread
constexpr int kFwdStage = 16;  // steps per stage
static_assert(kFwdStage % kCkptEvery == 0, "a stage starts on a checkpoint");

template <int K>
__host__ __device__ constexpr int fwd_threads() { return kFwdCols * K / kFwdRows; }

template <int K, int V, typename T>
__global__ void __launch_bounds__(fwd_threads<K>())
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const float* __restrict__ u, float* __restrict__ y,
                float* __restrict__ s_fin, float* __restrict__ ckpt, int n_t) {
  constexpr int NT = fwd_threads<K>();
  constexpr int G = K / kFwdRows;              // row groups of a column
  constexpr int CS = kFwdStage;
  // two stages of inputs (in their own type) and of y partials: one is
  // computed on while the other is filled (inputs) or summed (partials)
  __shared__ __align__(16) T sr[2][CS * K];
  __shared__ __align__(16) T sk[2][CS * K];
  __shared__ __align__(16) T sw[2][CS * K];
  __shared__ __align__(16) T sv[2][CS * kFwdCols];
  __shared__ float yp[2][CS * G * kFwdCols];   // [step][group][col]

  const int tid = threadIdx.x;
  const int jl = tid % kFwdCols;
  const int g = tid / kFwdCols;
  const int i0 = g * kFwdRows;
  const int64_t bh = blockIdx.x;
  const int col0 = blockIdx.y * kFwdCols;
  const int j = col0 + jl;
  const int64_t rk_base = bh * n_t * K;
  const int64_t v_base = bh * n_t * V;
  const int n_ckpt = (n_t + kCkptEvery - 1) / kCkptEvery;

  float ui[kFwdRows], s[kFwdRows];
#pragma unroll
  for (int a = 0; a < kFwdRows; ++a) {
    ui[a] = u[bh * K + i0 + a];
    s[a] = 0.0f;
  }

  // Start copying the stage from t0 into buffer b.  Past the end of the
  // sequence the stage gets r = k = v = 0, w = 1: steps that leave the
  // state as it is, so the step loop needs no bounds.
  auto fetch = [&](int b, int t0) {
    const int n = min(CS, n_t - t0);
    const int64_t rk = rk_base + static_cast<int64_t>(t0) * K;
    cp_async_span(sr[b], r + rk, n * K, NT);
    cp_async_span(sk[b], k + rk, n * K, NT);
    cp_async_span(sw[b], w + rk, n * K, NT);
    constexpr int E = 16 / sizeof(T);          // elements a copy
#pragma unroll 1
    for (int e = E * tid; e < n * kFwdCols; e += E * NT) {
      cp_async16(sv[b] + e, v + v_base + static_cast<int64_t>(t0 + e / kFwdCols) * V +
                                col0 + e % kFwdCols);
    }
    cp_async_commit();
#pragma unroll 1
    for (int e = n * K + tid; e < CS * K; e += NT) {
      sr[b][e] = T(0.0f);
      sk[b][e] = T(0.0f);
      sw[b][e] = T(1.0f);
    }
#pragma unroll 1
    for (int e = n * kFwdCols + tid; e < CS * kFwdCols; e += NT) sv[b][e] = T(0.0f);
  };

  fetch(0, 0);
  cp_async_wait_all();
  __syncthreads();
  for (int t0 = 0, b = 0; t0 < n_t; t0 += CS, b ^= 1) {
    if (t0 + CS < n_t) fetch(b ^ 1, t0 + CS);  // lands during this stage
    const T* br = sr[b];
    const T* bk = sk[b];
    const T* bw = sw[b];
    const T* bv = sv[b];
#pragma unroll
    for (int tt = 0; tt < CS; ++tt) {
      if (ckpt != nullptr && tt % kCkptEvery == 0 && t0 + tt < n_t) {
        float* c = ckpt + ((bh * n_ckpt + (t0 + tt) / kCkptEvery) * K + i0) * V + j;
#pragma unroll
        for (int a = 0; a < kFwdRows; ++a) c[a * V] = s[a];
      }
      float rt[kFwdRows], kt[kFwdRows], wt[kFwdRows];
      lds8(br + tt * K + i0, rt);
      lds8(bk + tt * K + i0, kt);
      lds8(bw + tt * K + i0, wt);
      const float vj = to_f32(bv[tt * kFwdCols + jl]);
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < kFwdRows; ++a) {
        const float kv = __fmul_rn(kt[a], vj);
        acc = __fmaf_rn(rt[a], __fmaf_rn(ui[a], kv, s[a]), acc);
        s[a] = __fadd_rn(__fmul_rn(wt[a], s[a]), kv);
      }
      yp[b][(tt * G + g) * kFwdCols + jl] = acc;
    }
    cp_async_wait_all();
    __syncthreads();  // this stage's partials and the next stage's inputs
                      // are written; this stage's inputs are free
    const int n = min(CS, n_t - t0);
#pragma unroll 1
    for (int e = tid; e < n * kFwdCols; e += NT) {
      const int tt = e / kFwdCols;
      const int jj = e % kFwdCols;
      float sum = 0.0f;
#pragma unroll
      for (int q = 0; q < G; ++q) sum += yp[b][(tt * G + q) * kFwdCols + jj];
      y[v_base + static_cast<int64_t>(t0 + tt) * V + col0 + jj] = sum;
    }
  }
#pragma unroll
  for (int a = 0; a < kFwdRows; ++a) s_fin[(bh * K + i0 + a) * V + j] = s[a];
}

// --------------------------------------------------------------- backward

// A thread's tile of the state: rows i0, i0 + 1 and columns j0 .. j0 + 3;
// a warp's lanes cover a 16 x 16 block (lane bits 0-1: the column quad,
// bits 2-4: the row pair), the block's K V / 8 threads the whole state.
constexpr int kRows = 2;
constexpr int kCols = 4;

template <int K, int V>
__host__ __device__ constexpr int bwd_threads() { return K * V / (kRows * kCols); }

// row pitch of the column partials: 16 mod 32 floats, so that the two row
// pairs of a quarter warp's 16-byte stores fall in different banks
template <int V>
__host__ __device__ constexpr int bwd_col_pitch() { return (V + 31) / 32 * 32 + 16; }

// floats of one staged chunk: r, k, w [C][K], then v, dy [C][V]
template <int K, int V>
__host__ __device__ constexpr int bwd_stage_floats() {
  return kCkptEvery * (3 * K + 2 * V);
}

// floats of dynamic shared memory the backward takes
template <int K, int V>
__host__ __device__ constexpr int bwd_smem_floats() {
  return 2 * bwd_stage_floats<K, V>()                  // inputs, double-buffered
         + kCkptEvery * 3 * (V / 4) * (K + 8)          // row partials
         + kCkptEvery * (K / 2) * bwd_col_pitch<V>()   // column partials
         + 2 * kCkptEvery + K;                         // dy.v, r.(u k); u
}

// Start copying chunk c's inputs into `stage`.  A chunk shorter than
// kCkptEvery steps (only the last one can be) gets r = k = v = dy = 0 and
// w = 1 in its unused steps, which leave the state and its gradient as
// they are, so the step loops need no bounds.
template <int K, int V>
__device__ __forceinline__ void bwd_fetch(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ dy, float* stage, int64_t bh, int n_t,
    int c) {
  constexpr int C = kCkptEvery;
  constexpr int NT = bwd_threads<K, V>();
  const int t0 = c * C;
  const int n = min(C, n_t - t0);
  const int64_t rk = (bh * n_t + t0) * K;
  const int64_t vv = (bh * n_t + t0) * V;
  cp_async_span(stage, r + rk, n * K, NT);
  cp_async_span(stage + C * K, k + rk, n * K, NT);
  cp_async_span(stage + 2 * C * K, w + rk, n * K, NT);
  cp_async_span(stage + 3 * C * K, v + vv, n * V, NT);
  cp_async_span(stage + 3 * C * K + C * V, dy + vv, n * V, NT);
  cp_async_commit();
#pragma unroll 1
  for (int e = n * K + threadIdx.x; e < C * K; e += NT) {
    stage[e] = 0.0f;
    stage[C * K + e] = 0.0f;
    stage[2 * C * K + e] = 1.0f;
  }
#pragma unroll 1
  for (int e = n * V + threadIdx.x; e < C * V; e += NT) {
    stage[3 * C * K + e] = 0.0f;
    stage[3 * C * K + C * V + e] = 0.0f;
  }
}

// this thread's tile of the saved state before chunk c, into registers
template <int K, int V>
__device__ __forceinline__ void bwd_load_tile(const float* __restrict__ ckpt,
                                              int64_t bh, int n_ckpt, int c,
                                              int i0, int j0,
                                              float (&t)[kRows][kCols]) {
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const float4 x =
        __ldg(reinterpret_cast<const float4*>(ckpt + ((bh * n_ckpt + c) * K + i0 + a) * V + j0));
    t[a][0] = x.x; t[a][1] = x.y; t[a][2] = x.z; t[a][3] = x.w;
  }
}

template <int K, int V>
__global__ void __launch_bounds__(bwd_threads<K, V>())
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ dy,
                const float* __restrict__ ckpt,
                const float* __restrict__ ds_fin, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du, int n_t) {
  constexpr int C = kCkptEvery;
  constexpr int NT = bwd_threads<K, V>();
  constexpr int NQ = V / 4;        // column quads of a row
  constexpr int RP = K + 8;        // row-partial pitch
  constexpr int CP = bwd_col_pitch<V>();
  constexpr int SF = bwd_stage_floats<K, V>();
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);  // [2][SF]
  float* rowp = stages + 2 * SF;                    // [C][3][NQ][RP]
  float* colp = rowp + C * 3 * NQ * RP;             // [C][K / 2][CP]
  float* sdyv = colp + C * (K / 2) * CP;            // [C]
  float* srku = sdyv + C;                           // [C]
  float* su = srku + C;                             // [K]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wr = warp / (V / 16);
  const int wc = warp % (V / 16);
  const int i0 = wr * 16 + (lane >> 2) * kRows;
  const int cq = wc * 4 + (lane & 3);  // this thread's column quad
  const int j0 = cq * kCols;
  const int64_t bh = blockIdx.x;
  const int64_t rk_base = bh * n_t * K;
  const int64_t v_base = bh * n_t * V;
  const int n_ckpt = (n_t + C - 1) / C;
#pragma unroll 1
  for (int e = tid; e < K; e += NT) su[e] = u[bh * K + e];

  float ds[kRows][kCols];  // this thread's tile of dS_t
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
#pragma unroll
    for (int b = 0; b < kCols; ++b) {
      ds[a][b] = ds_fin != nullptr ? ds_fin[(bh * K + i0 + a) * V + j0 + b]
                                   : 0.0f;
    }
  }
  float du_acc = 0.0f;  // du[du_i], summed by the thread that owns it
  const int du_i = tid - (NT - K);

  // chunk c's inputs are staged in half (c & 1) of `stages`; the saved
  // state it starts from is loaded into `ck` one chunk ahead
  float ck[kRows][kCols];
  bwd_fetch<K, V>(r, k, v, w, dy, stages + ((n_ckpt - 1) & 1) * SF, bh, n_t,
                  n_ckpt - 1);
  bwd_load_tile<K, V>(ckpt, bh, n_ckpt, n_ckpt - 1, i0, j0, ck);
  for (int c = n_ckpt - 1; c >= 0; --c) {
    const int t0 = c * C;
    const int n = min(C, n_t - t0);
    const float* st_r = stages + (c & 1) * SF;  // [C][K]
    const float* st_k = st_r + C * K;
    const float* st_w = st_k + C * K;
    const float* st_v = st_w + C * K;           // [C][V]
    const float* st_dy = st_v + C * V;
    cp_async_wait_all();
    __syncthreads();  // chunk c's inputs have landed, for every thread; the
                      // previous chunk's partials are summed
    float s[kRows][kCols];  // S_{t0-1}
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
#pragma unroll
      for (int b = 0; b < kCols; ++b) s[a][b] = ck[a][b];
    }
    if (c > 0) {
      bwd_fetch<K, V>(r, k, v, w, dy, stages + ((c - 1) & 1) * SF, bh, n_t,
                      c - 1);
      bwd_load_tile<K, V>(ckpt, bh, n_ckpt, c - 1, i0, j0, ck);
    }

    // the per-step scalars dy_t . v_t and sum_i r_t[i] u_i k_t[i], one
    // warp a sum
#pragma unroll 1
    for (int d = warp; d < 2 * C; d += NT / 32) {
      const int tt = d >> 1;
      float x = 0.0f;
      if (d & 1) {
        for (int q = lane; q < K; q += 32) {
          x = __fmaf_rn(st_r[tt * K + q] * su[q], st_k[tt * K + q], x);
        }
      } else {
        for (int q = lane; q < V; q += 32) {
          x = __fmaf_rn(st_dy[tt * V + q], st_v[tt * V + q], x);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
      if (lane == 0) (d & 1 ? srku : sdyv)[tt] = x;
    }

    // S_{t-1} for the chunk's steps, this thread's tile, in registers
    float sp[C][kRows][kCols];
#pragma unroll
    for (int tt = 0; tt < C; ++tt) {
      const float2 k2 = *reinterpret_cast<const float2*>(st_k + tt * K + i0);
      const float2 w2 = *reinterpret_cast<const float2*>(st_w + tt * K + i0);
      const float4 v4 = *reinterpret_cast<const float4*>(st_v + tt * V + j0);
      const float kk[2] = {k2.x, k2.y}, ww[2] = {w2.x, w2.y};
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
#pragma unroll
        for (int b = 0; b < kCols; ++b) {
          sp[tt][a][b] = s[a][b];
          s[a][b] = __fadd_rn(__fmul_rn(ww[a], s[a][b]),
                              __fmul_rn(kk[a], vv[b]));
        }
      }
    }

    // the reverse recurrence; each step leaves this thread's partial sums
    // in shared memory and goes on
#pragma unroll
    for (int tt = C - 1; tt >= 0; --tt) {
      const float2 r2 = *reinterpret_cast<const float2*>(st_r + tt * K + i0);
      const float2 k2 = *reinterpret_cast<const float2*>(st_k + tt * K + i0);
      const float2 w2 = *reinterpret_cast<const float2*>(st_w + tt * K + i0);
      const float4 v4 = *reinterpret_cast<const float4*>(st_v + tt * V + j0);
      const float4 y4 = *reinterpret_cast<const float4*>(st_dy + tt * V + j0);
      const float rr[2] = {r2.x, r2.y}, kk[2] = {k2.x, k2.y};
      const float ww[2] = {w2.x, w2.y};
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
      const float yy[4] = {y4.x, y4.y, y4.z, y4.w};
      // over this thread's 4 columns, for each of its 2 rows: the shares
      // of dr (dy . S_{t-1}), dk (dS . v) and dw (dS . S_{t-1})
      float p[3][kRows];
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        float pr = 0.0f, pk = 0.0f, pw = 0.0f;
#pragma unroll
        for (int b = 0; b < kCols; ++b) {
          pr = __fmaf_rn(yy[b], sp[tt][a][b], pr);
          pk = __fmaf_rn(ds[a][b], vv[b], pk);
          pw = __fmaf_rn(ds[a][b], sp[tt][a][b], pw);
        }
        p[0][a] = pr;
        p[1][a] = pk;
        p[2][a] = pw;
      }
      // over its 2 rows, for each of its 4 columns: the share of dv
      float pv[kCols];
#pragma unroll
      for (int b = 0; b < kCols; ++b) {
        pv[b] = __fmaf_rn(ds[1][b], kk[1], ds[0][b] * kk[0]);
      }
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
#pragma unroll
        for (int b = 0; b < kCols; ++b) {
          ds[a][b] = __fadd_rn(__fmul_rn(ww[a], ds[a][b]),
                               __fmul_rn(rr[a], yy[b]));
        }
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        *reinterpret_cast<float2*>(rowp + ((tt * 3 + q) * NQ + cq) * RP + i0) =
            make_float2(p[q][0], p[q][1]);
      }
      *reinterpret_cast<float4*>(colp + (tt * (K / 2) + i0 / 2) * CP + j0) =
          make_float4(pv[0], pv[1], pv[2], pv[3]);
    }
    __syncthreads();  // every thread's partials of the chunk are written

    // the chunk's outputs, two at a time: a pair of rows (dr, dk, dw) or of
    // columns (dv) for each thread, the partials summed in a fixed order
#pragma unroll 1
    for (int e = tid; e < n * (K + V) / 2; e += NT) {
      if (e < n * K / 2) {
        const int tt = e / (K / 2);
        const int i = 2 * (e % (K / 2));
        float2 a = make_float2(0.0f, 0.0f), b = a, cw = a;
        const float* pq = rowp + tt * 3 * NQ * RP + i;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float2 x = *reinterpret_cast<const float2*>(pq + q * RP);
          const float2 z = *reinterpret_cast<const float2*>(pq + (NQ + q) * RP);
          const float2 c = *reinterpret_cast<const float2*>(pq + (2 * NQ + q) * RP);
          a.x += x.x; a.y += x.y;
          b.x += z.x; b.y += z.y;
          cw.x += c.x; cw.y += c.y;
        }
        const float dyv = sdyv[tt];
        const int64_t o = rk_base + static_cast<int64_t>(t0 + tt) * K + i;
        *reinterpret_cast<float2*>(dr + o) =
            make_float2(a.x + su[i] * st_k[tt * K + i] * dyv,
                        a.y + su[i + 1] * st_k[tt * K + i + 1] * dyv);
        *reinterpret_cast<float2*>(dk + o) =
            make_float2(b.x + su[i] * st_r[tt * K + i] * dyv,
                        b.y + su[i + 1] * st_r[tt * K + i + 1] * dyv);
        *reinterpret_cast<float2*>(dw + o) = cw;
      } else {
        const int e2 = e - n * K / 2;
        const int tt = e2 / (V / 2);
        const int j = 2 * (e2 % (V / 2));
        float2 sum = make_float2(0.0f, 0.0f);
        const float* pq = colp + tt * (K / 2) * CP + j;
#pragma unroll
        for (int q = 0; q < K / 2; ++q) {
          const float2 x = *reinterpret_cast<const float2*>(pq + q * CP);
          sum.x += x.x;
          sum.y += x.y;
        }
        *reinterpret_cast<float2*>(dv + v_base + static_cast<int64_t>(t0 + tt) * V + j) =
            make_float2(sum.x + srku[tt] * st_dy[tt * V + j],
                        sum.y + srku[tt] * st_dy[tt * V + j + 1]);
      }
    }
    if (du_i >= 0) {  // the last K threads, whose output pairs are dv's
#pragma unroll
      for (int tt = C - 1; tt >= 0; --tt) {
        if (tt < n) du_acc += st_r[tt * K + du_i] * st_k[tt * K + du_i] * sdyv[tt];
      }
    }
  }
  if (du_i >= 0) du[bh * K + du_i] = du_acc;
}

template <int K, int V, typename T>
int launch_fwd(const void* r, const void* k, const void* v, const void* w,
               const void* u, void* y, void* s_fin, void* ckpt, int bh,
               int n_t, cudaStream_t stream) {
  const dim3 grid(bh, V / kFwdCols);
  wkv6_fwd_kernel<K, V, T><<<grid, fwd_threads<K>(), 0, stream>>>(
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
  wkv6_bwd_kernel<K, V><<<bh, bwd_threads<K, V>(), bytes, stream>>>(
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
