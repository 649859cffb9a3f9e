// Fused masked-Huber TD loss for Hopper (sm_90a), bound to Python with ctypes.
//
// Inputs: q [B, A] float32 (row-major), actions [B] int32, targets and
// weights [B] float32, the Huber threshold delta. The action gather is the
// reference's one-hot contraction: q_sa[b] = sum_a q[b, a] * (a == a_b).
// An action outside [0, A) therefore gives q_sa = 0 and a zero gradient
// row, and the kernels never index q by the action.
//
// fused_loss_fwd — replaces the TPU kernel `_fwd_kernel` / `_call_fwd` in
//   distributed_deep_q_tpu/ops/pallas_kernels.py (B3).
//   td = q_sa - t;  m = min(|td|, delta);
//   huber = 0.5*m*m + delta*(|td| - m);
//   loss = mean_b(w * huber) (a scalar);  td_abs[b] = |td|.
//   Bound: bytes, but tiny (B = 512, A = 4: 14.3 KB read, 2 KB written,
//   about 5 ns at 3.35 TB/s), so in practice launch-bound: what counts is
//   how few dependent steps lie between the launch and the last store.
//   Design: ONE block of 512 threads, no atomics; thread t takes rows
//   t, t + 512, ... For the head widths the presets use (A = 2, 4, 6, 18)
//   the row is one instance of a template, loaded into registers with
//   vector loads together with the action, target and weight, so a row
//   costs one round trip to memory whatever A is; other widths take the
//   runtime-A loop. At A = 4 a row is one float4 and a warp's loads are
//   coalesced; at 2, 6 and 18 they would be strided, and with the whole
//   kernel on one SM that costs, so the block first copies q (512 rows at
//   a time, 36 KB at A = 18) into shared memory with coalesced float4
//   loads. Each thread keeps its own partial sum; the block sums the
//   partials in one pass, a shared-memory stage then one warp (lane l adds
//   partials l, l + 32, ... in order, then a shuffle tree), so the loss is
//   the same bits on every run. The first design (a runtime-A loop of
//   scalar loads, two levels of shuffles) took ~1.0 µs above an empty
//   launch at A = 4 and ~1.7 µs at A = 18 on an H100 (PERF.md §6).
//
// fused_loss_bwd — replaces `_bwd_kernel` / `_bwd_rule` in the same file
//   (B4). Recomputes td (cheaper than storing it) and writes
//   dq[b, a] = onehot(a_b)[a] * (((g * w_b) * clip(td_b, -delta, delta)) / B)
//   over the whole [B, A]. g, the incoming gradient of the loss, is read
//   from device memory, so the host never waits on it. Bound: bytes, but
//   tiny (22.5 KB at B = 512, A = 4; about 7 ns at 3.35 TB/s), so
//   launch-bound like B3: what counts is the dependent steps between the
//   launch and the last store. Design: one thread per row in blocks of
//   kBwdThreads (B = 512 spreads over 4 SMs), the row's whole work in one
//   round trip to memory: its Q-values (vector loads, as in B3), action,
//   target and weight, and g, all issued before the first use; the
//   coefficient computed once; the dq row written with vector stores.
//   Templated on the presets' head widths (2, 4, 6, 18); other widths, and
//   a q or dq that is not 16-byte aligned, take a runtime-A loop. At A = 18
//   a thread's own 72-byte row is a strided access, so the block stages its
//   rows of q through shared memory with coalesced float4 loads and writes
//   dq back the same way; at A = 2 and 6 direct rows were faster (PERF.md
//   §6 has the candidates' times). A grid-stride loop with int64 offsets
//   keeps B·A past 2³¹ right. Every element of dq is the multiply
//   (1 or 0) · coeff, never a select: a NaN coefficient fills its row with
//   NaN and a negative one leaves -0.0 off the action, as the reference's
//   onehot * coeff does. The first design (one thread per element of dq, a
//   64-bit division per element, the row re-read A times) took 0.8 µs
//   above an empty launch at A = 4 and 1.1 µs at A = 18 on an H100; this
//   one 0.26 and 0.68 µs.
//
// Rounding follows the reference's operation order. Every product, sum and
// quotient that feeds td_abs or dq is an explicit round-to-nearest
// intrinsic, so nvcc cannot contract it into an FMA: td_abs and dq equal
// the plain PyTorch version bit for bit; the loss differs from it only by
// the order of the batch sum. The clip and min are written as comparisons
// that pass a NaN through, as jnp.clip and jnp.minimum do.
//
// Each C entry launches on the caller's stream and returns
// cudaGetLastError() (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFwdThreads = 512;
constexpr int kBwdThreads = 128;
constexpr int64_t kMaxGrid = 1 << 16;

// the reference's one-hot contraction over row b, in column order
__device__ __forceinline__ float q_at_action(const float* __restrict__ q,
                                             int64_t b, int a, int A) {
  const float* row = q + b * A;
  float s = 0.0f;
  for (int c = 0; c < A; ++c)
    s = __fadd_rn(s, __fmul_rn(row[c], c == a ? 1.0f : 0.0f));
  return s;
}

// a row's A Q-values into registers, with the widest vector load the row's
// alignment allows (rows of global q are 16-byte aligned when A % 4 == 0,
// rows staged in shared memory are 8-byte aligned for even A)
template <int A>
__device__ __forceinline__ void load_row(const float* __restrict__ row,
                                         float (&v)[A]) {
  if constexpr (A % 4 == 0) {
#pragma unroll
    for (int c = 0; c < A; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(row + c);
      v[c] = x.x, v[c + 1] = x.y, v[c + 2] = x.z, v[c + 3] = x.w;
    }
  } else if constexpr (A % 2 == 0) {
#pragma unroll
    for (int c = 0; c < A; c += 2) {
      const float2 x = *reinterpret_cast<const float2*>(row + c);
      v[c] = x.x, v[c + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < A; ++c) v[c] = row[c];
  }
}

// q_at_action over a row already in registers: the same column-order sum
template <int A>
__device__ __forceinline__ float q_at_action_row(const float (&v)[A], int a) {
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < A; ++c)
    s = __fadd_rn(s, __fmul_rn(v[c], c == a ? 1.0f : 0.0f));
  return s;
}

// Copies a chunk of n floats of q (16-byte aligned, n <= T · A) into the
// block's `stage` with coalesced float4 loads, T threads. Every load is
// issued before the first barrier, which waits until the block is done
// with the stage's previous contents, so a chunk costs one round trip.
template <int A, int T>
__device__ __forceinline__ void stage_chunk(const float* __restrict__ chunk,
                                            int n, float* stage, int tid) {
  // float4 loads per thread (5 at A = 18 with 512 threads)
  constexpr int kPer = (T * A / 4 + T - 1) / T;
  const int n4 = n / 4;
  float4 x[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (tid + j * T < n4)
      x[j] = __ldg(reinterpret_cast<const float4*>(chunk) + tid + j * T);
  const float tail = 4 * n4 + tid < n ? __ldg(chunk + 4 * n4 + tid) : 0.f;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (tid + j * T < n4) reinterpret_cast<float4*>(stage)[tid + j * T] = x[j];
  if (4 * n4 + tid < n) stage[4 * n4 + tid] = tail;
  __syncthreads();
}

// A > 0: the head width, fixed at compile time; A == 0: `a_rt` at run time.
// Thread t takes rows t, t + kFwdThreads, ..., one chunk of kFwdThreads rows
// at a time. At a width whose rows are not 16-byte multiples (2, 6, 18) a
// thread's own row is a strided, uncoalesced read, and the whole kernel runs
// on one SM; so the block first copies the chunk's q into shared memory
// with coalesced 16-byte loads, and each thread reads its row from there.
template <int A>
__global__ void __launch_bounds__(kFwdThreads)
fused_loss_fwd_kernel(const float* __restrict__ q,
                      const int32_t* __restrict__ actions,
                      const float* __restrict__ targets,
                      const float* __restrict__ weights,
                      float* __restrict__ loss, float* __restrict__ td_abs,
                      int64_t B, int a_rt, float delta) {
  constexpr bool kStage = A > 0 && A % 4 != 0;
  __shared__ float partial[kFwdThreads];
  __shared__ __align__(16) float stage[kStage ? kFwdThreads * A : 4];
  const int tid = threadIdx.x;
  float acc = 0.0f;
  for (int64_t base = 0; base < B; base += kFwdThreads) {
    const int64_t b = base + tid;
    const int64_t rows = B - base < kFwdThreads ? B - base : kFwdThreads;
    // the row's other operands are loaded with the staged chunk, so every
    // global load of the chunk is in flight at once
    const bool live = tid < rows;
    const int a = live ? actions[b] : 0;
    const float t = live ? targets[b] : 0.f, w = live ? weights[b] : 0.f;
    if constexpr (kStage) {
      // q's chunk starts at a multiple of kFwdThreads · A floats: 16-byte
      // aligned, as q is
      stage_chunk<A, kFwdThreads>(q + base * A, static_cast<int>(rows) * A,
                                  stage, tid);
    }
    if (!live) continue;
    float q_sa;
    if constexpr (A == 0) {
      q_sa = q_at_action(q, b, a, a_rt);
    } else {
      float v[A];
      load_row<A>(kStage ? stage + tid * A : q + b * A, v);
      q_sa = q_at_action_row<A>(v, a);
    }
    const float td = __fsub_rn(q_sa, t);
    const float abs_td = fabsf(td);
    const float m = abs_td > delta ? delta : abs_td;
    const float huber = __fadd_rn(__fmul_rn(__fmul_rn(0.5f, m), m),
                                  __fmul_rn(delta, __fsub_rn(abs_td, m)));
    acc = __fadd_rn(acc, __fmul_rn(w, huber));
    td_abs[b] = abs_td;
  }
  partial[tid] = acc;
  __syncthreads();
  if (tid < 32) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kFwdThreads / 32; ++i)
      s = __fadd_rn(s, partial[i * 32 + tid]);
    for (int off = 16; off > 0; off >>= 1)
      s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    if (tid == 0) loss[0] = __fdiv_rn(s, static_cast<float>(B));
  }
}

// the reference's backward coefficient ((g * w) * clip(td, ±delta)) / B,
// with a clip that passes a NaN through
__device__ __forceinline__ float bwd_coeff(float q_sa, float t, float w,
                                           float gv, float delta,
                                           float batch) {
  const float td = __fsub_rn(q_sa, t);
  const float dhuber = td < -delta ? -delta : (td > delta ? delta : td);
  return __fdiv_rn(__fmul_rn(__fmul_rn(gv, w), dhuber), batch);
}

// dq's row: every column the multiply onehot · coeff, stored with the
// widest vector store the row's alignment allows (as load_row reads)
template <int A>
__device__ __forceinline__ void store_dq_row(float* __restrict__ row, int a,
                                             float coeff) {
  float v[A];
#pragma unroll
  for (int c = 0; c < A; ++c) v[c] = __fmul_rn(c == a ? 1.0f : 0.0f, coeff);
  if constexpr (A % 4 == 0) {
#pragma unroll
    for (int c = 0; c < A; c += 4)
      *reinterpret_cast<float4*>(row + c) =
          make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
  } else if constexpr (A % 2 == 0) {
#pragma unroll
    for (int c = 0; c < A; c += 2)
      *reinterpret_cast<float2*>(row + c) = make_float2(v[c], v[c + 1]);
  } else {
#pragma unroll
    for (int c = 0; c < A; ++c) row[c] = v[c];
  }
}

// A > 0: the head width, fixed at compile time; A == 0: `a_rt` at run time.
// One thread per row, rows b = blockIdx.x * T + threadIdx.x, then a grid
// stride. At A = 18 (kStage) the block copies its T rows of q into shared
// memory with coalesced float4 loads, each thread computes its row there
// and writes its dq row back in place, and the block stores the chunk with
// coalesced float4 stores; at other widths each thread reads and writes
// its own row directly.
template <int A>
__global__ void __launch_bounds__(kBwdThreads)
fused_loss_bwd_kernel(const float* __restrict__ q,
                      const int32_t* __restrict__ actions,
                      const float* __restrict__ targets,
                      const float* __restrict__ weights,
                      const float* __restrict__ g, float* __restrict__ dq,
                      int64_t B, int a_rt, float delta) {
  constexpr int T = kBwdThreads;
  constexpr bool kStage = A == 18;
  const float gv = g[0];
  const float batch = static_cast<float>(B);
  const int tid = threadIdx.x;
  if constexpr (kStage) {
    __shared__ __align__(16) float stage[T * A];
    for (int64_t base = static_cast<int64_t>(blockIdx.x) * T; base < B;
         base += static_cast<int64_t>(gridDim.x) * T) {
      const int64_t b = base + tid;
      const int64_t rows = B - base < T ? B - base : T;
      const bool live = tid < rows;
      const int a = live ? actions[b] : 0;
      const float t = live ? targets[b] : 0.f, w = live ? weights[b] : 0.f;
      // the chunk starts at a multiple of T · A floats: 16-byte aligned, as
      // q and dq are
      const int n = static_cast<int>(rows) * A, n4 = n / 4;
      stage_chunk<A, T>(q + base * A, n, stage, tid);
      if (live) {
        float v[A];
        load_row<A>(stage + tid * A, v);
        store_dq_row<A>(stage + tid * A, a,
                        bwd_coeff(q_at_action_row<A>(v, a), t, w, gv, delta,
                                  batch));
      }
      __syncthreads();
      float* out = dq + base * A;
      for (int j = tid; j < n4; j += T)
        reinterpret_cast<float4*>(out)[j] =
            reinterpret_cast<const float4*>(stage)[j];
      if (4 * n4 + tid < n) out[4 * n4 + tid] = stage[4 * n4 + tid];
    }
  } else {
    for (int64_t b = static_cast<int64_t>(blockIdx.x) * T + tid; b < B;
         b += static_cast<int64_t>(gridDim.x) * T) {
      const int a = actions[b];
      const float t = targets[b], w = weights[b];
      if constexpr (A == 0) {
        const float coeff =
            bwd_coeff(q_at_action(q, b, a, a_rt), t, w, gv, delta, batch);
        float* row = dq + b * a_rt;
        for (int c = 0; c < a_rt; ++c)
          row[c] = __fmul_rn(c == a ? 1.0f : 0.0f, coeff);
      } else {
        float v[A];
        load_row<A>(q + b * A, v);
        store_dq_row<A>(dq + b * A, a,
                        bwd_coeff(q_at_action_row<A>(v, a), t, w, gv, delta,
                                  batch));
      }
    }
  }
}

}  // namespace

extern "C" int ddq_fused_loss_fwd(const void* q, const void* actions,
                                  const void* targets, const void* weights,
                                  void* loss, void* td_abs, long long B,
                                  int A, float delta, void* stream) {
  if (B <= 0 || A <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* act = static_cast<const int32_t*>(actions);
  const auto* t = static_cast<const float*>(targets);
  const auto* w = static_cast<const float*>(weights);
  auto* l = static_cast<float*>(loss);
  auto* ta = static_cast<float*>(td_abs);
  const auto s = static_cast<cudaStream_t>(stream);
  // the vector loads need q 16-byte aligned; any other q takes the loop
  switch (reinterpret_cast<uintptr_t>(q) % 16 ? 0 : A) {
    case 2:
      fused_loss_fwd_kernel<2><<<1, kFwdThreads, 0, s>>>(qf, act, t, w, l, ta,
                                                        B, A, delta);
      break;
    case 4:
      fused_loss_fwd_kernel<4><<<1, kFwdThreads, 0, s>>>(qf, act, t, w, l, ta,
                                                        B, A, delta);
      break;
    case 6:
      fused_loss_fwd_kernel<6><<<1, kFwdThreads, 0, s>>>(qf, act, t, w, l, ta,
                                                        B, A, delta);
      break;
    case 18:
      fused_loss_fwd_kernel<18><<<1, kFwdThreads, 0, s>>>(qf, act, t, w, l,
                                                         ta, B, A, delta);
      break;
    default:
      fused_loss_fwd_kernel<0><<<1, kFwdThreads, 0, s>>>(qf, act, t, w, l, ta,
                                                        B, A, delta);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ddq_fused_loss_bwd(const void* q, const void* actions,
                                  const void* targets, const void* weights,
                                  const void* g, void* dq, long long B, int A,
                                  float delta, void* stream) {
  if (B <= 0 || A <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* act = static_cast<const int32_t*>(actions);
  const auto* t = static_cast<const float*>(targets);
  const auto* w = static_cast<const float*>(weights);
  const auto* gf = static_cast<const float*>(g);
  auto* out = static_cast<float*>(dq);
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (B + kBwdThreads - 1) / kBwdThreads;
  const unsigned grid =
      static_cast<unsigned>(blocks < kMaxGrid ? blocks : kMaxGrid);
  // the vector loads and stores need q and dq 16-byte aligned; any other
  // pair takes the loop
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(dq)) % 16) == 0;
  switch (aligned ? A : 0) {
    case 2:
      fused_loss_bwd_kernel<2><<<grid, kBwdThreads, 0, s>>>(
          qf, act, t, w, gf, out, B, A, delta);
      break;
    case 4:
      fused_loss_bwd_kernel<4><<<grid, kBwdThreads, 0, s>>>(
          qf, act, t, w, gf, out, B, A, delta);
      break;
    case 6:
      fused_loss_bwd_kernel<6><<<grid, kBwdThreads, 0, s>>>(
          qf, act, t, w, gf, out, B, A, delta);
      break;
    case 18:
      fused_loss_bwd_kernel<18><<<grid, kBwdThreads, 0, s>>>(
          qf, act, t, w, gf, out, B, A, delta);
      break;
    default:
      fused_loss_bwd_kernel<0><<<grid, kBwdThreads, 0, s>>>(
          qf, act, t, w, gf, out, B, A, delta);
  }
  return static_cast<int>(cudaGetLastError());
}
