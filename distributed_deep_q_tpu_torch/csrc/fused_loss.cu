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
//   about 5 ns at 3.35 TB/s), so in practice launch-bound. Design: ONE
//   block, no atomics. Each thread walks rows b = tid, tid + 512, ... and
//   keeps its own partial sum; the block then sums the partials with warp
//   shuffles in a fixed tree, so the loss is the same bits on every run.
//
// fused_loss_bwd — replaces `_bwd_kernel` / `_bwd_rule` in the same file
//   (B4). Recomputes td (cheaper than storing it) and writes
//   dq[b, a] = onehot(a_b)[a] * (((g * w_b) * clip(td_b, -delta, delta)) / B)
//   over the whole [B, A]. g, the incoming gradient of the loss, is read
//   from device memory, so the host never waits on it. Bound: bytes
//   (22.5 KB at B = 512, A = 4; about 7 ns), launch-bound. Design: one
//   thread per element of dq.
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
constexpr int kBwdThreads = 256;
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

__global__ void __launch_bounds__(kFwdThreads)
fused_loss_fwd_kernel(const float* __restrict__ q,
                      const int32_t* __restrict__ actions,
                      const float* __restrict__ targets,
                      const float* __restrict__ weights,
                      float* __restrict__ loss, float* __restrict__ td_abs,
                      int64_t B, int A, float delta) {
  __shared__ float warp_sums[kFwdThreads / 32];
  float acc = 0.0f;
  for (int64_t b = threadIdx.x; b < B; b += kFwdThreads) {
    const float td = __fsub_rn(q_at_action(q, b, actions[b], A), targets[b]);
    const float abs_td = fabsf(td);
    const float m = abs_td > delta ? delta : abs_td;
    const float huber = __fadd_rn(__fmul_rn(__fmul_rn(0.5f, m), m),
                                  __fmul_rn(delta, __fsub_rn(abs_td, m)));
    acc = __fadd_rn(acc, __fmul_rn(weights[b], huber));
    td_abs[b] = abs_td;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kFwdThreads / 32 ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
    if (lane == 0) loss[0] = __fdiv_rn(acc, static_cast<float>(B));
  }
}

__global__ void __launch_bounds__(kBwdThreads)
fused_loss_bwd_kernel(const float* __restrict__ q,
                      const int32_t* __restrict__ actions,
                      const float* __restrict__ targets,
                      const float* __restrict__ weights,
                      const float* __restrict__ g, float* __restrict__ dq,
                      int64_t B, int A, float delta) {
  const float gv = g[0];
  const float batch = static_cast<float>(B);
  const int64_t n = B * A;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kBwdThreads +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * kBwdThreads) {
    const int64_t b = i / A;
    const int col = static_cast<int>(i - b * A);
    const int a = actions[b];
    const float td = __fsub_rn(q_at_action(q, b, a, A), targets[b]);
    const float dhuber = td < -delta ? -delta : (td > delta ? delta : td);
    const float coeff = __fdiv_rn(
        __fmul_rn(__fmul_rn(gv, weights[b]), dhuber), batch);
    dq[i] = __fmul_rn(col == a ? 1.0f : 0.0f, coeff);
  }
}

}  // namespace

extern "C" int ddq_fused_loss_fwd(const void* q, const void* actions,
                                  const void* targets, const void* weights,
                                  void* loss, void* td_abs, long long B,
                                  int A, float delta, void* stream) {
  if (B <= 0 || A <= 0) return static_cast<int>(cudaErrorInvalidValue);
  fused_loss_fwd_kernel<<<1, kFwdThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int32_t*>(actions),
      static_cast<const float*>(targets), static_cast<const float*>(weights),
      static_cast<float*>(loss), static_cast<float*>(td_abs), B, A, delta);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ddq_fused_loss_bwd(const void* q, const void* actions,
                                  const void* targets, const void* weights,
                                  const void* g, void* dq, long long B, int A,
                                  float delta, void* stream) {
  if (B <= 0 || A <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(B) * A;
  const int64_t blocks = (n + kBwdThreads - 1) / kBwdThreads;
  fused_loss_bwd_kernel<<<static_cast<unsigned>(
                              blocks < kMaxGrid ? blocks : kMaxGrid),
                          kBwdThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int32_t*>(actions),
      static_cast<const float*>(targets), static_cast<const float*>(weights),
      static_cast<const float*>(g), static_cast<float*>(dq), B, A, delta);
  return static_cast<int>(cudaGetLastError());
}
