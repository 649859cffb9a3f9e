// Native replay core — sum-tree inner loops (a copy of the reference's
// distributed_deep_q_tpu/native/replay_core.cpp, without its columnar
// staging memcpy, which the port's staging does not use).
//
// The host-side PER sampling is a pointer-chasing loop (root→leaf descent
// per sample lane), so it has a C++ core: the numpy implementation in
// replay/prioritized.py stays as the portable fallback and the semantic
// reference; this file must match it bit-for-bit on the float64 tree
// (tests/test_torch_host_replay.py asserts equivalence).
//
// Exposed via plain C ABI for ctypes. All buffers are caller-owned numpy
// arrays; nothing here allocates.

#include <cstdint>

extern "C" {

// Set leaves tree[size + idx[k]] = p[k] (duplicates: last write wins, same
// as numpy fancy assignment), then repair ancestors bottom-up.
void st_set(double* tree, int64_t size, const int64_t* idx, const double* p,
            int64_t n) {
  for (int64_t k = 0; k < n; ++k) {
    tree[size + idx[k]] = p[k];
  }
  for (int64_t k = 0; k < n; ++k) {
    for (int64_t node = (size + idx[k]) >> 1; node >= 1; node >>= 1) {
      tree[node] = tree[2 * node] + tree[2 * node + 1];
    }
  }
}

// Stratified proportional sampling: lane k draws target
// (k + urand[k]) * total / n and descends root→leaf.
// Matches SumTree.sample_stratified (replay/prioritized.py).
void st_sample_stratified(const double* tree, int64_t size,
                          const double* urand, int64_t* out, int64_t n) {
  const double total = tree[1];
  const double stride = total / static_cast<double>(n);
  for (int64_t k = 0; k < n; ++k) {
    double target = (static_cast<double>(k) + urand[k]) * stride;
    int64_t node = 1;
    while (node < size) {
      const int64_t left = 2 * node;
      const double left_sum = tree[left];
      // strict '>' to match the numpy descent (targets > left_sum)
      if (target > left_sum) {
        target -= left_sum;
        node = left + 1;
      } else {
        node = left;
      }
    }
    out[k] = node - size;
  }
}

}  // extern "C"
