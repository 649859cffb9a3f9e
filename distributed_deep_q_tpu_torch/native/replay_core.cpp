// Native replay core — sum-tree inner loops and the columnar staged append
// (a copy of the reference's distributed_deep_q_tpu/native/replay_core.cpp),
// plus a CRC-32C that the reference computes in numpy
// (utils/durability.py): the v4 wire's trailer and the snapshot
// manifests' checksums.
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
#include <cstring>

extern "C" {

// Columnar staged append: copy n rows of each of ncols columns into its
// caller-owned staging buffer at row `cursor`. dst[c] is the base of column
// c's staging buffer, src[c] the incoming contiguous segment, row_bytes[c]
// the column's row stride. One memcpy per column, not per row: a staged
// segment costs O(columns) calls and no per-row work. Returns the advanced
// cursor. Must stay bit-identical to the numpy version
// (`buf[cursor:cursor+n] = seg`), which remains the reference semantics
// (tests/test_torch_ingest_drain.py asserts equivalence).
int64_t staged_append(unsigned char* const* dst,
                      const unsigned char* const* src,
                      const int64_t* row_bytes, int64_t ncols,
                      int64_t cursor, int64_t n) {
  for (int64_t c = 0; c < ncols; ++c) {
    std::memcpy(dst[c] + cursor * row_bytes[c], src[c],
                static_cast<size_t>(n * row_bytes[c]));
  }
  return cursor + n;
}

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

// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78), slicing by 8:
// continues a finished checksum `crc` over `n` more bytes, so
// crc32c(crc32c(0, a), b) == crc32c(0, a || b). Must stay bit-identical to
// the numpy version in utils/durability.py (tests/test_torch_wire.py
// asserts equivalence on every length from 0 to 4,096 and beyond).
uint32_t crc32c(uint32_t crc, const unsigned char* buf, int64_t n) {
  static const struct Tables {
    uint32_t t[8][256];
    Tables() {
      for (uint32_t i = 0; i < 256; ++i) {
        uint32_t c = i;
        for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
        t[0][i] = c;
      }
      for (uint32_t i = 0; i < 256; ++i)
        for (int s = 1; s < 8; ++s)
          t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
    }
  } tab;
  const auto& t = tab.t;
  uint32_t c = ~crc;
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, buf + i, 4);
    std::memcpy(&hi, buf + i + 4, 4);
    lo ^= c;   // little-endian hosts only (x86-64, aarch64)
    c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
        t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
        t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
  }
  for (; i < n; ++i) c = t[0][(c ^ buf[i]) & 0xFF] ^ (c >> 8);
  return ~c;
}

}  // extern "C"
