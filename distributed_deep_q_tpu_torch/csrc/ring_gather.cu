// Frame-ring copy kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// The replay's frame plane is ONE flat int32 array: each frame row holds the
// frame's pixel bytes packed 4 per int32 and padded to `rowb` bytes (a
// multiple of 4096), and every sub-ring carries ghost rows so that a
// sample's stack+n_step window is one contiguous run of rows
// (replay/device_per.py). Both kernels are therefore pure indexed copies of
// 16-byte-aligned contiguous runs.
//
// gather_windows — replaces the TPU kernel `_gather_kernel` /
//   `gather_windows` in distributed_deep_q_tpu/ops/ring_gather.py, which
//   pipelined one DMA per window over 64 semaphores.
//   out[k] = ring[idx[k]·rowb .. idx[k]·rowb + w·rowb) for k < n.
//   Bound: bytes. It reads and writes n·w·rowb bytes (Pong preset: n = 512
//   windows of 5 × 8192 B → 41.9 MB moved, 12.5 µs at 3.35 TB/s). Design:
//   one 256-thread block per window (grid-stride past 2^20 windows), each
//   thread moving 16 B per access with consecutive threads on consecutive
//   addresses, ring loads through the read-only path, the loop unrolled so
//   each thread keeps several loads in flight. n blocks of 40 KB each are
//   enough to keep all 132 SMs streaming.
//   The R2D2 sequence ring (replay/device_sequence.py) asks for n = 64
//   windows of 84 × 8192 = 688,128 B per ring step: 64 blocks left 68 of
//   the SMs idle and took 57 µs against a 26.3 µs bound (NVIDIA H100 80GB
//   HBM3, 700 W power limit; all times here from that card). The
//   grid's second dimension now cuts a window into chunks of
//   kGatherChunkBytes = 64 KB, one block each: 11 per sequence window,
//   34.7 µs. A 40 KB frame window is one chunk, so the Pong launches are
//   unchanged. 64 KB was chosen among 16-128 KB (PERF.md §6).
//
// scatter_rows — replaces the TPU kernel `_scatter_kernel` / `scatter_rows`
//   in the same file (the replay flush). ring[dst[k]] ← staged[src[k]],
//   row by row, in place. Ghost lanes re-send a staged row to its mirror
//   row; padding lanes all target the ring's scratch row, whose contents are
//   unspecified by contract; distinct real targets are the caller's
//   invariant. The lane count stays 2·write_chunk, as in the reference.
//   Bound: the bytes the data needs. A padding lane needs none, so it is
//   (distinct staged rows sent by real lanes + distinct real targets) × rowb
//   + the two index vectors. The Pong flush has two shapes: a chunk filled
//   while acting (66 real lanes of 128: 1.05 MB, 0.31 µs at 3.35 TB/s) and,
//   in most launches, the flush before each dispatch (4 real lanes: 66 KB,
//   0.02 µs). Both are launch-bound.
//   The first design gave every lane a block that copied a whole row,
//   padding lanes included, so the pre-dispatch flush wrote 124 copies of
//   8 KB onto the one scratch row: 4.2 µs there against 3.5 µs for the
//   fill chunk, on an H100. Now the caller names the scratch row
//   (`skip_row`) and a lane that targets it returns before any load; a
//   real lane loads its whole row into registers (2 × 16 B per thread at
//   8 KB rows, all in flight) before it stores: 2.6–2.75 µs at both
//   shapes, 0.6–0.8 µs above an empty kernel. What is left is two
//   dependent round trips (the lane's indices, then its row) and the
//   store. A TMA design (one thread per row: a 1-D bulk copy
//   global→shared on an mbarrier, then shared→global) measured 0.1–0.2 µs
//   slower at both shapes and was not kept (PERF.md §6).
//   The sequence flush has 4 lanes of one 688,128-byte sequence slot each,
//   usually 1 real: a block per lane streamed it through one SM in 16.6 µs
//   (bound 0.41 µs). Each lane's row is now cut into chunks of
//   kScatterChunkBytes = 32 KB on the grid's second dimension, one block
//   each (22 per slot): 3.1 µs. A lane aimed at `skip_row` moves nothing
//   in any of its chunks; an 8 KB frame row is one chunk. 32 KB was chosen
//   among 16-128 KB (PERF.md §6).
//
// Offsets: the Pong ring is 1,000,005 rows × 8192 B = 8.19 GB, so a row's
// byte offset passes 2^31 from row 262,144 on; the r2d2 preset's sequence
// ring is 12,501 × 688,128 B = 8.6 GB. Every offset is computed in 64
// bits. A window or lane whose index falls outside its array is a caller
// bug: the gather writes zeros for it and the scatter skips it, instead of
// faulting.
//
// Each C entry launches on the caller's stream and returns
// cudaGetLastError() (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCopyUnroll = 4;     // 16-byte loads in flight per thread
constexpr int64_t kMaxGrid = 1 << 20;
constexpr int64_t kMaxChunks = 65535;   // gridDim.y's limit
// bytes per block on the grid's second dimension
constexpr int64_t kGatherChunkBytes = 64 * 1024;
constexpr int64_t kScatterChunkBytes = 32 * 1024;

// [lo, hi) of the 16-byte vectors of a `len_vec` run that block row
// blockIdx.y copies: chunk c of `chunk_vec` vectors
__device__ __forceinline__ void chunk_span(int64_t len_vec, int64_t chunk_vec,
                                           int64_t& lo, int64_t& hi) {
  lo = static_cast<int64_t>(blockIdx.y) * chunk_vec;
  hi = lo + chunk_vec < len_vec ? lo + chunk_vec : len_vec;
}

__global__ void __launch_bounds__(kThreads)
gather_windows_kernel(const int32_t* __restrict__ idx,
                      const int4* __restrict__ ring,
                      int4* __restrict__ out,
                      int64_t n, int64_t w, int64_t row_vec,
                      int64_t ring_rows, int64_t chunk_vec) {
  const int64_t win_vec = w * row_vec;
  int64_t lo, hi;
  chunk_span(win_vec, chunk_vec, lo, hi);
  for (int64_t k = blockIdx.x; k < n; k += gridDim.x) {
    const int64_t start = static_cast<int64_t>(idx[k]);
    int4* dst = out + k * win_vec;
    if (start < 0 || start + w > ring_rows) {
      for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads)
        dst[i] = make_int4(0, 0, 0, 0);
      continue;
    }
    const int4* src = ring + start * row_vec;
#pragma unroll 4
    for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads)
      dst[i] = __ldg(src + i);
  }
}

// the lane's (source, target) rows, or false for a lane that moves nothing:
// one aimed at `skip_row`, or one outside its array
__device__ __forceinline__ bool lane_rows(const int32_t* __restrict__ src_idx,
                                          const int32_t* __restrict__ dst_idx,
                                          int64_t k, int64_t staged_rows,
                                          int64_t ring_rows, int64_t skip_row,
                                          int64_t& s, int64_t& d) {
  d = static_cast<int64_t>(dst_idx[k]);
  s = static_cast<int64_t>(src_idx[k]);
  return d != skip_row && d >= 0 && d < ring_rows && s >= 0 &&
         s < staged_rows;
}

__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const int32_t* __restrict__ src_idx,
                    const int32_t* __restrict__ dst_idx,
                    const int4* __restrict__ staged,
                    int4* __restrict__ ring,
                    int64_t n, int64_t row_vec, int64_t staged_rows,
                    int64_t ring_rows, int64_t skip_row, int64_t chunk_vec) {
  int64_t lo, hi;
  chunk_span(row_vec, chunk_vec, lo, hi);
  for (int64_t k = blockIdx.x; k < n; k += gridDim.x) {
    int64_t s, d;
    if (!lane_rows(src_idx, dst_idx, k, staged_rows, ring_rows, skip_row, s,
                   d))
      continue;
    const int4* from = staged + s * row_vec;
    int4* to = ring + d * row_vec;
    for (int64_t base = lo + threadIdx.x; base < hi;
         base += kThreads * kCopyUnroll) {
      int4 v[kCopyUnroll];
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) {
        const int64_t i = base + u * kThreads;
        if (i < hi) v[u] = __ldg(from + i);
      }
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) {
        const int64_t i = base + u * kThreads;
        if (i < hi) to[i] = v[u];
      }
    }
  }
}

// (grid, chunk length in vectors) for n runs of len_vec vectors cut into
// chunks of chunk_bytes; the chunk grows if the run would need more than
// kMaxChunks
inline dim3 grid_for(int64_t n, int64_t len_vec, int64_t chunk_bytes,
                     int64_t& chunk_vec) {
  chunk_vec = chunk_bytes / 16;
  int64_t chunks = (len_vec + chunk_vec - 1) / chunk_vec;
  if (chunks > kMaxChunks) {
    chunk_vec = (len_vec + kMaxChunks - 1) / kMaxChunks;
    chunks = (len_vec + chunk_vec - 1) / chunk_vec;
  }
  if (chunks < 1) chunks = 1;
  return dim3(static_cast<unsigned>(n < kMaxGrid ? n : kMaxGrid),
              static_cast<unsigned>(chunks));
}

}  // namespace

extern "C" int ddq_gather_windows(const void* idx, const void* ring,
                                  void* out, long long n, long long w,
                                  long long rowb, long long ring_rows,
                                  void* stream) {
  if (n <= 0) return 0;
  int64_t chunk_vec;
  const dim3 grid = grid_for(n, w * (rowb / 16), kGatherChunkBytes,
                             chunk_vec);
  gather_windows_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const int4*>(ring),
      static_cast<int4*>(out), n, w, rowb / 16, ring_rows, chunk_vec);
  return static_cast<int>(cudaGetLastError());
}

// skip_row < 0: no lane is skipped for its target
extern "C" int ddq_scatter_rows(const void* src_idx, const void* dst_idx,
                                const void* staged, void* ring, long long n,
                                long long rowb, long long staged_rows,
                                long long ring_rows, long long skip_row,
                                void* stream) {
  if (n <= 0) return 0;
  int64_t chunk_vec;
  const dim3 grid = grid_for(n, rowb / 16, kScatterChunkBytes, chunk_vec);
  scatter_rows_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src_idx),
      static_cast<const int32_t*>(dst_idx),
      static_cast<const int4*>(staged), static_cast<int4*>(ring), n,
      rowb / 16, staged_rows, ring_rows, skip_row, chunk_vec);
  return static_cast<int>(cudaGetLastError());
}
