// Row scatter-add and row gather for the parameter-server tables, written
// for Hopper (sm_90a). Built by multiverso_tpu_torch/ops/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes: every entry point takes device pointers and the
// caller's stream as void*, sizes as int64_t, launches on that stream,
// allocates nothing and returns cudaGetLastError().
//
// Replaces the TPU kernels of multiverso_tpu/ops/pallas_rows.py:
//   scatter_add_rows            <- _scatter_add_call / _scatter_add_kernel
//   gather_rows                 <- _gather_call / _gather_kernel
//   scatter_add_rows_coalesced  <- _scatter_add_coalesced_call /
//                                  _scatter_add_kernel_coalesced / _seg_flags
// The TPU versions issue one DMA per row from a sequential grid over
// 64-row groups. Here there is no row group: a 1-D grid covers
// batch x vectors_per_row, and each thread moves one 16-byte vector of
// one row. Rows are padded to whole 16-byte vectors by the caller
// (parallel/mesh.py padded_cols), so every access is one aligned
// 16-byte load or store.
//
// What bounds them: bytes. At the main path's shape (1024 ids, 50 fp32
// columns padded to 52 = 208 B a row) the scatter moves
// 3 x 1024 x 208 B + 4 KiB (table read, table write, deltas, ids), about
// 0.19 us at 3.35 TB/s, and the gather 2 x 1024 x 208 B + 4 KiB, about
// 0.13 us. Both are far below the cost of one launch, so at that shape
// they are launch-bound. The design keeps each launch minimal: one pass,
// no shared memory, no atomics, no second kernel. Fewer launches (CUDA
// graphs, fusing the upload) are the next lever, not the kernel body.
//
// Contracts (enforced by the Python wrappers in ops/rows.py):
// * every pointer is 16-byte aligned and every row is a whole number of
//   16-byte vectors;
// * for the scatter, live ids are unique within a call. Pad slots repeat
//   the table's sentinel row with exactly-zero deltas, so racing threads
//   write back the bytes they read. No atomics are needed;
// * the host rejects out-of-range ids before they get here. The kernels
//   still skip any id outside [0, rows) so they never touch memory
//   outside the table (the gather writes zeros for such a slot).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ void add_vec(uint4& acc, const uint4& d) {
  constexpr int kN = sizeof(uint4) / sizeof(T);
  T* a = reinterpret_cast<T*>(&acc);
  const T* b = reinterpret_cast<const T*>(&d);
#pragma unroll
  for (int k = 0; k < kN; ++k) a[k] = a[k] + b[k];
}

template <>
__device__ __forceinline__ void add_vec<__half>(uint4& acc, const uint4& d) {
  __half2* a = reinterpret_cast<__half2*>(&acc);
  const __half2* b = reinterpret_cast<const __half2*>(&d);
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = __hadd2(a[k], b[k]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(uint4* __restrict__ table,
                        const int32_t* __restrict__ ids,
                        const uint4* __restrict__ deltas, int64_t rows,
                        int64_t batch, int64_t vecs_per_row) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= batch * vecs_per_row) return;
  const int64_t slot = i / vecs_per_row;
  const int64_t v = i - slot * vecs_per_row;
  const int64_t row = __ldg(ids + slot);
  if (row < 0 || row >= rows) return;
  uint4* dst = table + row * vecs_per_row + v;
  uint4 acc = *dst;
  add_vec<T>(acc, __ldg(deltas + i));
  *dst = acc;
}

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint4* __restrict__ table,
                   const int32_t* __restrict__ ids, uint4* __restrict__ out,
                   int64_t rows, int64_t batch, int64_t vecs_per_row) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= batch * vecs_per_row) return;
  const int64_t slot = i / vecs_per_row;
  const int64_t v = i - slot * vecs_per_row;
  const int64_t row = __ldg(ids + slot);
  out[i] = (row < 0 || row >= rows) ? make_uint4(0, 0, 0, 0)
                                    : __ldg(table + row * vecs_per_row + v);
}

// The coalesced scatter. The TPU kernel merged each segment of kSeg slots
// whose ids are consecutive into ONE kSeg-row DMA, to save descriptor
// issue cost on the scalar core, with the segment flags computed by a
// separate XLA pass and scalar-prefetched. Here there are no descriptors:
// one warp takes one segment, loads its kSeg ids itself and computes the
// flag from them, so no flags pass runs first. A flagged segment is one
// contiguous span of kSeg x vecs_per_row 16-byte vectors in the table
// (and in the deltas), and the lanes stride across it with no per-row
// address work. An unflagged segment goes row by row, with the bounds
// skip of scatter_add_rows_kernel. A flagged span that would leave
// [0, rows) goes row by row too: that is the bounds guard, not a second
// kernel. Each element still gets exactly one add of its delta, so the
// result is bitwise that of scatter_add_rows and of index_add_.
//
// The unique-live-id contract holds as above: a flagged segment may end
// on the sentinel row (its slot carries a zero delta), and the racing
// writes of pad slots put back the bytes they read.
//
// What bounds it: bytes, as for scatter_add_rows. What merging can save
// on this card is per-row address arithmetic and partly used 32-byte
// sectors where a row is not a multiple of 32 bytes; at 512 B rows a warp
// already moves whole 128-byte lines, so the expected gain is small.
constexpr int kSeg = 4;
constexpr int kWarp = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_coalesced_kernel(uint4* __restrict__ table,
                                  const int32_t* __restrict__ ids,
                                  const uint4* __restrict__ deltas,
                                  int64_t rows, int64_t n_segs,
                                  int vecs_per_row) {
  const int64_t seg =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  if (seg >= n_segs) return;
  const int lane = threadIdx.x % kWarp;
  const int32_t* seg_ids = ids + seg * kSeg;
  const int64_t first = __ldg(seg_ids);
  bool consecutive = true;
#pragma unroll
  for (int k = 1; k < kSeg; ++k) {
    consecutive = consecutive && __ldg(seg_ids + k) == first + k;
  }
  const int span = kSeg * vecs_per_row;
  const uint4* src = deltas + seg * span;
  if (consecutive && first >= 0 && first + kSeg <= rows) {
    uint4* dst = table + first * vecs_per_row;
    for (int off = lane; off < span; off += kWarp) {
      uint4 acc = dst[off];
      add_vec<T>(acc, __ldg(src + off));
      dst[off] = acc;
    }
    return;
  }
  for (int off = lane; off < span; off += kWarp) {
    const int k = off / vecs_per_row;
    const int64_t row = __ldg(seg_ids + k);
    if (row < 0 || row >= rows) continue;
    uint4* dst = table + row * vecs_per_row + (off - k * vecs_per_row);
    uint4 acc = *dst;
    add_vec<T>(acc, __ldg(src + off));
    *dst = acc;
  }
}

inline unsigned blocks_for(int64_t total) {
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

template <typename T>
int launch_scatter(void* table, const void* ids, const void* deltas,
                   int64_t rows, int64_t batch, int64_t vecs_per_row,
                   void* stream) {
  const int64_t total = batch * vecs_per_row;
  if (total > 0) {
    scatter_add_rows_kernel<T>
        <<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<uint4*>(table), static_cast<const int32_t*>(ids),
            static_cast<const uint4*>(deltas), rows, batch, vecs_per_row);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scatter_coalesced(void* table, const void* ids, const void* deltas,
                             int64_t rows, int64_t batch, int64_t vecs_per_row,
                             void* stream) {
  const int64_t n_segs = batch / kSeg;
  if (n_segs > 0) {
    scatter_add_rows_coalesced_kernel<T>
        <<<blocks_for(n_segs * kWarp), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<uint4*>(table), static_cast<const int32_t*>(ids),
            static_cast<const uint4*>(deltas), rows, n_segs,
            static_cast<int>(vecs_per_row));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MVT_SCATTER_ENTRY(suffix, type)                                      \
  extern "C" int mvt_scatter_add_rows_##suffix(                              \
      void* table, const void* ids, const void* deltas, int64_t rows,        \
      int64_t batch, int64_t vecs_per_row, void* stream) {                   \
    return launch_scatter<type>(table, ids, deltas, rows, batch,             \
                                vecs_per_row, stream);                       \
  }

MVT_SCATTER_ENTRY(f32, float)
MVT_SCATTER_ENTRY(f64, double)
MVT_SCATTER_ENTRY(f16, __half)
MVT_SCATTER_ENTRY(i32, int32_t)
MVT_SCATTER_ENTRY(i64, int64_t)

// batch is a multiple of kSeg (the wrapper checks ROW_GROUP % SEG == 0).
#define MVT_SCATTER_COALESCED_ENTRY(suffix, type)                            \
  extern "C" int mvt_scatter_add_rows_coalesced_##suffix(                    \
      void* table, const void* ids, const void* deltas, int64_t rows,        \
      int64_t batch, int64_t vecs_per_row, void* stream) {                   \
    return launch_scatter_coalesced<type>(table, ids, deltas, rows, batch,   \
                                          vecs_per_row, stream);             \
  }

MVT_SCATTER_COALESCED_ENTRY(f32, float)
MVT_SCATTER_COALESCED_ENTRY(f64, double)
MVT_SCATTER_COALESCED_ENTRY(f16, __half)
MVT_SCATTER_COALESCED_ENTRY(i32, int32_t)
MVT_SCATTER_COALESCED_ENTRY(i64, int64_t)

// Any dtype: the gather only copies bytes.
extern "C" int mvt_gather_rows(const void* table, const void* ids, void* out,
                               int64_t rows, int64_t batch,
                               int64_t vecs_per_row, void* stream) {
  const int64_t total = batch * vecs_per_row;
  if (total > 0) {
    gather_rows_kernel<<<blocks_for(total), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(table), static_cast<const int32_t*>(ids),
        static_cast<uint4*>(out), rows, batch, vecs_per_row);
  }
  return static_cast<int>(cudaGetLastError());
}
