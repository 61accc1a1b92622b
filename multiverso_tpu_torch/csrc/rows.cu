// Row scatter-add and row gather for the parameter-server tables, written
// for Hopper (sm_90a). Built by multiverso_tpu_torch/ops/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes: every entry point takes device pointers and the
// caller's stream as void*, sizes as int64_t, launches on that stream,
// allocates nothing and returns cudaGetLastError().
//
// Replaces the TPU kernels of multiverso_tpu/ops/pallas_rows.py:
//   mvt_gather_rows                <- _gather_call / _gather_kernel
//   mvt_scatter_add_rows_*         <- _scatter_add_call / _scatter_add_kernel
//   mvt_scatter_add_rows_coalesced_* <- _scatter_add_coalesced_call /
//                                     _scatter_add_kernel_coalesced / _seg_flags
// The TPU versions issue one DMA per row from a sequential grid over
// 64-row groups. Here a 2-D block of lanes moves 16-byte vectors; rows are
// padded to whole vectors by the caller (parallel/mesh.py padded_cols).
//
// What bounds the gather and the scatter on an H100, by shape (PERF.md §6;
// the design variants measured are in commit 29744b3):
// * the parameter server's 1024-row bucket of 208-byte rows: bytes take
//   0.13-0.19 us at 3.35 TB/s, against a launch floor of about 1.8-2.0 us
//   (fill_ of one element, back to back) and a dependent chain:
//   id load -> row access -> store, each an HBM round trip when the rows
//   and ids are cold (about 0.5 and 0.7 us; 0.15 us for the stores);
// * word2vec's 65,536-row buckets of 512-byte rows: bytes (20-29 us).
// What the design does about each:
// * launch: one kernel, no shared memory, no setup; the wrapper computes
//   the geometry once per shape (ops/rows.py launch_geometry) and the
//   kernels index in 32 bits;
// * the chain: every SM takes a block at the PS shape, ids and deltas are
//   loaded in the same step, and the scatter adds by atomic reductions in
//   L2 (red.global.add) while the batch is latency-bound, so that its chain
//   is id -> reduction, with no table row brought to the SM. Nothing the
//   kernel can do removes the gather's id -> row dependence: it stays at
//   launch floor + id + row + store (chain probes, commit 29744b3);
// * bytes: at large batches the grid is bounded and walks the batch, and
//   the scatter goes through the SM (load, add, store, four vectors a lane
//   in flight), whose bytes rate is above that of L2's atomics.
// TMA bulk copies were measured (PERF.md §6) and are not used: a
// staged output slab slows the gather, a bulk reduce does not flush
// float32 subnormals as index_add_ does, and a delta slab gains 4% only
// at the word2vec push, for a slab sized by rows x width, column chunks
// past 227 KB of shared memory and an mbarrier phase per walked tile.
//
// Contracts (enforced by the Python wrappers in ops/rows.py):
// * every pointer is 16-byte aligned and every row is a whole number of
//   16-byte vectors; batch x vectors a row is below 2^31;
// * for the scatter, live ids are unique within a call. Pad slots repeat
//   the table's sentinel row with exactly-zero deltas. The reductions and
//   the read-modify-write give the same bits as index_add_ (each element
//   takes one add of its delta; see index_add_vec);
// * the host rejects out-of-range ids before they get here. The kernels
//   still skip any id outside [0, rows) so they never touch memory
//   outside the table (the gather writes zeros for such a slot).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ void add_vec(uint4& acc, const uint4& d) {
  constexpr int kN = sizeof(uint4) / sizeof(T);
  T* a = reinterpret_cast<T*>(&acc);
  const T* b = reinterpret_cast<const T*>(&d);
#pragma unroll
  for (int k = 0; k < kN; ++k) a[k] = a[k] + b[k];
}

// The adds of index_add_ on the card, which both scatters match bit for
// bit: a float32 goes in by red.global.add.f32, which flushes subnormal
// inputs and results to zero; a float16 goes in as a pair with its
// neighbour (PyTorch's fastAtomicAdd), so every element of a touched row
// also takes a +0, which turns a -0 sum into +0. Other types: one add.
__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <typename T>
__device__ __forceinline__ void index_add_vec(uint4& acc, const uint4& d) {
  add_vec<T>(acc, d);
}

template <>
__device__ __forceinline__ void index_add_vec<float>(uint4& acc, const uint4& d) {
  float* a = reinterpret_cast<float*>(&acc);
  const float* b = reinterpret_cast<const float*>(&d);
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = add_ftz(a[k], b[k]);
}

template <>
__device__ __forceinline__ void index_add_vec<__half>(uint4& acc, const uint4& d) {
  __half2* a = reinterpret_cast<__half2*>(&acc);
  const __half2* b = reinterpret_cast<const __half2*>(&d);
  const __half2 zero = __float2half2_rn(0.0f);
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = __hadd2(__hadd2(a[k], b[k]), zero);
}

// The same adds as atomic reductions in L2 (red.global.add), 16 bytes at
// a time where the card has a vector reduction.
template <typename T>
__device__ __forceinline__ void index_red_vec(uint4* dst, const uint4& d);

template <>
__device__ __forceinline__ void index_red_vec<float>(uint4* dst, const uint4& d) {
  atomicAdd(reinterpret_cast<float4*>(dst),
            make_float4(__uint_as_float(d.x), __uint_as_float(d.y),
                        __uint_as_float(d.z), __uint_as_float(d.w)));
}

template <>
__device__ __forceinline__ void index_red_vec<double>(uint4* dst, const uint4& d) {
  const double* b = reinterpret_cast<const double*>(&d);
  atomicAdd(reinterpret_cast<double*>(dst), b[0]);
  atomicAdd(reinterpret_cast<double*>(dst) + 1, b[1]);
}

template <>
__device__ __forceinline__ void index_red_vec<__half>(uint4* dst, const uint4& d) {
  const __half2* b = reinterpret_cast<const __half2*>(&d);
  const __half2 zero = __float2half2_rn(0.0f);
  __half2* p = reinterpret_cast<__half2*>(dst);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    atomicAdd(p + k, b[k]);
    atomicAdd(p + k, zero);
  }
}

template <>
__device__ __forceinline__ void index_red_vec<int32_t>(uint4* dst, const uint4& d) {
  const int* b = reinterpret_cast<const int*>(&d);
#pragma unroll
  for (int k = 0; k < 4; ++k) atomicAdd(reinterpret_cast<int*>(dst) + k, b[k]);
}

template <>
__device__ __forceinline__ void index_red_vec<int64_t>(uint4* dst, const uint4& d) {
  const unsigned long long* b = reinterpret_cast<const unsigned long long*>(&d);
  atomicAdd(reinterpret_cast<unsigned long long*>(dst), b[0]);
  atomicAdd(reinterpret_cast<unsigned long long*>(dst) + 1, b[1]);
}

// Most threads a block of the gather or the scatter has (ops/rows.py
// MAX_THREADS).
constexpr int kMaxThreads = 256;
// 16-byte table rows and deltas each lane of the scatter's path through
// the SM loads before it adds and stores any of them (ops/rows.py
// IN_FLIGHT).
constexpr int kInFlight = 4;

__device__ __forceinline__ bool live_row(int64_t row, int64_t rows) {
  return row >= 0 && row < rows;
}

// Launch geometry (ops/rows.py launch_geometry): a block is (block_x lanes
// across a row) x (block_y slots); the grid walks the batch block_y slots
// at a time, and a lane walks its row block_x vectors at a time. Index
// math is 32-bit (the wrapper keeps batch x vecs below 2^31); the table
// offset row x vecs is 64-bit.

// The row gather: out[slot] = table[ids[slot]], zeros for an id outside
// [0, rows).
__global__ void __launch_bounds__(kMaxThreads)
gather_rows_kernel(const uint4* __restrict__ table,
                   const int32_t* __restrict__ ids, uint4* __restrict__ out,
                   int64_t rows, unsigned batch, unsigned vecs) {
  const unsigned step = gridDim.x * blockDim.y;
  for (unsigned slot = blockIdx.x * blockDim.y + threadIdx.y; slot < batch;
       slot += step) {
    const int64_t row = __ldg(ids + slot);
    const bool live = live_row(row, rows);
    const uint4* src = table + row * vecs;
    uint4* dst = out + slot * vecs;
#pragma unroll 4
    for (unsigned v = threadIdx.x; v < vecs; v += blockDim.x) {
      dst[v] = live ? __ldg(src + v) : make_uint4(0, 0, 0, 0);
    }
  }
}

// The row scatter, table[ids[slot]] += deltas[slot] for live unique ids,
// by atomic reductions in L2: a delta does not wait on its id, so the one
// dependent step is id -> reduction, and no table row comes to the SM.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
scatter_add_rows_l2_kernel(uint4* __restrict__ table,
                           const int32_t* __restrict__ ids,
                           const uint4* __restrict__ deltas, int64_t rows,
                           unsigned batch, unsigned vecs) {
  const unsigned step = gridDim.x * blockDim.y;
  for (unsigned slot = blockIdx.x * blockDim.y + threadIdx.y; slot < batch;
       slot += step) {
    const int64_t row = __ldg(ids + slot);
    const bool live = live_row(row, rows);
    const uint4* src = deltas + slot * vecs;
    uint4* dst = table + row * vecs;
#pragma unroll 4
    for (unsigned v = threadIdx.x; v < vecs; v += blockDim.x) {
      const uint4 d = __ldg(src + v);
      if (live) index_red_vec<T>(dst + v, d);
    }
  }
}

// The same scatter through the SM: each lane loads kInFlight table and
// delta vectors, then adds and stores them. One more dependent round trip
// than the reductions, but a higher bytes rate than L2's atomics at large
// batches.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
scatter_add_rows_sm_kernel(uint4* __restrict__ table,
                           const int32_t* __restrict__ ids,
                           const uint4* __restrict__ deltas, int64_t rows,
                           unsigned batch, unsigned vecs) {
  const unsigned step = gridDim.x * blockDim.y;
  for (unsigned slot = blockIdx.x * blockDim.y + threadIdx.y; slot < batch;
       slot += step) {
    const int64_t row = __ldg(ids + slot);
    const bool live = live_row(row, rows);
    const uint4* src = deltas + slot * vecs;
    uint4* dst = table + row * vecs;
    for (unsigned v0 = threadIdx.x; v0 < vecs; v0 += kInFlight * blockDim.x) {
      uint4 acc[kInFlight], d[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const unsigned v = v0 + k * blockDim.x;
        d[k] = v < vecs ? __ldg(src + v) : make_uint4(0, 0, 0, 0);
        acc[k] = (live && v < vecs) ? dst[v] : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const unsigned v = v0 + k * blockDim.x;
        if (live && v < vecs) {
          index_add_vec<T>(acc[k], d[k]);
          dst[v] = acc[k];
        }
      }
    }
  }
}

constexpr int kThreads = 256;  // the coalesced scatter's block

// The coalesced scatter. The TPU kernel merged each segment of kSeg slots
// whose ids are consecutive into ONE kSeg-row DMA, to save descriptor
// issue cost on the scalar core, with the segment flags computed by a
// separate XLA pass and scalar-prefetched. Here there are no descriptors:
// one warp takes one segment, loads its kSeg ids itself and computes the
// flag from them, so no flags pass runs first. A flagged segment is one
// contiguous span of kSeg x vecs_per_row 16-byte vectors in the table
// (and in the deltas), and the lanes stride across it with no per-row
// address work. An unflagged segment goes row by row, with the bounds
// skip of the simple scatter. A flagged span that would leave
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
      index_add_vec<T>(acc, __ldg(src + off));
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
    index_add_vec<T>(acc, __ldg(src + off));
    *dst = acc;
  }
}


inline unsigned blocks_for(int64_t total) {
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

template <typename T>
int launch_scatter(void* table, const void* ids, const void* deltas,
                   int64_t rows, int64_t batch, int64_t vecs_per_row,
                   int64_t grid, int64_t block_x, int64_t block_y,
                   int64_t in_l2, void* stream) {
  if (grid > 0) {
    auto* kernel = in_l2 ? scatter_add_rows_l2_kernel<T> : scatter_add_rows_sm_kernel<T>;
    kernel<<<dim3(static_cast<unsigned>(grid)),
             dim3(static_cast<unsigned>(block_x), static_cast<unsigned>(block_y)),
             0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint4*>(table), static_cast<const int32_t*>(ids),
        static_cast<const uint4*>(deltas), rows, static_cast<unsigned>(batch),
        static_cast<unsigned>(vecs_per_row));
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

// The wrapper computes the launch geometry (ops/rows.py launch_geometry)
// and checks batch x vecs_per_row < 2^31, so the kernels index in 32 bits.
#define MVT_SCATTER_ENTRY(suffix, type)                                      \
  extern "C" int mvt_scatter_add_rows_##suffix(                              \
      void* table, const void* ids, const void* deltas, int64_t rows,        \
      int64_t batch, int64_t vecs_per_row, int64_t grid, int64_t block_x,    \
      int64_t block_y, int64_t in_l2, void* stream) {                        \
    return launch_scatter<type>(table, ids, deltas, rows, batch,             \
                                vecs_per_row, grid, block_x, block_y, in_l2, \
                                stream);                                     \
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
                               int64_t vecs_per_row, int64_t grid,
                               int64_t block_x, int64_t block_y, void* stream) {
  if (grid > 0) {
    gather_rows_kernel<<<dim3(static_cast<unsigned>(grid)),
                         dim3(static_cast<unsigned>(block_x),
                              static_cast<unsigned>(block_y)),
                         0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(table), static_cast<const int32_t*>(ids),
        static_cast<uint4*>(out), rows, static_cast<unsigned>(batch),
        static_cast<unsigned>(vecs_per_row));
  }
  return static_cast<int>(cudaGetLastError());
}
