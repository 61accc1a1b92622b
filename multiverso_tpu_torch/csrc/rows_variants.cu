// Design variants of the row gather and row scatter of rows.cu, kept so
// that rows_variants.py (repo root) can time them beside the shipped
// kernels on the same card. Nothing in the package calls them.
//
// Each variant is compiled on its own, with -DMVT_V_<NAME>, into a library
// whose one entry point has the shipped kernels' interface:
//   int mvt_variant(void* table, const void* ids, void* other, int64_t rows,
//                   int64_t batch, int64_t vecs_per_row, int64_t grid,
//                   int64_t block_x, int64_t block_y, void* stream)
// ("other" is the gather's output or the scatter's deltas; the scatters
// are float32). The TMA variants take one pass: grid x block_y must cover
// the batch, and a block's slab (block_y rows) must fit 48 KB.

#include "rows.cu"

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(1u) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes: a multiple of 16; both addresses 16-byte aligned.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_reduce_add_f32(void* dst, uint32_t src,
                                                    uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], "
      "%2;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}

// Wait until the bulk copies this thread issued have read shared memory.
__device__ __forceinline__ void bulk_commit_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's shared-memory writes before the async proxy's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#if defined(MVT_V_GATHER_SHFL)
// Each warp loads its slots' ids with one coalesced load (lane l the id of
// the warp's l-th slot) and hands them out with __shfl_sync.
__global__ void __launch_bounds__(kMaxThreads)
variant_kernel(const uint4* __restrict__ table, const int32_t* __restrict__ ids,
               uint4* __restrict__ out, int64_t rows, unsigned batch,
               unsigned vecs) {
  const unsigned tid = threadIdx.y * blockDim.x + threadIdx.x;
  const unsigned lane = tid & 31u;
  const unsigned active = min(32u, blockDim.x * blockDim.y - (tid & ~31u));
  const unsigned mask = active == 32u ? 0xffffffffu : (1u << active) - 1u;
  const unsigned y0 = __shfl_sync(mask, threadIdx.y, 0);  // the warp's first slot
  const unsigned step = gridDim.x * blockDim.y;
  for (unsigned base = blockIdx.x * blockDim.y; base < batch; base += step) {
    const unsigned mine = base + y0 + lane;
    int32_t id = -1;
    if (y0 + lane < blockDim.y && mine < batch) id = __ldg(ids + mine);
    const int64_t row = __shfl_sync(mask, id, threadIdx.y - y0);
    const unsigned slot = base + threadIdx.y;
    if (slot >= batch) continue;
    const bool live = live_row(row, rows);
    const uint4* src = table + row * vecs;
    uint4* dst = out + slot * vecs;
#pragma unroll 4
    for (unsigned v = threadIdx.x; v < vecs; v += blockDim.x) {
      dst[v] = live ? __ldg(src + v) : make_uint4(0, 0, 0, 0);
    }
  }
}
#define MVT_V_KERNEL variant_kernel
#define MVT_V_TABLE const uint4*
#define MVT_V_OTHER uint4*
#endif

#if defined(MVT_V_GATHER_CS) || defined(MVT_V_GATHER_INFLIGHT)
// The shipped gather with each lane's loads batched kInFlight at a time
// before its stores (INFLIGHT), or that and streaming stores
// (st.global.cs) of the output (CS).
__global__ void __launch_bounds__(kMaxThreads)
variant_kernel(const uint4* __restrict__ table, const int32_t* __restrict__ ids,
               uint4* __restrict__ out, int64_t rows, unsigned batch,
               unsigned vecs) {
  const unsigned step = gridDim.x * blockDim.y;
  for (unsigned slot = blockIdx.x * blockDim.y + threadIdx.y; slot < batch;
       slot += step) {
    const int64_t row = __ldg(ids + slot);
    const bool live = live_row(row, rows);
    const uint4* src = table + row * vecs;
    uint4* dst = out + slot * vecs;
    for (unsigned v0 = threadIdx.x; v0 < vecs; v0 += kInFlight * blockDim.x) {
      uint4 r[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const unsigned v = v0 + k * blockDim.x;
        r[k] = (live && v < vecs) ? __ldg(src + v) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const unsigned v = v0 + k * blockDim.x;
#if defined(MVT_V_GATHER_CS)
        if (v < vecs) __stcs(dst + v, r[k]);
#else
        if (v < vecs) dst[v] = r[k];
#endif
      }
    }
  }
}
#define MVT_V_KERNEL variant_kernel
#define MVT_V_TABLE const uint4*
#define MVT_V_OTHER uint4*
#endif

#if defined(MVT_V_GATHER_TMA)
// One bulk copy a row, table -> shared memory, completing on an mbarrier;
// then one bulk store of the block's contiguous output slab. A slot whose
// id is out of range gets a zeroed row of the slab.
__global__ void __launch_bounds__(kMaxThreads)
variant_kernel(const uint4* __restrict__ table, const int32_t* __restrict__ ids,
               uint4* __restrict__ out, int64_t rows, unsigned batch,
               unsigned vecs) {
  extern __shared__ __align__(128) uint4 slab[];
  __shared__ __align__(8) uint64_t bar;
  const unsigned tid = threadIdx.y * blockDim.x + threadIdx.x;
  const unsigned base = blockIdx.x * blockDim.y;
  const unsigned n = min(blockDim.y, batch - base);
  const uint32_t row_bytes = vecs * 16u;
  const uint32_t b = smem_addr(&bar);
  if (tid == 0) mbar_init(b);
  int64_t row = -1;
  if (tid < n) row = __ldg(ids + base + tid);
  const bool live = tid < n && live_row(row, rows);
  if (tid < n && !live) {
    for (unsigned v = 0; v < vecs; ++v) slab[tid * vecs + v] = make_uint4(0, 0, 0, 0);
    fence_proxy_async();
  }
  const int n_live = __syncthreads_count(live);
  if (tid == 0) mbar_expect_tx(b, static_cast<uint32_t>(n_live) * row_bytes);
  if (live) bulk_load(smem_addr(slab + tid * vecs), table + row * vecs, row_bytes, b);
  if (tid == 0) {
    mbar_wait(b, 0);
    fence_proxy_async();
    bulk_store(out + base * vecs, smem_addr(slab), n * row_bytes);
    bulk_commit_wait_read();
  }
}
#define MVT_V_KERNEL variant_kernel
#define MVT_V_TABLE const uint4*
#define MVT_V_OTHER uint4*
#define MVT_V_SLAB 1
#endif

#if defined(MVT_V_SCATTER_RED1)
// The shipped scatter's path in L2 with four scalar red.global.add.f32 a
// vector instead of one 16-byte red.global.add.v4.f32.
__global__ void __launch_bounds__(kMaxThreads)
variant_kernel(uint4* __restrict__ table, const int32_t* __restrict__ ids,
               const uint4* __restrict__ deltas, int64_t rows, unsigned batch,
               unsigned vecs) {
  const unsigned step = gridDim.x * blockDim.y;
  for (unsigned slot = blockIdx.x * blockDim.y + threadIdx.y; slot < batch;
       slot += step) {
    const int64_t row = __ldg(ids + slot);
    const bool live = live_row(row, rows);
    const uint4* src = deltas + slot * vecs;
    float* dst = reinterpret_cast<float*>(table + row * vecs);
#pragma unroll 4
    for (unsigned v = threadIdx.x; v < vecs; v += blockDim.x) {
      const uint4 d = __ldg(src + v);
      if (live) {
        atomicAdd(dst + 4 * v, __uint_as_float(d.x));
        atomicAdd(dst + 4 * v + 1, __uint_as_float(d.y));
        atomicAdd(dst + 4 * v + 2, __uint_as_float(d.z));
        atomicAdd(dst + 4 * v + 3, __uint_as_float(d.w));
      }
    }
  }
}
#define MVT_V_KERNEL variant_kernel
#define MVT_V_TABLE uint4*
#define MVT_V_OTHER const uint4*
#endif

#if defined(MVT_V_SCATTER_TMA_RMW)
// The block's contiguous delta slab comes in by one bulk copy on an
// mbarrier while the lanes load ids and table rows; then the adds and
// stores of the shipped scatter.
__global__ void __launch_bounds__(kMaxThreads)
variant_kernel(uint4* __restrict__ table, const int32_t* __restrict__ ids,
               const uint4* __restrict__ deltas, int64_t rows, unsigned batch,
               unsigned vecs) {
  extern __shared__ __align__(128) uint4 slab[];
  __shared__ __align__(8) uint64_t bar;
  const unsigned tid = threadIdx.y * blockDim.x + threadIdx.x;
  const unsigned base = blockIdx.x * blockDim.y;
  const unsigned n = min(blockDim.y, batch - base);
  const uint32_t b = smem_addr(&bar);
  if (tid == 0) {
    mbar_init(b);
    mbar_expect_tx(b, n * vecs * 16u);
    bulk_load(smem_addr(slab), deltas + base * vecs, n * vecs * 16u, b);
  }
  const unsigned slot = base + threadIdx.y;
  const int64_t row = threadIdx.y < n ? __ldg(ids + slot) : -1;
  const bool live = live_row(row, rows);
  uint4* dst = table + row * vecs;
  const uint4* d = slab + threadIdx.y * vecs;
  bool waited = false;
  for (unsigned v0 = threadIdx.x; v0 < vecs || !waited; v0 += kInFlight * blockDim.x) {
    uint4 acc[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const unsigned v = v0 + k * blockDim.x;
      acc[k] = (live && v < vecs) ? dst[v] : make_uint4(0, 0, 0, 0);
    }
    if (!waited) {
      __syncthreads();  // the barrier's init is seen by every thread
      mbar_wait(b, 0);
      waited = true;
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const unsigned v = v0 + k * blockDim.x;
      if (live && v < vecs) {
        index_add_vec<float>(acc[k], d[v]);
        dst[v] = acc[k];
      }
    }
  }
}
#define MVT_V_KERNEL variant_kernel
#define MVT_V_TABLE uint4*
#define MVT_V_OTHER const uint4*
#define MVT_V_SLAB 1
#endif

#if defined(MVT_V_SCATTER_TMA_RED)
// The delta slab by one bulk copy, then one bulk reduce-add a row
// (cp.reduce.async.bulk .add.f32), shared memory -> the table row in L2.
__global__ void __launch_bounds__(kMaxThreads)
variant_kernel(uint4* __restrict__ table, const int32_t* __restrict__ ids,
               const uint4* __restrict__ deltas, int64_t rows, unsigned batch,
               unsigned vecs) {
  extern __shared__ __align__(128) uint4 slab[];
  __shared__ __align__(8) uint64_t bar;
  const unsigned tid = threadIdx.y * blockDim.x + threadIdx.x;
  const unsigned base = blockIdx.x * blockDim.y;
  const unsigned n = min(blockDim.y, batch - base);
  const uint32_t row_bytes = vecs * 16u;
  const uint32_t b = smem_addr(&bar);
  if (tid == 0) {
    mbar_init(b);
    mbar_expect_tx(b, n * row_bytes);
    bulk_load(smem_addr(slab), deltas + base * vecs, n * row_bytes, b);
  }
  const int64_t row = tid < n ? __ldg(ids + base + tid) : -1;
  __syncthreads();  // the barrier's init is seen by every thread
  const bool live = tid < n && live_row(row, rows);
  if (live || tid == 0) mbar_wait(b, 0);  // the slab lands before the block exits
  if (live) {
    bulk_reduce_add_f32(table + row * vecs, smem_addr(slab + tid * vecs), row_bytes);
    bulk_commit_wait_read();
  }
}
#define MVT_V_KERNEL variant_kernel
#define MVT_V_TABLE uint4*
#define MVT_V_OTHER const uint4*
#define MVT_V_SLAB 1
#endif

#if defined(MVT_V_PROBE_STORE) || defined(MVT_V_PROBE_ID) || defined(MVT_V_PROBE_ROW)
// Probes, not gathers: the shipped gather with one step of its dependent
// chain (id load -> row load -> store) taken out, to see what each costs.
// STORE writes zero rows (no loads); ID loads the id and writes it across
// the row (no row load); ROW loads a row picked from the slot by a hash
// (no id load) and writes it.
__global__ void __launch_bounds__(kMaxThreads)
variant_kernel(const uint4* __restrict__ table, const int32_t* __restrict__ ids,
               uint4* __restrict__ out, int64_t rows, unsigned batch,
               unsigned vecs) {
  const unsigned step = gridDim.x * blockDim.y;
  for (unsigned slot = blockIdx.x * blockDim.y + threadIdx.y; slot < batch;
       slot += step) {
    uint4* dst = out + slot * vecs;
#if defined(MVT_V_PROBE_ROW)
    const uint4* src = table + static_cast<int64_t>((slot * 2654435761ull) % rows) * vecs;
#pragma unroll 4
    for (unsigned v = threadIdx.x; v < vecs; v += blockDim.x) dst[v] = __ldg(src + v);
#else
#if defined(MVT_V_PROBE_ID)
    const unsigned x = static_cast<unsigned>(__ldg(ids + slot));
#else
    const unsigned x = 0;
#endif
#pragma unroll 4
    for (unsigned v = threadIdx.x; v < vecs; v += blockDim.x) dst[v] = make_uint4(x, x, x, x);
#endif
  }
}
#define MVT_V_KERNEL variant_kernel
#define MVT_V_TABLE const uint4*
#define MVT_V_OTHER uint4*
#endif

#if defined(MVT_V_GATHER_PAGEWARM) || defined(MVT_V_SCATTER_L2_PAGEWARM)
// Before its ids arrive, each block loads one word of every 2 MB of the
// table, so that the row accesses after the ids may find their address
// translations cached near the SM. Then the shipped gather, or the
// shipped scatter's path in L2 (float32).
constexpr int64_t kPage = 2 << 20;

__device__ __forceinline__ void warm_pages(const void* table, int64_t rows,
                                           unsigned vecs) {
  const int64_t pages = (rows * vecs * 16 + kPage - 1) / kPage;
  const unsigned threads = blockDim.x * blockDim.y;
  for (int64_t p = threadIdx.y * blockDim.x + threadIdx.x; p < pages; p += threads) {
    unsigned dummy;
    asm volatile("ld.global.b32 %0, [%1];\n"
                 : "=r"(dummy)
                 : "l"(static_cast<const char*>(table) + p * kPage));
  }
}
#endif

#if defined(MVT_V_GATHER_PAGEWARM)
__global__ void __launch_bounds__(kMaxThreads)
variant_kernel(const uint4* __restrict__ table, const int32_t* __restrict__ ids,
               uint4* __restrict__ out, int64_t rows, unsigned batch,
               unsigned vecs) {
  warm_pages(table, rows, vecs);
  const unsigned step = gridDim.x * blockDim.y;
  for (unsigned slot = blockIdx.x * blockDim.y + threadIdx.y; slot < batch;
       slot += step) {
    const int64_t row = __ldg(ids + slot);
    const bool live = live_row(row, rows);
    const uint4* src = table + row * vecs;
    uint4* dst = out + slot * vecs;
    for (unsigned v = threadIdx.x; v < vecs; v += blockDim.x) {
      dst[v] = live ? __ldg(src + v) : make_uint4(0, 0, 0, 0);
    }
  }
}
#define MVT_V_KERNEL variant_kernel
#define MVT_V_TABLE const uint4*
#define MVT_V_OTHER uint4*
#endif

#if defined(MVT_V_SCATTER_L2_PAGEWARM)
__global__ void __launch_bounds__(kMaxThreads)
variant_kernel(uint4* __restrict__ table, const int32_t* __restrict__ ids,
               const uint4* __restrict__ deltas, int64_t rows, unsigned batch,
               unsigned vecs) {
  warm_pages(table, rows, vecs);
  const unsigned step = gridDim.x * blockDim.y;
  for (unsigned slot = blockIdx.x * blockDim.y + threadIdx.y; slot < batch;
       slot += step) {
    const int64_t row = __ldg(ids + slot);
    const uint4* src = deltas + slot * vecs;
    uint4* dst = table + row * vecs;
    for (unsigned v = threadIdx.x; v < vecs; v += blockDim.x) {
      const uint4 d = __ldg(src + v);
      if (live_row(row, rows)) index_red_vec<float>(dst + v, d);
    }
  }
}
#define MVT_V_KERNEL variant_kernel
#define MVT_V_TABLE uint4*
#define MVT_V_OTHER const uint4*
#endif

#if defined(MVT_V_SCATTER_SM_CS)
// The shipped scatter's path through the SM with cache hints: deltas are
// read once (ld.global.cs), table rows bypass L1 (ld.global.cg).
__global__ void __launch_bounds__(kMaxThreads)
variant_kernel(uint4* __restrict__ table, const int32_t* __restrict__ ids,
               const uint4* __restrict__ deltas, int64_t rows, unsigned batch,
               unsigned vecs) {
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
        d[k] = v < vecs ? __ldcs(src + v) : make_uint4(0, 0, 0, 0);
        acc[k] = (live && v < vecs) ? __ldcg(dst + v) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const unsigned v = v0 + k * blockDim.x;
        if (live && v < vecs) {
          index_add_vec<float>(acc[k], d[k]);
          dst[v] = acc[k];
        }
      }
    }
  }
}
#define MVT_V_KERNEL variant_kernel
#define MVT_V_TABLE uint4*
#define MVT_V_OTHER const uint4*
#endif

}  // namespace

#if defined(MVT_V_KERNEL)
#if !defined(MVT_V_SLAB)
#define MVT_V_SLAB 0
#endif
extern "C" int mvt_variant(void* table, const void* ids, void* other,
                           int64_t rows, int64_t batch, int64_t vecs_per_row,
                           int64_t grid, int64_t block_x, int64_t block_y,
                           void* stream) {
  if (grid > 0) {
    const size_t smem = MVT_V_SLAB ? static_cast<size_t>(block_y) * vecs_per_row * 16 : 0;
    MVT_V_KERNEL<<<dim3(static_cast<unsigned>(grid)),
                   dim3(static_cast<unsigned>(block_x), static_cast<unsigned>(block_y)),
                   smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<MVT_V_TABLE>(table), static_cast<const int32_t*>(ids),
        static_cast<MVT_V_OTHER>(other), rows, static_cast<unsigned>(batch),
        static_cast<unsigned>(vecs_per_row));
  }
  return static_cast<int>(cudaGetLastError());
}
#endif
