// The skip-gram negative-sampling chunk step of word2vec's block trainers,
// written for Hopper (sm_90a): from a chunk's token ids and draws to the
// three delta arrays, the loss and the pair count. The three row scatters
// stay PyTorch's (models/word2vec.py _add_rows). Built by
// multiverso_tpu_torch/ops/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes (ops/sgns.py): the entry point takes device
// pointers and the caller's stream as void*, sizes as int64_t, launches
// four kernels on that stream, allocates nothing and returns
// cudaGetLastError().
//
// Replaces no TPU kernel: the JAX package's block step
// (multiverso_tpu/models/word2vec.py make_block_train_step) is one jit,
// and XLA fuses its rolls, products and reductions. In eager PyTorch the
// same step is about 240 small kernels a chunk, whose issue from the host
// is most of a training step, and ten of which (the rolls) move the whole
// (T, D) output block again for every window offset. Here it is:
//   sgns_clear  zero the occurrence counts at the rows the chunk touches
//               and the per-group flags;
//   sgns_prep   a thread a token: the dynamic-window pair mask, npairs,
//               the centre and context row ids, and the occurrence counts
//               of the input rows and of the positive output rows;
//   sgns_score  a warp a centre: the 2W positive and K shared-negative
//               scores straight from the table rows (no (T, D) gather and
//               no roll), g and g_neg, the loss and pair partials, the
//               negatives' row ids and their occurrence counts;
//   sgns_grad   a warp an output row: the input rows' gradients, the
//               positive output rows' (the gather form of the rolled
//               sum), the negative rows', each scaled by its row's count
//               (the max_row_step clamp or the mean) and by -lr; and the
//               fixed-order sum of the loss partials.
//
// What bounds it on an H100 at the benchmark's chunk (T 8192, D 300, W 5,
// K 5, G 8): bytes. Each kernel of sgns_score and sgns_grad reads the
// chunk's input rows, its output rows and its negatives' rows (about
// 26 MB), and sgns_grad writes as many deltas; the scores and their
// gradients are 15 dot products and 15 axpys of D a centre, about 0.3
// GFLOP a chunk, far below the card's float32 rate. What the design does
// about it:
// * every row is read through its id, 16 bytes a lane where D and the
//   row strides are multiples of 4 (float4; a scalar path otherwise), and
//   a warp's neighbours share the window's rows in L1;
// * a warp carries up to kBatch dot products at once, so the centre's row
//   is read once for all of them and the context rows' loads overlap;
// * g (T, 2W), g_neg (T, K) and npairs (T,) are the only intermediates in
//   device memory, a few hundred KB; the counts live in a scratch array of
//   table rows that is zeroed only where the chunk touches it.
//
// Arithmetic: float32 throughout, no TF32, no fast-math intrinsics
// (expf, log1pf and IEEE division as PyTorch's kernels use them). Sums
// over the window, the negatives and D are in another order than the
// eager step's, so results differ from it by float32 reordering. The loss
// partials are carried in float64 and reduced in a fixed order. The only
// float atomics add whole-number occurrence counts, which are exact in any
// order: two runs of the chain on the same inputs give the same bits.
//
// Contracts (enforced by the Python wrapper in ops/sgns.py):
// * tables are float32 with unit column stride; T % G == 0;
// * token ids are -1 (or any negative) for padding; draws hold window
//   sizes (T,) and negatives (T/G, K), slot indices into `slots` where the
//   negatives come from a slot table;
// * an id outside the table is never read or written here: its row reads
//   as zeros and the scatter that follows rejects it, as the eager step's
//   indexing would.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // warps a block
constexpr int kThreads = 32 * kWarps;  // threads a block
constexpr int kBatch = 8;              // dot products a warp carries at once

// flags (ops/sgns.py builds them)
constexpr int64_t kBlock64 = 1;    // token ids are int64 (else int32)
constexpr int64_t kWin64 = 2;      // window sizes are int64
constexpr int64_t kNeg64 = 4;      // negative draws are int64
constexpr int64_t kSlots64 = 8;    // slot table is int64
constexpr int64_t kNegTable = 16;  // negatives are slot indices
constexpr int64_t kMean = 32;      // combine="mean" (else "sum")

struct Args {
  const float* w_in;
  int64_t ld_in, rows_in;
  const float* w_out;
  int64_t ld_out, rows_out;
  const void* block;
  const void* win;
  const void* neg;
  const void* slots;
  int64_t n_slots;
  int T, D, W, K, G, TG;
  int64_t flags;
  float lr, neg_lr, cap;
  int64_t* ids_in;   // (T,)  centre rows; the sentinel for dead centres
  int64_t* ids_out;  // (T,)  context rows by position; the sentinel for pads
  int64_t* ids_neg;  // (TG * K,) negative rows; the sentinel for dead groups
  float* d_in;       // (T, D)
  float* d_out;      // (T, D)
  float* d_neg;      // (TG * K, D)
  float* npairs;     // (T,)
  float* g;          // (T, 2W)
  float* g_neg;      // (T, K)
  float* grp_occ;    // (TG,) the group's negative occurrence count
  int* grp_act;      // (TG,) whether any centre of the group is live
  float* cnt_in;     // (rows_in,)
  float* cnt_out;    // (rows_out,)
  double* partial;   // (n_partial, 2): loss and pairs of each score block
  int n_partial;
  float* result;     // (2,): loss, pairs
};

__device__ __forceinline__ int64_t load_id(const void* p, int64_t i, bool wide) {
  return wide ? static_cast<const int64_t*>(p)[i]
              : static_cast<int64_t>(static_cast<const int32_t*>(p)[i]);
}

__device__ __forceinline__ bool in_rows(int64_t id, int64_t rows) {
  return id >= 0 && id < rows;
}

__device__ __forceinline__ int64_t token(const Args& a, int t) {
  return load_id(a.block, t, a.flags & kBlock64);
}

// window offsets in the eager step's order: -W..-1, 1..W
__device__ __forceinline__ int offset(int j, int W) {
  return j < W ? j - W : j - W + 1;
}

// whether centre t has a pair at offset index j: both tokens live, the
// context inside the chunk and inside the centre's drawn window
__device__ __forceinline__ bool pair_ok(const Args& a, int t, int j) {
  const int o = offset(j, a.W);
  const int p = t + o;
  if (p < 0 || p >= a.T) return false;
  const int64_t b = load_id(a.win, t, a.flags & kWin64);
  return token(a, t) >= 0 && token(a, p) >= 0 && (o < 0 ? -o : o) <= b;
}

// the table row of negative draw gk; a draw outside the slot table maps to
// rows_out, outside the table, which nothing here reads
__device__ __forceinline__ int64_t neg_row(const Args& a, int64_t gk) {
  int64_t n = load_id(a.neg, gk, a.flags & kNeg64);
  if (a.flags & kNegTable) {
    if (n < 0 || n >= a.n_slots) return a.rows_out;
    n = load_id(a.slots, n, a.flags & kSlots64);
  }
  return n;
}

// PyTorch's float kernels: sigmoid = 1 / (1 + exp(-x));
// log_sigmoid = min(x, 0) - log1p(exp(-|x|))
__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

// the max_row_step clamp: min(cap / max(lr * count, 1e-6), 1), the
// quotient as PyTorch's `cap / tensor` computes it (reciprocal, then cap)
__device__ __forceinline__ float step_scale(float count, float lr, float cap) {
  const float x = fmaxf(lr * count, 1e-6f);
  return fminf((1.0f / x) * cap, 1.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;  // every lane holds the same sum
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int m = 16; m; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// a row as VN-float vectors: float4 (16-byte loads) or float
template <int VN>
struct Vec;

template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* row, int i) {
    return __ldg(reinterpret_cast<const float4*>(row) + i);
  }
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ float dot(const T& a, const T& b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
  static __device__ __forceinline__ void axpy(T& y, float s, const T& x) {
    y.x = fmaf(s, x.x, y.x);
    y.y = fmaf(s, x.y, y.y);
    y.z = fmaf(s, x.z, y.z);
    y.w = fmaf(s, x.w, y.w);
  }
  template <typename F>
  static __device__ __forceinline__ T map(const T& a, const T& b, F f) {
    return make_float4(f(a.x, b.x), f(a.y, b.y), f(a.z, b.z), f(a.w, b.w));
  }
  static __device__ __forceinline__ void store(float* row, int i, const T& v) {
    reinterpret_cast<float4*>(row)[i] = v;
  }
};

template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T load(const float* row, int i) { return __ldg(row + i); }
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ float dot(T a, T b) { return a * b; }
  static __device__ __forceinline__ void axpy(T& y, float s, T x) { y = fmaf(s, x, y); }
  template <typename F>
  static __device__ __forceinline__ T map(T a, T b, F f) { return f(a, b); }
  static __device__ __forceinline__ void store(float* row, int i, T v) { row[i] = v; }
};

__device__ __forceinline__ const float* row_of(const float* base, int64_t ld,
                                              int64_t id, int64_t rows) {
  return in_rows(id, rows) ? base + id * ld : nullptr;
}

// nb (<= kBatch) dot products of row x with rows[b], each summed over the
// warp; a null row (an id outside the table) reads as zeros
template <int VN>
__device__ __forceinline__ void warp_dots(const float* x, const float* const* rows,
                                          int nb, int nvec, int lane, float* out) {
  using V = Vec<VN>;
  float acc[kBatch];
#pragma unroll
  for (int b = 0; b < kBatch; ++b) acc[b] = 0.f;
  if (x != nullptr) {
    for (int i = lane; i < nvec; i += 32) {
      const typename V::T xv = V::load(x, i);
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (b < nb && rows[b] != nullptr) acc[b] += V::dot(xv, V::load(rows[b], i));
    }
  }
#pragma unroll
  for (int b = 0; b < kBatch; ++b) out[b] = warp_sum(acc[b]);
}

__global__ void sgns_clear(Args a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < a.T) {
    const int64_t tok = token(a, static_cast<int>(i));
    if (in_rows(tok, a.rows_in)) a.cnt_in[tok] = 0.f;
    if (in_rows(tok, a.rows_out)) a.cnt_out[tok] = 0.f;
  }
  if (i < a.TG) {
    a.grp_act[i] = 0;
    a.grp_occ[i] = 0.f;
  }
  if (i < static_cast<int64_t>(a.TG) * a.K) {
    const int64_t n = neg_row(a, i);
    if (in_rows(n, a.rows_out)) a.cnt_out[n] = 0.f;
  }
  if (i == 0) {
    a.cnt_in[a.rows_in - 1] = 0.f;
    a.cnt_out[a.rows_out - 1] = 0.f;
  }
}

__global__ void sgns_prep(Args a) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.T) return;
  const int64_t tok = token(a, t);
  const bool live = tok >= 0;
  const int64_t b = load_id(a.win, t, a.flags & kWin64);
  int n = 0;    // pairs of centre t
  int occ = 0;  // pairs whose context is position t
  for (int j = 0; j < 2 * a.W; ++j) {
    const int o = offset(j, a.W);
    const int ao = o < 0 ? -o : o;
    const int p = t + o;
    if (live && p >= 0 && p < a.T && ao <= b && token(a, p) >= 0) ++n;
    const int c = t - o;
    if (live && c >= 0 && c < a.T && token(a, c) >= 0 &&
        ao <= load_id(a.win, c, a.flags & kWin64))
      ++occ;
  }
  const bool mean = a.flags & kMean;
  a.npairs[t] = static_cast<float>(n);
  const int64_t cid = (live && n > 0) ? tok : a.rows_in - 1;
  const int64_t oid = live ? tok : a.rows_out - 1;
  a.ids_in[t] = cid;
  a.ids_out[t] = oid;
  // counts in pairs ("sum") or occurrences ("mean"); whole numbers
  if (in_rows(cid, a.rows_in)) atomicAdd(a.cnt_in + cid, mean ? 1.f : static_cast<float>(n));
  if (occ > 0 && in_rows(oid, a.rows_out)) atomicAdd(a.cnt_out + oid, static_cast<float>(occ));
  if (n > 0) {
    a.grp_act[t / a.G] = 1;
    atomicAdd(a.grp_occ + t / a.G, mean ? 1.f : static_cast<float>(n));
  }
}

template <int VN>
__global__ void __launch_bounds__(kThreads) sgns_score(Args a) {
  __shared__ double s_loss[kWarps];
  __shared__ double s_pairs[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = blockIdx.x * kWarps + warp;
  double loss = 0.0;
  int pairs = 0;
  if (t < a.T) {
    const int W2 = 2 * a.W;
    const int grp = t / a.G;
    const bool grp_live = a.grp_act[grp] != 0;
    if (t % a.G == 0) {
      // the group's negative rows, once: the sentinel for a dead group
      for (int k = lane; k < a.K; k += 32) {
        const int64_t gk = static_cast<int64_t>(grp) * a.K + k;
        const int64_t n = grp_live ? neg_row(a, gk) : a.rows_out - 1;
        a.ids_neg[gk] = n;
        if (grp_live && in_rows(n, a.rows_out)) atomicAdd(a.cnt_out + n, a.grp_occ[grp]);
      }
    }
    const float np = a.npairs[t];
    float* g = a.g + static_cast<int64_t>(t) * W2;
    float* gn = a.g_neg + static_cast<int64_t>(t) * a.K;
    if (np == 0.f) {  // a dead centre: no pair, its negatives count for nothing
      for (int j = lane; j < W2; j += 32) g[j] = 0.f;
      for (int k = lane; k < a.K; k += 32) gn[k] = 0.f;
    } else {
      const int nvec = a.D / VN;
      const float* x = row_of(a.w_in, a.ld_in, a.ids_in[t], a.rows_in);
      const int total = W2 + a.K;
      double lpos = 0.0, lneg = 0.0;
      for (int base = 0; base < total; base += kBatch) {
        const int nb = min(kBatch, total - base);
        const float* rows[kBatch];
        bool pos[kBatch], live[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int idx = base + b;
          rows[b] = nullptr;
          pos[b] = idx < W2;
          live[b] = false;
          if (b < nb) {
            if (pos[b]) {
              live[b] = pair_ok(a, t, idx);
              if (live[b])
                rows[b] = row_of(a.w_out, a.ld_out, token(a, t + offset(idx, a.W)),
                                     a.rows_out);
            } else {
              live[b] = true;
              rows[b] = row_of(a.w_out, a.ld_out,
                                   neg_row(a, static_cast<int64_t>(grp) * a.K + idx - W2),
                                   a.rows_out);
            }
          }
        }
        float s[kBatch];
        warp_dots<VN>(x, rows, nb, nvec, lane, s);
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (b >= nb) continue;
          const int idx = base + b;
          if (pos[b]) {
            float gv = 0.f;
            if (live[b]) {
              gv = sigmoid(s[b]) - 1.0f;
              lpos += log_sigmoid(s[b]);
              ++pairs;
            }
            if (lane == 0) g[idx] = gv;
          } else {
            if (lane == 0) gn[idx - W2] = sigmoid(s[b]);
            lneg += log_sigmoid(-s[b]);
          }
        }
      }
      // each of the centre's pairs shares its negatives' loss
      loss = lpos + static_cast<double>(np) * lneg;
    }
  }
  if (lane == 0) {
    s_loss[warp] = loss;
    s_pairs[warp] = pairs;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double l = 0.0, p = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      l += s_loss[w];
      p += s_pairs[w];
    }
    a.partial[2 * blockIdx.x] = l;
    a.partial[2 * blockIdx.x + 1] = p;
  }
}

// loss = -(sum of the partials) / max(pairs * (1 + K), 1), in a fixed order
__device__ void reduce_loss(const Args& a, int lane) {
  double l = 0.0, p = 0.0;
  for (int i = lane; i < a.n_partial; i += 32) {
    l += a.partial[2 * i];
    p += a.partial[2 * i + 1];
  }
  l = warp_sum(l);
  p = warp_sum(p);
  if (lane == 0) {
    const double terms = p * (1.0 + a.K);
    a.result[0] = static_cast<float>(-l / (terms > 1.0 ? terms : 1.0));
    a.result[1] = static_cast<float>(p);
  }
}

// d_in[t] = -lr * scale * (sum_j g[t,j] u[t+o_j] + c * sum_k g_neg[t,k] u_neg[k])
template <int VN>
__device__ void grad_in(const Args& a, int t, int lane) {
  using V = Vec<VN>;
  const int W2 = 2 * a.W, nvec = a.D / VN;
  const int64_t grp = t / a.G;
  const float np = a.npairs[t];
  const float cnt = in_rows(a.ids_in[t], a.rows_in) ? a.cnt_in[a.ids_in[t]] : 1.f;
  const bool mean = a.flags & kMean;
  const float scale = mean ? cnt : step_scale(cnt, a.lr, a.cap);
  const float np1 = fmaxf(np, 1.0f);
  const float* g = a.g + static_cast<int64_t>(t) * W2;
  const float* gn = a.g_neg + static_cast<int64_t>(t) * a.K;
  float* out = a.d_in + static_cast<int64_t>(t) * a.D;
  for (int i = lane; i < nvec; i += 32) {
    typename V::T pos = V::zero(), nv = V::zero();
    for (int j = 0; j < W2; ++j) {
      const float gv = g[j];
      if (gv == 0.f) continue;
      const float* u = row_of(a.w_out, a.ld_out, a.ids_out[t + offset(j, a.W)], a.rows_out);
      if (u != nullptr) V::axpy(pos, gv, V::load(u, i));
    }
    for (int k = 0; k < a.K; ++k) {
      const float gv = gn[k];
      if (gv == 0.f) continue;
      const float* u = row_of(a.w_out, a.ld_out, a.ids_neg[grp * a.K + k], a.rows_out);
      if (u != nullptr) V::axpy(nv, gv, V::load(u, i));
    }
    const float nlr = a.neg_lr;
    typename V::T d;
    if (mean) {
      d = V::map(pos, nv, [=](float p, float n) { return nlr * ((p / np1 + n) / scale); });
    } else {
      d = V::map(pos, nv, [=](float p, float n) { return nlr * ((p + np * n) * scale); });
    }
    V::store(out, i, d);
  }
}

// d_out[p] = -lr * scale * sum_j g[p-o_j, j] v[p-o_j]: the rolled sum of
// the eager step, gathered at its destination
template <int VN>
__device__ void grad_out(const Args& a, int p, int lane) {
  using V = Vec<VN>;
  const int W2 = 2 * a.W, nvec = a.D / VN;
  const int64_t oid = a.ids_out[p];
  const float cnt = in_rows(oid, a.rows_out) ? a.cnt_out[oid] : 0.f;
  const bool mean = a.flags & kMean;
  const float scale = mean ? fmaxf(cnt, 1.0f) : step_scale(cnt, a.lr, a.cap);
  float* out = a.d_out + static_cast<int64_t>(p) * a.D;
  for (int i = lane; i < nvec; i += 32) {
    typename V::T acc = V::zero();
    for (int j = 0; j < W2; ++j) {
      const int c = p - offset(j, a.W);
      if (c < 0 || c >= a.T) continue;
      const float gv = a.g[static_cast<int64_t>(c) * W2 + j];
      if (gv == 0.f) continue;
      const float* v = row_of(a.w_in, a.ld_in, a.ids_in[c], a.rows_in);
      if (v != nullptr) V::axpy(acc, gv, V::load(v, i));
    }
    const float nlr = a.neg_lr;
    typename V::T d;
    if (mean) {
      d = V::map(acc, acc, [=](float x, float) { return nlr * (x / scale); });
    } else {
      d = V::map(acc, acc, [=](float x, float) { return nlr * (x * scale); });
    }
    V::store(out, i, d);
  }
}

// d_neg[g,k] = -lr * scale * sum_c w[g,c,k] v[gG+c], with w = g_neg * npairs
// ("sum") or g_neg ("mean")
template <int VN>
__device__ void grad_neg(const Args& a, int64_t gk, int lane) {
  using V = Vec<VN>;
  const int nvec = a.D / VN;
  const int64_t grp = gk / a.K;
  const int k = static_cast<int>(gk % a.K);
  const int64_t nid = a.ids_neg[gk];
  const float cnt = in_rows(nid, a.rows_out) ? a.cnt_out[nid] : 0.f;
  const bool mean = a.flags & kMean;
  const float scale = mean ? fmaxf(cnt, 1.0f) : step_scale(cnt, a.lr, a.cap);
  float* out = a.d_neg + gk * a.D;
  for (int i = lane; i < nvec; i += 32) {
    typename V::T acc = V::zero();
    for (int c = 0; c < a.G; ++c) {
      const int64_t t = grp * a.G + c;
      float w = a.g_neg[t * a.K + k];
      if (w == 0.f) continue;
      if (!mean) w *= a.npairs[t];
      const float* v = row_of(a.w_in, a.ld_in, a.ids_in[t], a.rows_in);
      if (v != nullptr) V::axpy(acc, w, V::load(v, i));
    }
    const float nlr = a.neg_lr;
    typename V::T d;
    if (mean) {
      d = V::map(acc, acc, [=](float x, float) { return nlr * (x / scale); });
    } else {
      d = V::map(acc, acc, [=](float x, float) { return nlr * (x * scale); });
    }
    V::store(out, i, d);
  }
}

// blocks [0, n_in) take input rows, [n_in, n_in + n_out) positive output
// rows, the rest negative rows; warp 0 of block 0 also reduces the loss
template <int VN>
__global__ void __launch_bounds__(kThreads) sgns_grad(Args a, int n_in, int n_out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (blockIdx.x == 0 && warp == 0) reduce_loss(a, lane);
  int b = blockIdx.x;
  if (b < n_in) {
    const int t = b * kWarps + warp;
    if (t < a.T) grad_in<VN>(a, t, lane);
    return;
  }
  b -= n_in;
  if (b < n_out) {
    const int p = b * kWarps + warp;
    if (p < a.T) grad_out<VN>(a, p, lane);
    return;
  }
  b -= n_out;
  const int64_t gk = static_cast<int64_t>(b) * kWarps + warp;
  if (gk < static_cast<int64_t>(a.TG) * a.K) grad_neg<VN>(a, gk, lane);
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// the scratch array's layout, in floats (the partials 8-byte aligned)
struct Layout {
  int64_t npairs, g, g_neg, grp_occ, grp_act, cnt_in, cnt_out, partial, total;
  int64_t n_partial;
};

Layout layout(int64_t T, int64_t W, int64_t K, int64_t G, int64_t rows_in,
              int64_t rows_out) {
  Layout l;
  const int64_t tg = T / G;
  l.n_partial = cdiv(T, kWarps);
  l.npairs = 0;
  l.g = l.npairs + T;
  l.g_neg = l.g + T * 2 * W;
  l.grp_occ = l.g_neg + T * K;
  l.grp_act = l.grp_occ + tg;
  l.cnt_in = l.grp_act + tg;
  l.cnt_out = l.cnt_in + rows_in;
  l.partial = cdiv(l.cnt_out + rows_out, 2) * 2;
  l.total = l.partial + 4 * l.n_partial;
  return l;
}

}  // namespace

// One chunk: ids (2T + T/G*K int64: centre rows, context rows, negative
// rows), deltas (the same rows x D float32, -lr and the row scales
// applied), result (loss, pairs). scratch holds scratch_floats floats,
// 8-byte aligned, at least layout(...).total (ops/sgns.py _scratch_floats
// computes the same sum); its contents on entry do not matter.
extern "C" int mvt_sgns_chunk(const void* w_in, int64_t ld_in, int64_t rows_in,
                              const void* w_out, int64_t ld_out, int64_t rows_out,
                              const void* block, const void* win, const void* neg,
                              const void* slots, int64_t n_slots, int64_t T,
                              int64_t D, int64_t W, int64_t K, int64_t G,
                              int64_t flags, double lr, double cap, void* ids,
                              void* deltas, void* scratch, int64_t scratch_floats,
                              void* result, void* stream) {
  if (T <= 0 || D <= 0 || G <= 0 || T % G || W < 0 || K < 0 || rows_in <= 0 ||
      rows_out <= 0 || T >= (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(T, W, K, G, rows_in, rows_out);
  if (scratch_floats < l.total || reinterpret_cast<uintptr_t>(scratch) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  float* sc = static_cast<float*>(scratch);
  int64_t* id = static_cast<int64_t*>(ids);
  float* dl = static_cast<float*>(deltas);
  const int64_t tg = T / G;
  Args a;
  a.w_in = static_cast<const float*>(w_in);
  a.ld_in = ld_in;
  a.rows_in = rows_in;
  a.w_out = static_cast<const float*>(w_out);
  a.ld_out = ld_out;
  a.rows_out = rows_out;
  a.block = block;
  a.win = win;
  a.neg = neg;
  a.slots = slots;
  a.n_slots = n_slots;
  a.T = static_cast<int>(T);
  a.D = static_cast<int>(D);
  a.W = static_cast<int>(W);
  a.K = static_cast<int>(K);
  a.G = static_cast<int>(G);
  a.TG = static_cast<int>(tg);
  a.flags = flags;
  a.lr = static_cast<float>(lr);
  a.neg_lr = static_cast<float>(-lr);
  a.cap = static_cast<float>(cap);
  a.ids_in = id;
  a.ids_out = id + T;
  a.ids_neg = id + 2 * T;
  a.d_in = dl;
  a.d_out = dl + T * D;
  a.d_neg = dl + 2 * T * D;
  a.npairs = sc + l.npairs;
  a.g = sc + l.g;
  a.g_neg = sc + l.g_neg;
  a.grp_occ = sc + l.grp_occ;
  a.grp_act = reinterpret_cast<int*>(sc + l.grp_act);
  a.cnt_in = sc + l.cnt_in;
  a.cnt_out = sc + l.cnt_out;
  a.partial = reinterpret_cast<double*>(sc + l.partial);
  a.n_partial = static_cast<int>(l.n_partial);
  a.result = static_cast<float*>(result);

  const bool vec4 = D % 4 == 0 && ld_in % 4 == 0 && ld_out % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(w_in) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w_out) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(deltas) % 16 == 0;
  const int64_t clear_n = T > tg * K ? T : tg * K;
  sgns_clear<<<static_cast<unsigned>(cdiv(clear_n, kThreads)), kThreads, 0, s>>>(a);
  sgns_prep<<<static_cast<unsigned>(cdiv(T, kThreads)), kThreads, 0, s>>>(a);
  const int n_rows = static_cast<int>(cdiv(T, kWarps));
  const int n_neg = static_cast<int>(cdiv(tg * K, kWarps));
  if (vec4) {
    sgns_score<4><<<n_rows, kThreads, 0, s>>>(a);
    sgns_grad<4><<<2 * n_rows + n_neg, kThreads, 0, s>>>(a, n_rows, n_rows);
  } else {
    sgns_score<1><<<n_rows, kThreads, 0, s>>>(a);
    sgns_grad<1><<<2 * n_rows + n_neg, kThreads, 0, s>>>(a, n_rows, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
