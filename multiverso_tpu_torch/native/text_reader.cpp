// See text_reader.h. Design: slurp the file once, split it into chunks at
// newline boundaries, parse chunks on std::thread workers (row order is
// preserved by counting rows per chunk first, then writing each chunk at
// its exclusive-prefix offset), and hand back flat arrays shaped exactly
// like the Python loader's padded batch contract.
//
// Numeric parsing is std::from_chars throughout: locale-independent
// (strtof honors LC_NUMERIC, so an embedding host that called
// setlocale() would silently mis-parse '0.5') and naturally bounded by
// the line end. Any malformed token makes the whole parse return an
// error — the Python caller then falls back to its own parser, which
// raises loudly, so a bad file never trains silently-different data
// depending on whether the .so is built.
#include "text_reader.h"

#include <atomic>
#include <charconv>
#include <climits>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Chunk {
  const char* begin;
  const char* end;
  long long rows = 0;          // live (non-blank) lines
  long long row_offset = 0;    // exclusive prefix sum
};

inline bool is_ws(char c) {
  // match Python str.strip()'s ASCII whitespace (minus '\n', which
  // delimits lines here)
  return c == ' ' || c == '\t' || c == '\r' || c == '\f' || c == '\v';
}

inline const char* skip_ws(const char* p, const char* e) {
  while (p < e && is_ws(*p)) ++p;
  return p;
}

inline bool is_blank(const char* b, const char* e) {
  return skip_ws(b, e) == e;
}

// std::from_chars rejects a leading '+', but Python's int()/float()
// accept one ('+1' is the canonical libsvm positive-label spelling).
// Skip it only when a digit or '.' follows so '++1'/'+-1' still fail
// the native parse and fall back to the loud Python path.
inline const char* skip_plus(const char* p, const char* e) {
  if (p + 1 < e && *p == '+' &&
      ((p[1] >= '0' && p[1] <= '9') || p[1] == '.'))
    return p + 1;
  return p;
}

// Joins already-started threads before any exception propagates: a
// std::thread destroyed while joinable calls std::terminate, which would
// abort the embedding host before MVTR_ParseLibsvmFile's catch(...) runs.
struct ThreadBatch {
  std::vector<std::thread> ts;
  template <typename F>
  void spawn(F&& f) {
    try {
      ts.emplace_back(std::forward<F>(f));
    } catch (...) {
      join_all();
      throw;  // contained by the extern "C" catch, reported as an error
    }
  }
  void join_all() {
    for (auto& t : ts)
      if (t.joinable()) t.join();
  }
  ~ThreadBatch() { join_all(); }
};

long long count_rows(const Chunk& c) {
  long long rows = 0;
  const char* p = c.begin;
  while (p < c.end) {
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(c.end - p)));
    const char* line_end = nl ? nl : c.end;
    if (!is_blank(p, line_end)) ++rows;
    p = nl ? nl + 1 : c.end;
  }
  return rows;
}

// Returns false on any malformed line (caller falls back to Python).
bool parse_chunk(const Chunk& c, int max_nnz, int* labels, int* indices,
                 float* values) {
  long long row = c.row_offset;
  const char* p = c.begin;
  while (p < c.end) {
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(c.end - p)));
    const char* line_end = nl ? nl : c.end;
    if (!is_blank(p, line_end)) {
      const char* cursor = skip_plus(skip_ws(p, line_end), line_end);
      double labelf;
      auto lr = std::from_chars(cursor, line_end, labelf);
      if (lr.ec != std::errc()) return false;  // int(float(tok)) raises
      // nan/inf/out-of-int32-range: Python raises (ValueError/Overflow);
      // a raw cast would be UB — fail so the caller takes the loud path
      if (!std::isfinite(labelf) || labelf >= 2147483648.0 ||
          labelf < -2147483648.0)
        return false;
      labels[row] = static_cast<int>(labelf);
      cursor = lr.ptr;
      int* idx = indices + row * max_nnz;
      float* val = values + row * max_nnz;
      int k = 0;
      while (k < max_nnz) {
        cursor = skip_ws(cursor, line_end);
        if (cursor >= line_end) break;
        cursor = skip_plus(cursor, line_end);
        int feature;
        auto fr = std::from_chars(cursor, line_end, feature);
        if (fr.ec != std::errc()) return false;  // int(k) raises
        cursor = fr.ptr;
        float v = 1.0f;
        if (cursor < line_end && *cursor == ':') {
          ++cursor;
          // "k:" with nothing (or whitespace) next -> 1.0, like the
          // Python `float(v) if v else 1.0` after partition(":")
          if (cursor < line_end && !is_ws(*cursor)) {
            // parse as DOUBLE then narrow: Python computes
            // float32(float64(token)), and from_chars<float> can differ
            // from that double-rounding path by 1 ulp
            cursor = skip_plus(cursor, line_end);
            double vd;
            auto vr = std::from_chars(cursor, line_end, vd);
            if (vr.ec != std::errc()) return false;  // float("abc") raises
            v = static_cast<float>(vd);
            cursor = vr.ptr;
          }
        }
        idx[k] = feature;
        val[k] = v;
        ++k;
      }
      // Python slices parts[1:max_nnz+1]: tokens beyond max_nnz are
      // ignored WITHOUT validation — skip the rest of the line
      ++row;
    }
    p = nl ? nl + 1 : c.end;
  }
  return true;
}

int parse_impl(const char* path, int max_nnz, MVTRResult* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 2;
  if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return 2; }
  long long size = ftell(f);
  if (size < 0) { fclose(f); return 2; }
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size));
  if (size > 0 &&
      fread(buf.data(), 1, static_cast<size_t>(size), f) !=
          static_cast<size_t>(size)) {
    fclose(f);
    return 3;
  }
  fclose(f);

  unsigned nt = std::thread::hardware_concurrency();
  if (nt == 0) nt = 1;
  if (nt > 8) nt = 8;
  const char* base = buf.data();
  const char* end = base + size;
  std::vector<Chunk> chunks;
  const char* cur = base;
  for (unsigned t = 0; t < nt && cur < end; ++t) {
    const char* target =
        (t + 1 == nt) ? end : base + size * (t + 1) / nt;
    if (target < cur) target = cur;
    // extend to the next newline so no line spans two chunks
    const char* nl = target < end
        ? static_cast<const char*>(
              memchr(target, '\n', static_cast<size_t>(end - target)))
        : nullptr;
    const char* stop = nl ? nl + 1 : end;
    chunks.push_back(Chunk{cur, stop});
    cur = stop;
  }

  {  // count pass (parallel)
    ThreadBatch ts;
    for (auto& c : chunks)
      ts.spawn([&c] { c.rows = count_rows(c); });
    ts.join_all();
  }
  long long total = 0;
  for (auto& c : chunks) {
    c.row_offset = total;
    total += c.rows;
  }

  out->n_rows = total;
  out->max_nnz = max_nnz;
  out->labels = static_cast<int*>(malloc(sizeof(int) * total));
  out->indices =
      static_cast<int*>(malloc(sizeof(int) * total * max_nnz));
  out->values =
      static_cast<float*>(malloc(sizeof(float) * total * max_nnz));
  if (total > 0 && (!out->labels || !out->indices || !out->values)) {
    MVTR_FreeResult(out);
    return 4;
  }
  // int32 -1 is all-0xFF bytes: one memset instead of a serial loop
  memset(out->indices, 0xFF, sizeof(int) * total * max_nnz);
  memset(out->values, 0, sizeof(float) * total * max_nnz);

  std::atomic<bool> ok{true};
  {  // parse pass (parallel; disjoint output ranges per chunk)
    ThreadBatch ts;
    for (auto& c : chunks)
      ts.spawn([&c, max_nnz, out, &ok] {
        if (!parse_chunk(c, max_nnz, out->labels, out->indices,
                         out->values))
          ok.store(false, std::memory_order_relaxed);
      });
    ts.join_all();
  }
  if (!ok.load()) {
    MVTR_FreeResult(out);
    return 5;  // malformed input: caller uses the (loud) Python path
  }
  return 0;
}

}  // namespace

extern "C" int MVTR_ParseLibsvmFile(const char* path, int max_nnz,
                                    MVTRResult* out) {
  if (!path || !out || max_nnz <= 0) return 1;
  out->n_rows = 0;
  out->labels = nullptr;
  out->indices = nullptr;
  out->values = nullptr;
  try {
    return parse_impl(path, max_nnz, out);
  } catch (...) {
    // bad_alloc (file larger than RAM) / thread spawn failure must not
    // cross the C ABI and abort the embedding host — report and let the
    // caller fall back to the streaming Python reader
    MVTR_FreeResult(out);
    return 6;
  }
}

extern "C" void MVTR_FreeResult(MVTRResult* r) {
  if (!r) return;
  free(r->labels);
  free(r->indices);
  free(r->values);
  r->labels = nullptr;
  r->indices = nullptr;
  r->values = nullptr;
  r->n_rows = 0;
}
