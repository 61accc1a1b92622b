#include "sparse_filter.h"

#include <cstring>

namespace mvtpu {

namespace {
constexpr uint32_t kMagic = 0x4653564D;  // 'MVSF' little-endian

template <typename T>
void append(std::vector<uint8_t>* out, const T& value) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(&value);
  out->insert(out->end(), p, p + sizeof(T));
}

template <typename T>
bool read(const uint8_t*& p, const uint8_t* end, T* value) {
  if (p + sizeof(T) > end) return false;
  std::memcpy(value, p, sizeof(T));
  p += sizeof(T);
  return true;
}
}  // namespace

size_t SparseEncode(const float* data, size_t count,
                    std::vector<uint8_t>* out) {
  size_t nnz = 0;
  for (size_t i = 0; i < count; ++i) {
    if (data[i] != 0.0f) ++nnz;
  }
  out->clear();
  bool sparse = nnz * 2 < count;
  append(out, kMagic);
  append(out, static_cast<uint32_t>(sparse ? 1 : 0));
  append(out, static_cast<uint64_t>(count));
  if (!sparse) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(data);
    out->insert(out->end(), p, p + count * sizeof(float));
    return out->size();
  }
  append(out, static_cast<uint64_t>(nnz));
  for (size_t i = 0; i < count; ++i) {
    if (data[i] != 0.0f) {
      append(out, static_cast<uint32_t>(i));
      append(out, data[i]);
    }
  }
  return out->size();
}

// Flat C exports for the ctypes binding (utils/quantization.py).
extern "C" {

size_t MVTPU_SparseEncode(const float* data, size_t count, uint8_t* out,
                          size_t capacity) {
  std::vector<uint8_t> buf;
  size_t n = SparseEncode(data, count, &buf);
  if (n > capacity) return 0;
  std::memcpy(out, buf.data(), n);
  return n;
}

int MVTPU_SparseDecode(const uint8_t* bytes, size_t byte_len, float* data,
                       size_t count) {
  return SparseDecode(bytes, byte_len, data, count) ? 1 : 0;
}

}  // extern "C"

bool SparseDecode(const uint8_t* bytes, size_t byte_len, float* data,
                  size_t count) {
  const uint8_t* p = bytes;
  const uint8_t* end = bytes + byte_len;
  uint32_t magic = 0, kind = 0;
  uint64_t n = 0;
  if (!read(p, end, &magic) || magic != kMagic) return false;
  if (!read(p, end, &kind) || !read(p, end, &n)) return false;
  if (n != count) return false;
  if (kind == 0) {
    if (p + count * sizeof(float) > end) return false;
    std::memcpy(data, p, count * sizeof(float));
    return true;
  }
  uint64_t nnz = 0;
  if (!read(p, end, &nnz)) return false;
  std::memset(data, 0, count * sizeof(float));
  for (uint64_t i = 0; i < nnz; ++i) {
    uint32_t idx = 0;
    float value = 0.0f;
    if (!read(p, end, &idx) || !read(p, end, &value) || idx >= count) {
      return false;
    }
    data[idx] = value;
  }
  return true;
}

}  // namespace mvtpu
