// Host-side pooled allocator — capability parity with the reference L0 layer.
//
// Reference capability (not copied): aligned malloc with a header-embedded
// atomic refcount, plus a "smart" size-bucketed (pow2, >=32B) free-list pool
// (include/multiverso/util/allocator.h, src/util/allocator.cpp).
//
// Role in the port: the device data path allocates through PyTorch; this pool backs
// the HOST side of the C-API bridge (staging buffers for Get/Add payloads
// crossing the FFI boundary) where malloc churn at high request rates would
// otherwise dominate.
#pragma once

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace mvtpu {

class Allocator {
 public:
  virtual ~Allocator() = default;
  virtual char* Alloc(size_t size) = 0;
  virtual void Free(char* data) = 0;
  virtual void Refer(char* data) = 0;
  virtual size_t live_blocks() const { return 0; }
  virtual size_t pooled_blocks() const { return 0; }
  // Singleton keyed on the allocator_type / allocator_alignment flags,
  // plumbed from the Python registry via MVTPU_ConfigureAllocator before
  // first use (reference: MV_CONFIG_allocator_type, allocator.cpp:153).
  static Allocator* Get();
};

// Plain aligned allocator: header { atomic<int> refcount } before payload;
// Free releases memory immediately (no pooling).
class DefaultAllocator : public Allocator {
 public:
  explicit DefaultAllocator(size_t alignment = 16) : alignment_(alignment) {}
  char* Alloc(size_t size) override;
  void Free(char* data) override;
  void Refer(char* data) override;
  size_t live_blocks() const override { return live_.load(); }

 private:
  size_t alignment_;
  std::atomic<size_t> live_{0};
};

// Size-bucketed pool: blocks are rounded up to powers of two (>= 32B) and
// recycled through per-bucket LIFO free lists.
class SmartAllocator : public Allocator {
 public:
  explicit SmartAllocator(size_t alignment = 16);
  ~SmartAllocator() override;
  char* Alloc(size_t size) override;
  void Free(char* data) override;
  void Refer(char* data) override;

  size_t live_blocks() const override { return live_.load(); }
  size_t pooled_blocks() const override { return pooled_.load(); }

 private:
  struct Impl;
  Impl* impl_;
  std::atomic<size_t> live_{0};
  std::atomic<size_t> pooled_{0};
};

}  // namespace mvtpu
