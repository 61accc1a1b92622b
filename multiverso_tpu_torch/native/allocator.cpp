#include "allocator.h"

#include <cstdlib>
#include <cstring>
#include <mutex>
#include <new>
#include <unordered_map>
#include <vector>

namespace mvtpu {

namespace {

// Block header layout: [ bucket_or_size | slot offset | atomic refcount ],
// placed in the 32 bytes immediately before the payload. The slot (distance
// from the malloc'd base to the payload) is a multiple of the requested
// alignment so the payload honors alignments > 32 too.
struct Header {
  uint64_t bucket;                // pool bucket (smart) or raw size (default)
  uint32_t slot;                  // payload - slot == malloc'd base
  std::atomic<int> refcount;
};

constexpr size_t kHeaderSlot = 32;  // header room reserved before payload
static_assert(sizeof(Header) <= kHeaderSlot, "header must fit the slot");

inline Header* header_of(char* data) {
  return reinterpret_cast<Header*>(data - kHeaderSlot);
}

inline char* base_of(char* data) { return data - header_of(data)->slot; }

inline char* raw_alloc(size_t payload, size_t alignment) {
  size_t align = alignment < alignof(Header) ? alignof(Header) : alignment;
  if (align < sizeof(void*)) align = sizeof(void*);
  size_t slot = kHeaderSlot > align ? kHeaderSlot : align;
  void* raw = nullptr;
  if (posix_memalign(&raw, align, slot + payload) != 0) {
    throw std::bad_alloc();
  }
  char* data = static_cast<char*>(raw) + slot;
  header_of(data)->slot = static_cast<uint32_t>(slot);
  return data;
}

inline uint64_t bucket_for(size_t size) {
  uint64_t b = 32;
  while (b < size) b <<= 1;
  return b;
}

}  // namespace

char* DefaultAllocator::Alloc(size_t size) {
  char* data = raw_alloc(size, alignment_);
  Header* h = header_of(data);
  h->bucket = size;
  new (&h->refcount) std::atomic<int>(1);
  live_.fetch_add(1);
  return data;
}

void DefaultAllocator::Free(char* data) {
  if (data == nullptr) return;
  Header* h = header_of(data);
  if (h->refcount.fetch_sub(1) == 1) {
    live_.fetch_sub(1);
    std::free(base_of(data));
  }
}

void DefaultAllocator::Refer(char* data) {
  header_of(data)->refcount.fetch_add(1);
}

struct SmartAllocator::Impl {
  size_t alignment;
  std::mutex mutex;
  std::unordered_map<uint64_t, std::vector<char*>> free_lists;
};

SmartAllocator::SmartAllocator(size_t alignment) : impl_(new Impl) {
  impl_->alignment = alignment;
}

SmartAllocator::~SmartAllocator() {
  std::lock_guard<std::mutex> lock(impl_->mutex);
  for (auto& kv : impl_->free_lists) {
    for (char* data : kv.second) {
      std::free(base_of(data));
    }
  }
  delete impl_;
}

char* SmartAllocator::Alloc(size_t size) {
  uint64_t bucket = bucket_for(size);
  {
    std::lock_guard<std::mutex> lock(impl_->mutex);
    auto it = impl_->free_lists.find(bucket);
    if (it != impl_->free_lists.end() && !it->second.empty()) {
      char* data = it->second.back();
      it->second.pop_back();
      pooled_.fetch_sub(1);
      live_.fetch_add(1);
      Header* h = header_of(data);
      h->refcount.store(1);
      return data;
    }
  }
  char* data = raw_alloc(bucket, impl_->alignment);
  Header* h = header_of(data);
  h->bucket = bucket;
  new (&h->refcount) std::atomic<int>(1);
  live_.fetch_add(1);
  return data;
}

void SmartAllocator::Free(char* data) {
  if (data == nullptr) return;
  Header* h = header_of(data);
  if (h->refcount.fetch_sub(1) == 1) {
    std::lock_guard<std::mutex> lock(impl_->mutex);
    impl_->free_lists[h->bucket].push_back(data);
    live_.fetch_sub(1);
    pooled_.fetch_add(1);
  }
}

void SmartAllocator::Refer(char* data) {
  header_of(data)->refcount.fetch_add(1);
}

// Singleton configuration: type/alignment are latched by the first Get();
// MVTPU_ConfigureAllocator must run before any allocation (the Python side
// calls it from mv.init() with the allocator_type/allocator_alignment flags).
namespace {
std::mutex g_singleton_mutex;
std::atomic<Allocator*> g_instance{nullptr};
bool g_smart = true;
size_t g_alignment = 16;
}  // namespace

Allocator* Allocator::Get() {
  Allocator* inst = g_instance.load(std::memory_order_acquire);
  if (inst != nullptr) return inst;
  std::lock_guard<std::mutex> lock(g_singleton_mutex);
  inst = g_instance.load(std::memory_order_relaxed);
  if (inst == nullptr) {
    if (g_smart) {
      inst = new SmartAllocator(g_alignment);
    } else {
      inst = new DefaultAllocator(g_alignment);
    }
    g_instance.store(inst, std::memory_order_release);
  }
  return inst;
}

}  // namespace mvtpu

// Flat C exports for the ctypes binding / tests.
extern "C" {

// Returns 0 on success; -1 if the singleton already exists with a different
// configuration (too late to change); -2 on an unknown type string; -3 on an
// alignment posix_memalign would reject (not a power of two >= sizeof(void*))
// — rejected here so a bad flag is a configure error, not a bad_alloc thrown
// across the FFI boundary at first allocation.
int MVTPU_ConfigureAllocator(const char* type, size_t alignment) {
  bool smart;
  if (std::strcmp(type, "smart") == 0) {
    smart = true;
  } else if (std::strcmp(type, "default") == 0) {
    smart = false;
  } else {
    return -2;
  }
  if (alignment < sizeof(void*) || (alignment & (alignment - 1)) != 0) {
    return -3;
  }
  std::lock_guard<std::mutex> lock(mvtpu::g_singleton_mutex);
  if (mvtpu::g_instance.load() != nullptr) {
    return (smart == mvtpu::g_smart && alignment == mvtpu::g_alignment) ? 0
                                                                        : -1;
  }
  mvtpu::g_smart = smart;
  mvtpu::g_alignment = alignment;
  return 0;
}

const char* MVTPU_AllocatorType() {
  std::lock_guard<std::mutex> lock(mvtpu::g_singleton_mutex);
  return mvtpu::g_smart ? "smart" : "default";
}

void* MVTPU_Alloc(size_t size) { return mvtpu::Allocator::Get()->Alloc(size); }

void MVTPU_Free(void* data) {
  mvtpu::Allocator::Get()->Free(static_cast<char*>(data));
}

void MVTPU_Refer(void* data) {
  mvtpu::Allocator::Get()->Refer(static_cast<char*>(data));
}

size_t MVTPU_AllocatorLiveBlocks() {
  return mvtpu::Allocator::Get()->live_blocks();
}

size_t MVTPU_AllocatorPooledBlocks() {
  return mvtpu::Allocator::Get()->pooled_blocks();
}

}  // extern "C"
