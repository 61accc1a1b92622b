// Wire sparsification codec — capability parity with the reference's
// quantization filters.
//
// Reference capability (not copied): SparseFilter<data,index> encodes a
// float payload as (index, value) pairs when more than half the entries are
// zero, with a size side-channel so the receiver knows whether the blob is
// compressed (include/multiverso/util/quantization_util.h:37-154).
//
// Role in the port: compression only matters on HOST hops (the C-API /
// external client bridge, the cold tier) — device traffic never takes it.
// Format:
//   [u32 magic 'MVSF'][u32 kind 0=dense,1=sparse][u64 count]
//   dense:  count * f32
//   sparse: [u64 nnz] nnz * (u32 index, f32 value)
#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace mvtpu {

// Returns the encoded byte size written to `out` (resized as needed).
// Chooses the sparse form when strictly less than half the values are
// nonzero, dense otherwise.
size_t SparseEncode(const float* data, size_t count, std::vector<uint8_t>* out);

// Decodes into `data` (must hold `count` floats). Returns false on a
// malformed payload or count mismatch.
bool SparseDecode(const uint8_t* bytes, size_t byte_len, float* data,
                  size_t count);

}  // namespace mvtpu
