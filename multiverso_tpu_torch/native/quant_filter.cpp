// Quantized delta pack/unpack — the native half of the OneBits-slot codec
// (utils/quantization.py owns the header + scale derivation; this is the
// hot O(n) bit packing). Byte-identical to the numpy fallback: float32
// elementwise math with nearbyintf (round-half-to-even matches np.rint),
// little-endian code order within each byte.
//
// Reference capability (not copied): OneBitsFilter was an empty stub
// (include/multiverso/util/quantization_util.h:160-161); the reference's
// quantization story never shipped. Implemented here: client-side
// error feedback lives in Python, this file only moves bits.
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// Pack n float32 values at `bits` (1|2|4|8) per value into out
// (ceil(n*(8/bits)) bytes, caller-zeroed). q = clip(rint((x-lo)*inv), 0,
// 2^bits-1); codes fill each byte from its low bits upward.
void MVTPU_QuantPack(const float* x, size_t n, float lo, float inv,
                     int bits, uint8_t* out) {
  const int per_byte = 8 / bits;
  const float levels = static_cast<float>((1 << bits) - 1);
  for (size_t i = 0; i < n; ++i) {
    float q = nearbyintf((x[i] - lo) * inv);
    if (q < 0.0f) q = 0.0f;
    if (q > levels) q = levels;
    const unsigned code = static_cast<unsigned>(q);
    out[i / per_byte] |=
        static_cast<uint8_t>(code << (bits * (i % per_byte)));
  }
}

// Unpack n codes back to float32: x = lo + q*step.
void MVTPU_QuantUnpack(const uint8_t* in, size_t n, float lo, float step,
                       int bits, float* out) {
  const int per_byte = 8 / bits;
  const unsigned mask = (1u << bits) - 1u;
  for (size_t i = 0; i < n; ++i) {
    const unsigned code = (in[i / per_byte] >> (bits * (i % per_byte))) & mask;
    out[i] = lo + static_cast<float>(code) * step;
  }
}

}  // extern "C"
