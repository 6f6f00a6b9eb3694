// The BDI codecs' power-of-two scale, shared by the row, tile and GBDI
// compressors.  Mirrors repro_torch/core/bdi_value.py `_pow2_scale`
// bit for bit: the smallest power of two s with maxres / s <= 127.
//
// The exponent comes from the bits of maxres / 127 (a true IEEE
// division, __fdiv_rn) by integer arithmetic, and 2^e is built from bits
// (never frexpf/log2f/exp2f): a subnormal ratio gives e = -126, a ratio
// that underflowed to 0 (maxres > 0) the subnormal 2^-127, e = 128 inf,
// and maxres == 0 (or NaN) gives 1.0.  Needs a build without
// --use_fast_math, so subnormals survive.

#pragma once

__device__ __forceinline__ float pow2_scale(float maxres) {
  if (!(maxres > 0.0f)) return 1.0f;                      // 0 and NaN
  const int bits = __float_as_int(__fdiv_rn(maxres, 127.0f));
  int e = ((bits >> 23) & 0xFF) - 127;                    // floor(log2)
  e += (bits & 0x7FFFFF) != 0;                            // ceil unless 2^k
  if (e >= 128) return __int_as_float(0x7F800000);        // exp2(128) = inf
  if (e >= -126) return __int_as_float((e + 127) << 23);  // normal 2^e
  return __int_as_float(1 << 22);                         // 2^-127
}

// 1 / s, exact, for an s that pow2_scale gives: 2^-e built from bits
// (2^127 for the subnormal 2^-127, the subnormal 2^-127 for 2^127), and
// 0 for inf.  r * pow2_recip(s) is then r / s bit for bit: both round
// the same real r * 2^-e once (subnormal results included), and r / inf
// and r * 0 agree (0 of r's sign, NaN for an infinite r).
__device__ __forceinline__ float pow2_recip(float s) {
  const int eb = __float_as_int(s) >> 23;                 // biased exponent
  if (eb == 0xFF) return 0.0f;                            // inf
  if (eb == 0) return __int_as_float(254 << 23);          // 1 / 2^-127
  if (eb == 254) return __int_as_float(1 << 22);          // 1 / 2^127
  return __int_as_float((254 - eb) << 23);
}
