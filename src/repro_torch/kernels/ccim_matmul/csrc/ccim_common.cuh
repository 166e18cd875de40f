// Shared device helpers of the prepacked hybrid-CIM GEMM kernels.
//
// Per acc_len-element chunk c (one ADC conversion of the macro):
//   exact_c = sum x * w                       (int8 dot, __dp4a)
//   dcim_c  = sum_i sum x_{j_i} * P_i         (activation bit-plane j_i
//                                              against folded plane P_i)
//   acim_c  = exact_c - lsb * dcim_c
//   code_c  = clamp(floor((acim_c + lsb/2) / lsb), -half, half - 1)
//   out     = lsb * sum_c (dcim_c + code_c)   (int32)
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ccim {

// At most 3 distinct activation bits pair with folded planes: the widest
// admitted split (top-6 bit-products) uses j = 6, 5, 4.
constexpr int kMaxPlanes = 3;

// Signed activation bit-plane j of four packed int8 lanes: per byte
// sign(x) * ((|x| >> j) & 1), in {-1, 0, +1}.  SMF activations satisfy
// |x| <= 127, so __vabs4 never meets -128; sign(0) is irrelevant because
// every bit of 0 is 0.
__device__ __forceinline__ int bit_plane4(int x4, int j) {
  const unsigned a = __vabs4(static_cast<unsigned>(x4));
  const unsigned bits = (a >> j) & 0x01010101u;           // 0/1 per byte
  const unsigned neg = (static_cast<unsigned>(x4) >> 7) & 0x01010101u;
  // a set bit of a negative byte becomes 0xFF (-1): 0x01 | 0xFE
  return static_cast<int>(bits | ((bits & neg) * 0xFEu));
}

__device__ __forceinline__ int4 bit_plane16(int4 v, int j) {
  return make_int4(bit_plane4(v.x, j), bit_plane4(v.y, j),
                   bit_plane4(v.z, j), bit_plane4(v.w, j));
}

// One conversion: y8 = dcim + code.  lsb = 2^lsb_shift, so the floor
// division is an arithmetic right shift; C's '/' truncates toward zero
// and would be wrong for negative acim.
__device__ __forceinline__ int convert(int exact, int dcim, int lsb_shift,
                                       int adc_half) {
  const int lsb = 1 << lsb_shift;
  const int acim = exact - dcim * lsb;
  int code = (acim + (lsb >> 1)) >> lsb_shift;
  code = max(-adc_half, min(code, adc_half - 1));
  return dcim + code;
}

__device__ __forceinline__ int dot16(int4 a, int4 b, int c) {
  c = __dp4a(a.x, b.x, c);
  c = __dp4a(a.y, b.y, c);
  c = __dp4a(a.z, b.z, c);
  return __dp4a(a.w, b.w, c);
}

}  // namespace ccim
