// The fp8 (e4m3) cache element of the port's kernels, and its exact
// conversions (sm_89 and later).
//
// An e4m3 cache element is a type of its own, so that no int8 overload (a
// byte permute that reads two's complement) is ever chosen for it.  A pair
// of bytes is decoded by cvt.rn.f16x2.e4m3x2, which is exact (subnormals
// included: every e4m3 value is an f16 value), then f16 -> f32, also exact.
// A value is encoded by cvt.rn.satfinite.e4m3x2.f32: round to nearest even,
// +-448 past the range (infinities too), NaN kept.  The byte 0x7F (and
// 0xFF) is NaN, so a kernel selects masked elements away and never
// multiplies them by a probability of 0.
#pragma once

#include <stdint.h>

struct e4m3_t {
  uint8_t bits;
};

// bytes v & 0xFF and v >> 8 as exact floats (.x the low byte)
__device__ __forceinline__ float2 e4m3x2_to_float2(uint16_t v) {
  uint32_t h;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(h) : "h"(v));
  float lo, hi;
  asm("{\n.reg .b16 l, u;\nmov.b32 {l, u}, %2;\ncvt.f32.f16 %0, l;\n"
      "cvt.f32.f16 %1, u;\n}\n"
      : "=f"(lo), "=f"(hi) : "r"(h));
  return make_float2(lo, hi);
}

__device__ __forceinline__ float to_f(e4m3_t x) {
  return e4m3x2_to_float2(x.bits).x;
}

// the four bytes of a 4-byte word as exact floats, the lowest first
__device__ __forceinline__ float4 e4m3x4_to_float4(uint32_t w) {
  const float2 a = e4m3x2_to_float2((uint16_t)(w & 0xFFFFu));
  const float2 b = e4m3x2_to_float2((uint16_t)(w >> 16));
  return make_float4(a.x, a.y, b.x, b.y);
}

// x rounded to e4m3 with saturation (the byte of the value)
__device__ __forceinline__ e4m3_t to_e4m3(float x) {
  uint16_t v;
  asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;\n" : "=h"(v) : "f"(0.f),
      "f"(x));
  return e4m3_t{(uint8_t)(v & 0xFFu)};
}
