// Device functions shared by the texture-sampling kernels (aniso_slots.cu,
// tss_peel.cu, tss_shade.cu): arithmetic rounded as PyTorch's separate
// kernels round it, sampling.det_log2, the block atlas's bilinear and
// trilinear taps and the rgb9e5 decode of the light tables.
//
// Every multiply, add, subtract, divide and square root rounds on its own
// (__fmul_rn and its kin, which are never contracted into a fused
// multiply-add); min, max and clamp let a NaN through as PyTorch's do.
// Everything here sits in an unnamed namespace: each kernel's translation
// unit compiles its own copy.

#pragma once

#include <cuda_runtime.h>

namespace {

// sampling.py's constants as PyTorch rounds its Python floats to f32
#define F32(x) static_cast<float>(x)

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
// torch.maximum / torch.minimum: a NaN operand wins
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// Tensor.clamp_min / clamp with scalar bounds: NaN stays NaN
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float norm2(float x, float y) {
  return __fsqrt_rn(add(mul(x, x), mul(y, y)));
}

// sampling.det_log2: the exponent from the bits, log2 of the mantissa by
// the same Horner polynomial
__device__ __forceinline__ float det_log2(float x) {
  const int bits = __float_as_int(x);
  const int e = ((bits >> 23) & 0xFF) - 127;
  const float z =
      sub(__int_as_float((bits & 0x007FFFFF) | 0x3F800000), 1.0f);
  float acc = F32(-8.8746966506e-03);
  acc = add(mul(acc, z), F32(5.0277507368e-02));
  acc = add(mul(acc, z), F32(-1.3453425419e-01));
  acc = add(mul(acc, z), F32(2.3923166297e-01));
  acc = add(mul(acc, z), F32(-3.4599601243e-01));
  acc = add(mul(acc, z), F32(4.7832354487e-01));
  acc = add(mul(acc, z), F32(-7.2111461440e-01));
  acc = add(mul(acc, z), F32(1.4426867778e+00));
  acc = add(mul(acc, z), F32(4.8863580535e-08));
  return add(static_cast<float>(e), acc);
}

// The block atlas: [pages, ah, aw, WORDS] int32, a 2x2 texel block a row
// (u8, WORDS 4: word k = corner k; u16, WORDS 8: corner k = words 2k,
// 2k+1), and the mip placement tables.
struct Atlas {
  const int* atlas;
  long long n_blocks;  // pages * ah * aw
  int ah, aw;
  const int* mip_x;
  const int* mip_y;
};

// One texture slot's descriptor at one pixel (mip-0 placement).
struct Tex {
  int page, x, y, w, h, n_mips;
};

// sampling._bilinear_at_level + _bilerp_words: one block load at integer
// mip `level`, REPEAT wrap, scale-then-mix. A block index below 0 wraps,
// as PyTorch's indexing does (page -1 means no texture: the caller masks
// those pixels).
template <int WORDS>
__device__ __forceinline__ void bilinear(const Atlas& a, const Tex& t,
                                         float u, float v, int level,
                                         float r[4]) {
  const int sw = max(t.w >> level, 1);
  const int sh = max(t.h >> level, 1);
  const int bx = __ldg(a.mip_x + level) + (t.x >> level);
  const int by = __ldg(a.mip_y + level) + (t.y >> level);
  const float st_x = sub(mul(u, static_cast<float>(sw)), 0.5f);
  const float st_y = sub(mul(v, static_cast<float>(sh)), 0.5f);
  const int ix0 = static_cast<int>(floorf(st_x));
  const int iy0 = static_cast<int>(floorf(st_y));
  const float fx = sub(st_x, static_cast<float>(ix0));
  const float fy = sub(st_y, static_cast<float>(iy0));
  const int x0 = bx + (ix0 & (sw - 1));
  const int y0 = by + (iy0 & (sh - 1));
  long long flat = (static_cast<long long>(t.page) * a.ah + y0) * a.aw + x0;
  if (flat < 0) flat += a.n_blocks;
  const int4* blk = reinterpret_cast<const int4*>(a.atlas) + flat * (WORDS / 4);
  int wd[WORDS];
#pragma unroll
  for (int q = 0; q < WORDS / 4; ++q) {
    const int4 b = __ldg(blk + q);
    wd[4 * q] = b.x;
    wd[4 * q + 1] = b.y;
    wd[4 * q + 2] = b.z;
    wd[4 * q + 3] = b.w;
  }
  const float ofx = sub(1.0f, fx);
  const float ofy = sub(1.0f, fy);
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    float c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (WORDS == 4) {
        c[k] = mul(static_cast<float>((wd[k] >> (8 * ch)) & 255),
                   F32(1.0 / 255.0));
      } else {
        c[k] = mul(static_cast<float>(
                       (wd[2 * k + (ch >> 1)] >> (16 * (ch & 1))) & 0xFFFF),
                   F32(1.0 / 65535.0));
      }
    }
    const float top = add(mul(c[0], ofx), mul(c[1], fx));
    const float bot = add(mul(c[2], ofx), mul(c[3], fx));
    r[ch] = add(mul(top, ofy), mul(bot, fy));
  }
}

// sampling._bilinear_at_level_lod without dither: both mip levels' taps
// mixed by the lod fraction.
template <int WORDS>
__device__ __forceinline__ void trilinear(const Atlas& a, const Tex& t,
                                          float u, float v, float lod,
                                          float r[4]) {
  const float lodc =
      tmin(clamp_lo(lod, 0.0f), static_cast<float>(t.n_mips - 1));
  const int l0 = static_cast<int>(floorf(add(lodc, F32(1e-4))));
  const int l1 = min(l0 + 1, t.n_mips - 1);
  const float f = clamp_lo(sub(lodc, static_cast<float>(l0)), 0.0f);
  float t0[4], t1[4];
  bilinear<WORDS>(a, t, u, v, l0, t0);
  bilinear<WORDS>(a, t, u, v, l1, t1);
  const float of = sub(1.0f, f);
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) r[ch] = add(mul(of, t0[ch]), mul(f, t1[ch]));
}

// lightchart.rgb9e5_decode_planes, one channel (shift 0, 9 or 18): exact,
// a 9-bit integer times a power of two (lightchart._E_BIAS = 24)
__device__ __forceinline__ float rgb9e5(int word, int shift) {
  const float scale = __int_as_float((127 - 24 + ((word >> 27) & 31)) << 23);
  return mul(static_cast<float>((word >> shift) & 511), scale);
}

}  // namespace
