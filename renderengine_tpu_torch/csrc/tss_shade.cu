// The opaque screen pass of the factored texture-space frame for Hopper:
// the half-res light sample, the guided upsample and the albedo tap of
// every pixel in one launch (tss_shade_kernel). It computes, bit for bit,
// renderengine_tpu_torch/shading/lightchart.py::tss_shade_halfres_plain
// on a CUDA device:
//
//   sample_light_halfres: at every site of the half grid (the pixels of
//     the GLOBAL even rows and the even columns; rows of a band starting
//     on an odd global row shift by one) _cell of the site's chart uv, one
//     32-byte row of the merged light table, eight rgb9e5 decodes and the
//     bilinear mix of both tables (diffuse ld, specular ls);
//   _guided_upsample: at every pixel the four half-grid corners (edge
//     clamped; row 0 of an odd-started band takes half rows 0 and 1),
//     each corner kept where its chart uv lies within sim_radius texels
//     (L1) of the pixel's own, the bilinear weights renormalised, and where
//     every corner is rejected the corner nearest in chart uv, first in
//     corner order;
//   _albedo_tap: the material's base-colour factor alpha and slot-0
//     descriptor (mat_all columns 3, 16-21); the uv's quad derivatives
//     with the coverage-aware pair rule (sampling.quad_derivs); the
//     anisotropic footprint, and with dither one tap at its Bayer slot and
//     the dithered mip level, else the exact taps of trilinear filtering
//     (max_taps 1: the isotropic trilinear or dithered tap); the sRGB
//     decode of the tap's rgb; 1 where the slot has no texture;
//   rgb = albedo * ld + ls, alpha = texture alpha * factor alpha.
//
// It replaces no Pallas kernel: the JAX package leaves this pass to XLA's
// fusion. In plain PyTorch every step is a kernel of its own (~700 a call
// at the headline's settings), each writing its [H, W] or half-grid
// planes to device memory and reading them back.
//
// What bounds it: bytes. Per pixel its chart uv, uv, material id and
// coverage (read once), the texture tap's 16-byte block (32 for a u16
// atlas; more taps without dither), a quarter of a 32-byte light row (one
// per half site) and the 16-byte rgba written once; the material rows stay
// in cache. The design keeps every intermediate out of device memory: one
// block per 32 x 8 pixel tile samples the light at the tile's half sites
// (plus a one-site halo) into shared memory, with their chart uvs, and
// stages the tile's uvs and coverage there for the quad derivatives; each
// thread then upsamples its pixel, takes its tap and stores its rgba.
//
// Rounding: every multiply, add, subtract, divide and square root rounds
// on its own (sampler.cuh), in the plain version's order; `1.0 / x` is
// PyTorch's reciprocal then multiply (Tensor.__rtruediv__), `x / s` for a
// Python scalar s its CUDA multiply by float(1 / s), and the sRGB
// decode's pow is the powf that PyTorch's CUDA pow calls for a float
// exponent. The chart uv clamp bounds are the float32 roundings of
// PyTorch's scalars (`aw - 1.001`, `ah - 1.001`); a NaN chart uv clamps
// to 0 here, where the plain version's index would fault. A material id
// below 0 wraps, as PyTorch's indexing does. The dither pattern and the
// quad pairs follow the plane's own rows and columns, as the plain
// version's do.
//
// Layouts: chart uv and uv [H, W, 2] f32 and material ids [H, W] int32,
// coverage [H, W] bool (or none: raw quad derivatives), each with its own
// element strides (the raster's attribute planes are read in place); the
// merged light table [ah * aw, 8] int32 (rgb9e5 words: 4 diffuse, 4
// specular corners of a texel's 2x2 block); mat_all [n_mat, cols] f16;
// the atlas as sampler.cuh's Atlas; out [H, W, 4] f32.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "sampler.cuh"

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
// half-grid sites a tile reads: its half columns and rows, the +x / +y
// halo, and one row more where an odd-started band shifts the rows
constexpr int kHalfW = kTileW / 2 + 1;
constexpr int kHalfH = kTileH / 2 + 2;
constexpr int kSites = kHalfW * kHalfH;
constexpr int kSiteCh = 8;  // ld rgb, ls rgb, the site's chart u, v
// lightchart._guided_upsample's sim_radius, as sample_light_halfres passes it
constexpr float kSimRadius = 3.0f;

// An [H, W] or [H, W, C] view: element strides.
template <typename T>
struct Plane {
  const T* p;
  long long sy, sx, sc;
  __device__ __forceinline__ T at(int y, int x, int c = 0) const {
    return __ldg(p + y * sy + x * sx + c * sc);
  }
};

struct Args {
  Atlas tex;
  const int4* light8;  // two int4 a texel
  int caw;
  float cx_max, cy_max;
  Plane<float> chart, uv;
  Plane<int> mat;
  Plane<unsigned char> cov;  // p null: no coverage rule
  const unsigned short* mat_all;  // f16 bits
  int mat_cols;
  long long n_mat;
  int h, w, r0, hh, wh;  // hh x wh: the half grid
  int slot0, max_taps, dither;
  float4* out;
};

__device__ __forceinline__ float half_at(const Args& a, long long m, int c) {
  return __half2float(__ushort_as_half(__ldg(a.mat_all + m * a.mat_cols + c)));
}

// sampling._bayer4
__device__ __forceinline__ float bayer4(int ix, int iy) {
  const int x = ix & 3, y = iy & 3, xy = x ^ y;
  return static_cast<float>(((xy & 1) << 3) | ((y & 1) << 2) | (xy & 2) |
                            (y >> 1));
}

// sampling._dither_level at plane pixel (px, py)
__device__ __forceinline__ int dither_level(float lod, int n_mips, int px,
                                            int py) {
  const float thr = mul(add(bayer4(px, py), 0.5f), 0.0625f);
  const float lodc =
      tmin(clamp_lo(lod, 0.0f), static_cast<float>(n_mips - 1));
  const int l0 = static_cast<int>(floorf(add(lodc, F32(1e-4))));
  const float f = clamp_lo(sub(lodc, static_cast<float>(l0)), 0.0f);
  return min(l0 + (sub(f, F32(1e-4)) > thr ? 1 : 0), n_mips - 1);
}

// pbr._sample_slot's tap of a valid slot: sample_texture_aniso
// (max_taps > 1) or the isotropic trilinear / dithered tap
template <int WORDS>
__device__ __forceinline__ void slot_tap(const Args& a, const Tex& t,
                                         float2 uv, float2 dx, float2 dy,
                                         int px, int py, float r[4]) {
  const float tw = static_cast<float>(t.w);
  const float th = static_cast<float>(t.h);
  if (a.max_taps > 1) {
    // sampling._aniso_footprint
    const float lx = norm2(mul(dx.x, tw), mul(dx.y, th));
    const float ly = norm2(mul(dy.x, tw), mul(dy.y, th));
    const float pmax = tmax(lx, ly);
    const float pmin = clamp_lo(tmin(lx, ly), F32(1e-20));
    const float n = clamp(ceilf(sub(__fdiv_rn(pmax, pmin), F32(1e-4))), 1.0f,
                          static_cast<float>(a.max_taps));
    const float lod = det_log2(clamp_lo(__fdiv_rn(pmax, n), F32(1e-20)));
    const float2 major = lx >= ly ? dx : dy;
    if (a.dither) {
      // one tap at slot floor(phase * n) of the ladder, transposed phase
      const float phase = mul(add(bayer4(py, px), 0.5f), 0.0625f);
      const float j = floorf(mul(phase, n));
      const float tt = sub(__fdiv_rn(add(j, 0.5f), n), 0.5f);
      bilinear<WORDS>(a.tex, t, add(uv.x, mul(major.x, tt)),
                      add(uv.y, mul(major.y, tt)),
                      dither_level(lod, t.n_mips, px, py), r);
      return;
    }
    // the exact taps; the plain loop's taps i >= n add 0 * tap (+0) to a
    // non-negative sum that starts at +0
    const float rn = __frcp_rn(n);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const int nt = static_cast<int>(n);
    for (int i = 0; i < nt; ++i) {
      const float tt = sub(mul(rn, static_cast<float>(i) + 0.5f), 0.5f);
      float tap[4];
      trilinear<WORDS>(a.tex, t, add(uv.x, mul(major.x, tt)),
                       add(uv.y, mul(major.y, tt)), lod, tap);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) acc[ch] = add(acc[ch], tap[ch]);
    }
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) r[ch] = __fdiv_rn(acc[ch], n);
    return;
  }
  const float sx0 = mul(dx.x, tw), sx1 = mul(dx.y, th);
  const float sy0 = mul(dy.x, tw), sy1 = mul(dy.y, th);
  const float rho2 = tmax(add(mul(sx0, sx0), mul(sx1, sx1)),
                          add(mul(sy0, sy0), mul(sy1, sy1)));
  const float lod = mul(0.5f, det_log2(clamp_lo(rho2, F32(1e-40))));
  if (a.dither) {
    bilinear<WORDS>(a.tex, t, uv.x, uv.y, dither_level(lod, t.n_mips, px, py),
                    r);
  } else {
    trilinear<WORDS>(a.tex, t, uv.x, uv.y, lod, r);
  }
}

// srgb.srgb_to_linear: c / 12.92 and (c + 0.055) / 1.055 as PyTorch's CUDA
// multiplies by the scalar's reciprocal (taken in double, then rounded to
// float: for 1.055 that is not the float reciprocal of 1.055f), then its
// powf
__device__ __forceinline__ float srgb_to_linear(float c) {
  constexpr float kInv1292 = static_cast<float>(1.0 / 12.92);
  constexpr float kInv1055 = static_cast<float>(1.0 / 1.055);
  const float lo = mul(c, kInv1292);
  const float hi = powf(mul(add(c, 0.055f), kInv1055), 2.4f);
  return c <= 0.04045f ? lo : hi;
}

template <int WORDS>
__global__ void __launch_bounds__(kThreads)
    tss_shade_kernel(const __grid_constant__ Args a) {
  __shared__ float site[kSiteCh][kSites];
  __shared__ float2 s_uv[kTileH][kTileW];
  __shared__ unsigned char s_cov[kTileH][kTileW];
  const int tx = threadIdx.x % kTileW, ty = threadIdx.x / kTileW;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int x = x0 + tx, y = y0 + ty;
  // the tile's first half row and column; stored row i holds half row
  // min(a_lo + i, hh - 1), so the +y corner of half row r is stored row
  // r - a_lo + 1 (likewise the columns)
  const int a_lo = max(y0 - a.r0, 0) >> 1;
  const int c_lo = x0 >> 1;

  // lightchart._half_cell + _blend_words at the tile's half sites
  for (int s = threadIdx.x; s < kSites; s += kThreads) {
    const int i = min(a_lo + s / kHalfW, a.hh - 1);
    const int j = min(c_lo + s % kHalfW, a.wh - 1);
    const int sy = a.r0 + 2 * i, sx = 2 * j;
    const float cu = a.chart.at(sy, sx, 0), cv = a.chart.at(sy, sx, 1);
    const float xc = fminf(fmaxf(cu, 0.0f), a.cx_max);
    const float yc = fminf(fmaxf(cv, 0.0f), a.cy_max);
    const long long ix = static_cast<long long>(floorf(xc));
    const long long iy = static_cast<long long>(floorf(yc));
    const float fx = sub(xc, static_cast<float>(ix));
    const float fy = sub(yc, static_cast<float>(iy));
    const float gx = sub(1.0f, fx), gy = sub(1.0f, fy);
    const float ws[4] = {mul(gx, gy), mul(fx, gy), mul(gx, fy), mul(fx, fy)};
    const long long flat = iy * a.caw + ix;
    const int4 lo = __ldg(a.light8 + 2 * flat);
    const int4 hi = __ldg(a.light8 + 2 * flat + 1);
    const int wd[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int tab = 0; tab < 2; ++tab) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float acc = mul(rgb9e5(wd[4 * tab], 9 * ch), ws[0]);
#pragma unroll
        for (int k = 1; k < 4; ++k)
          acc = add(acc, mul(rgb9e5(wd[4 * tab + k], 9 * ch), ws[k]));
        site[3 * tab + ch][s] = acc;
      }
    }
    site[6][s] = cu;
    site[7][s] = cv;
  }

  const bool inside = x < a.w && y < a.h;
  float2 uv = make_float2(0.0f, 0.0f);
  bool cov = false;
  if (inside) {
    uv = make_float2(a.uv.at(y, x, 0), a.uv.at(y, x, 1));
    cov = a.cov.p != nullptr && a.cov.at(y, x) != 0;
  }
  s_uv[ty][tx] = uv;
  s_cov[ty][tx] = cov;
  __syncthreads();
  if (!inside) return;

  // _guided_upsample
  const float cux = a.chart.at(y, x, 0), cuy = a.chart.at(y, x, 1);
  const int ra = (max(y - a.r0, 0) >> 1) - a_lo;
  const int ca = (x >> 1) - c_lo;
  const int corner[4] = {ra * kHalfW + ca, ra * kHalfW + ca + 1,
                         (ra + 1) * kHalfW + ca, (ra + 1) * kHalfW + ca + 1};
  const float fy = ((y - a.r0) & 1) ? 0.5f : 0.0f;
  const float fx = (x & 1) ? 0.5f : 0.0f;
  const float gy = sub(1.0f, fy), gx = sub(1.0f, fx);
  const float base[4] = {mul(gy, gx), mul(gy, fx), mul(fy, gx), mul(fy, fx)};
  float d[4], wt[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    d[k] = add(fabsf(sub(site[6][corner[k]], cux)),
               fabsf(sub(site[7][corner[k]], cuy)));
    wt[k] = mul(base[k], d[k] < kSimRadius ? 1.0f : 0.0f);
  }
  const float tot = add(add(add(wt[0], wt[1]), wt[2]), wt[3]);
  const float inv_tot = __frcp_rn(fmaxf(tot, F32(1e-6)));
  const bool degenerate = tot <= F32(1e-6);
  const float bd = tmin(tmin(d[0], d[1]), tmin(d[2], d[3]));
  float pick[4];
  bool taken = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool s = d[k] == bd && !taken;
    pick[k] = s ? 1.0f : 0.0f;
    taken = taken || s;
  }
  float light[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const float* p = site[c];
    const float acc = mul(add(add(add(mul(p[corner[0]], wt[0]),
                                      mul(p[corner[1]], wt[1])),
                                  mul(p[corner[2]], wt[2])),
                              mul(p[corner[3]], wt[3])),
                          inv_tot);
    const float best = add(add(add(mul(p[corner[0]], pick[0]),
                                   mul(p[corner[1]], pick[1])),
                               mul(p[corner[2]], pick[2])),
                           mul(p[corner[3]], pick[3]));
    light[c] = degenerate ? best : acc;
  }

  // _albedo_tap
  long long m = a.mat.at(y, x);
  if (m < 0) m += a.n_mat;
  const float factor_a = half_at(a, m, 3);
  float alb[3] = {1.0f, 1.0f, 1.0f};
  float ta = 1.0f;
  if (a.slot0) {
    const float page = half_at(a, m, 16);
    if (page >= 0.0f) {
      const Tex t{static_cast<int>(page),
                  static_cast<int>(half_at(a, m, 17)),
                  static_cast<int>(half_at(a, m, 18)),
                  static_cast<int>(half_at(a, m, 19)),
                  static_cast<int>(half_at(a, m, 20)),
                  static_cast<int>(half_at(a, m, 21))};
      // sampling.quad_derivs: the quad's pairs (x | 1, x & ~1), the odd
      // extents' missing partner replicated by the edge
      const int lx = tx & ~1, hx = min(x | 1, a.w - 1) - x0;
      const int ly = ty & ~1, hy = min(y | 1, a.h - 1) - y0;
      float2 dx = make_float2(sub(s_uv[ty][hx].x, s_uv[ty][lx].x),
                              sub(s_uv[ty][hx].y, s_uv[ty][lx].y));
      float2 dy = make_float2(sub(s_uv[hy][tx].x, s_uv[ly][tx].x),
                              sub(s_uv[hy][tx].y, s_uv[ly][tx].y));
      if (a.cov.p != nullptr) {
        const bool vx = cov && s_cov[ty][min(x ^ 1, a.w - 1) - x0];
        const bool vy = cov && s_cov[min(y ^ 1, a.h - 1) - y0][tx];
        const float2 zero = make_float2(0.0f, 0.0f);
        const float2 mx = vx ? dx : (vy ? dy : zero);
        const float2 my = vy ? dy : (vx ? dx : zero);
        dx = mx;
        dy = my;
      }
      float tap[4];
      slot_tap<WORDS>(a, t, uv, dx, dy, x, y, tap);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) alb[ch] = srgb_to_linear(tap[ch]);
      ta = tap[3];
    }
  }
  a.out[static_cast<long long>(y) * a.w + x] =
      make_float4(add(mul(alb[0], light[0]), light[3]),
                  add(mul(alb[1], light[1]), light[4]),
                  add(mul(alb[2], light[2]), light[5]), mul(ta, factor_a));
}

}  // namespace

// One launch over the h x w plane on `stream`. Strides are in elements:
// chart uv and uv (row, column, channel), material ids and coverage (row,
// column); cov may be null. Returns 0 or a CUDA error code; -1 for
// arguments the kernel cannot take.
extern "C" int tss_shade_launch(
    const int* atlas, long long n_blocks, int ah, int aw, int words,
    const int* mip_x, const int* mip_y, const void* light8, int caw,
    float cx_max, float cy_max, const float* chart, long long c_sy,
    long long c_sx, long long c_sc, const float* uv, long long u_sy,
    long long u_sx, long long u_sc, const int* mat, long long m_sy,
    long long m_sx, const unsigned char* cov, long long v_sy, long long v_sx,
    const void* mat_all, int mat_cols, long long n_mat, int h, int w,
    int r0, int slot0, int max_taps, int dither, float* out, void* stream) {
  if (h < 2 || w < 2 || (r0 != 0 && r0 != 1) || (r0 == 1 && h % 2) ||
      caw < 2 || mat_cols < 22 || n_mat < 1 || max_taps < 1 ||
      (words != 4 && words != 8))
    return -1;
  Args a{};
  a.tex = Atlas{atlas, n_blocks, ah, aw, mip_x, mip_y};
  a.light8 = static_cast<const int4*>(light8);
  a.caw = caw;
  a.cx_max = cx_max;
  a.cy_max = cy_max;
  a.chart = Plane<float>{chart, c_sy, c_sx, c_sc};
  a.uv = Plane<float>{uv, u_sy, u_sx, u_sc};
  a.mat = Plane<int>{mat, m_sy, m_sx, 0};
  a.cov = Plane<unsigned char>{cov, v_sy, v_sx, 0};
  a.mat_all = static_cast<const unsigned short*>(mat_all);
  a.mat_cols = mat_cols;
  a.n_mat = n_mat;
  a.h = h;
  a.w = w;
  a.r0 = r0;
  a.hh = (h - r0 + 1) / 2;
  a.wh = (w + 1) / 2;
  a.slot0 = slot0;
  a.max_taps = max_taps;
  a.dither = dither;
  a.out = reinterpret_cast<float4*>(out);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  if (grid.y > 65535) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (words == 4) {
    tss_shade_kernel<4><<<grid, kThreads, 0, st>>>(a);
  } else {
    tss_shade_kernel<8><<<grid, kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
