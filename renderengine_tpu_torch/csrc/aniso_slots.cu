// The tiered anisotropic texture sampler for Hopper: every used material
// slot of one shade call in one launch (aniso_slots_kernel). It computes,
// bit for bit, renderengine_tpu_torch/shading/sampling.py::
// sample_slots_aniso_tiered_plain:
//
//   per pixel and slot: the isotropic trilinear tap at lod 0.5*log2(rho2)
//     (rho2 the slot's squared texel-space footprint, major axis);
//   the shared footprint: tap count n = ceil(pmax / pmin - eps) in [1,
//     max_taps] and the major-axis uv step, from the uv derivatives;
//   tier t of the ladder takes the pixels with prev_t < n <= taps_t (the
//     last tier every n above prev_t); where the pixel's [1, seg_w] row
//     segment is among the tier's selected segments (selected in PyTorch,
//     sampling.select_row_segments, per row) and the slot's tap count
//     taps_s = min(taps_t, cap) exceeds 1, the slot's result is the exact
//     average of n_c = clamp(n, 1, taps_s) trilinear taps at
//     uv + major * ((i + 0.5) / n_c - 0.5), lod 0.5*log2(rho2 / n_c^2).
//
// It replaces no Pallas kernel: the JAX package leaves this sampler to
// XLA's fusion. In plain PyTorch every step of every tap is a kernel of
// its own (about 150 launches a bilinear tap, ~17k a call at the default
// 16x ladder), each round-tripping its [H, W] intermediates through
// device memory, and the tiers gather and scatter row segments.
//
// What bounds it: gathered bytes. A bilinear tap reads one 2x2 texel
// block (16 B for a u8 atlas, 32 B for u16); the per-pixel planes are
// read once and each slot's rgba is written once. The design keeps every
// tap in registers: one thread per (pixel, slot) computes the footprint,
// its tier, each tap's mip levels, REPEAT wrap, block load, unpack and
// mix, and sums the taps before its one 16-byte store; no intermediate
// reaches device memory, and pixels outside a selected segment read the
// selection (a few int64 per row) and nothing else of the tiers. A
// block's slot is the fastest-moving part of the block index, so the
// blocks of one run of pixels run side by side and read its planes from
// L2.
//
// Rounding: every multiply, add, divide and square root rounds on its own
// (__fmul_rn and its kin, built with -fmad=false), as the chain of
// separate PyTorch kernels does; min, max and clamp let a NaN through as
// PyTorch's do; `(i + 0.5) / n` is PyTorch's reciprocal, then multiply
// (Tensor.__rtruediv__). An atlas block index below 0 wraps, as PyTorch's
// indexing does (page -1 means no texture: the caller masks those
// pixels). The plain loop's taps i >= n_c add 0 * tap to a non-negative
// sum that starts at +0; skipping them changes no bit.
//
// Layouts: atlas [pages, ah, aw, WORDS] int32 (a 2x2 block a row: u8,
// WORDS 4, word k = corner k; u16, WORDS 8, corner k = words 2k, 2k+1);
// uv, d(uv)/dx, d(uv)/dy [H, W, 2] f32; slot planes page, x, y, w, h,
// n_mips [H, W] int32; selections [H, >= k] int64 with a row stride;
// out [n_slots, H, W, 4] f32.

#include <cuda_runtime.h>

#include "sampler.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSlots = 4;
constexpr int kMaxTiers = 8;
constexpr int kTierInts = 3 + kMaxSlots;  // sel stride, k, taps, taps_s[]

struct Slot {
  const int* page;
  const int* x;
  const int* y;
  const int* w;
  const int* h;
  const int* n_mips;
};

struct Args {
  Atlas tex;
  const float* uv;
  const float* ddx;
  const float* ddy;
  Slot slots[kMaxSlots];
  const long long* sel[kMaxTiers];
  int sel_stride[kMaxTiers];
  int k[kMaxTiers];
  int taps[kMaxTiers];
  int taps_s[kMaxTiers][kMaxSlots];
  float* out;
  int h, w, n_slots, n_tiers, seg_w, max_taps;
};

// The arguments stay in the kernel's parameter space (__grid_constant__):
// the tier loop indexes them by a run-time tier, which would otherwise
// copy them to local memory.
template <int WORDS>
__global__ void __launch_bounds__(kThreads)
    aniso_slots_kernel(const __grid_constant__ Args a) {
  const int s = blockIdx.x % a.n_slots;
  const long long p =
      static_cast<long long>(blockIdx.x / a.n_slots) * kThreads + threadIdx.x;
  const long long n_pix = static_cast<long long>(a.h) * a.w;
  if (p >= n_pix) return;
  const int py = static_cast<int>(p / a.w);
  const int px = static_cast<int>(p - static_cast<long long>(py) * a.w);
  const float2 uv = __ldg(reinterpret_cast<const float2*>(a.uv) + p);
  const float2 dx = __ldg(reinterpret_cast<const float2*>(a.ddx) + p);
  const float2 dy = __ldg(reinterpret_cast<const float2*>(a.ddy) + p);
  const Slot& sp = a.slots[s];
  const Tex t{__ldg(sp.page + p), __ldg(sp.x + p), __ldg(sp.y + p),
              __ldg(sp.w + p),    __ldg(sp.h + p), __ldg(sp.n_mips + p)};

  // sampling._slot_rho2
  const float tw = static_cast<float>(t.w);
  const float th = static_cast<float>(t.h);
  const float sx0 = mul(dx.x, tw), sx1 = mul(dx.y, th);
  const float sy0 = mul(dy.x, tw), sy1 = mul(dy.y, th);
  const float rho2 = clamp_lo(tmax(add(mul(sx0, sx0), mul(sx1, sx1)),
                                   add(mul(sy0, sy0), mul(sy1, sy1))),
                              F32(1e-40));

  float r[4];
  trilinear<WORDS>(a.tex, t, uv.x, uv.y, mul(0.5f, det_log2(rho2)), r);

  // sampling._uv_footprint
  const float pxl = norm2(dx.x, dx.y);
  const float pyl = norm2(dy.x, dy.y);
  const float pmax = tmax(pxl, pyl);
  const float pmin = clamp_lo(tmin(pxl, pyl), F32(1e-20));
  const float n = clamp(ceilf(sub(__fdiv_rn(pmax, pmin), F32(1e-4))), 1.0f,
                        static_cast<float>(a.max_taps));
  const float2 major = pxl >= pyl ? dx : dy;

  const int seg = px / a.seg_w;
  float prev = 1.0f;
  for (int ti = 0; ti < a.n_tiers; ++ti) {
    const int taps = a.taps[ti];
    const bool member =
        n > prev && (taps < a.max_taps ? n <= static_cast<float>(taps) : true);
    prev = static_cast<float>(taps);
    const int taps_s = a.taps_s[ti][s];
    if (!member || taps_s <= 1) continue;
    const long long* row = a.sel[ti] + static_cast<long long>(py) *
                                           a.sel_stride[ti];
    bool hit = false;
    for (int j = 0; j < a.k[ti]; ++j) hit |= __ldg(row + j) == seg;
    if (!hit) continue;
    const float n_c = clamp(n, 1.0f, static_cast<float>(taps_s));
    const float lod_c = mul(0.5f, det_log2(__fdiv_rn(rho2, mul(n_c, n_c))));
    const float rn = __frcp_rn(n_c);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const int nt = static_cast<int>(n_c);
    for (int i = 0; i < nt; ++i) {
      const float tt = sub(mul(rn, static_cast<float>(i) + 0.5f), 0.5f);
      float tap[4];
      trilinear<WORDS>(a.tex, t, add(uv.x, mul(major.x, tt)),
                       add(uv.y, mul(major.y, tt)), lod_c, tap);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) acc[ch] = add(acc[ch], tap[ch]);
    }
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) r[ch] = __fdiv_rn(acc[ch], n_c);
  }
  reinterpret_cast<float4*>(a.out)[static_cast<long long>(s) * n_pix + p] =
      make_float4(r[0], r[1], r[2], r[3]);
}

}  // namespace

// aniso_slots_kernel on `stream`. planes: n_slots * 6 device pointers
// (page, x, y, w, h, n_mips of each slot) in a host array; sels: n_tiers
// device pointers to int64 selections; tiers: n_tiers rows of kTierInts
// ints (the selection's row stride, its k, the tier's taps, then the
// taps_s of each of kMaxSlots slots), host memory. At most kMaxSlots
// slots and kMaxTiers tiers (sampling.py's ANISO_MAX_SLOTS and
// ANISO_MAX_TIERS). Returns the CUDA error code (0 = launched), -1 for an
// unsupported shape.
extern "C" int aniso_slots_launch(const int* atlas, long long n_blocks, int ah,
                                  int aw, int words, const int* mip_x,
                                  const int* mip_y, const float* uv,
                                  const float* ddx, const float* ddy,
                                  const void* const* planes, int n_slots,
                                  int h, int w, const void* const* sels,
                                  const int* tiers, int n_tiers, int seg_w,
                                  int max_taps, float* out, void* stream) {
  if (n_slots < 1 || n_slots > kMaxSlots || n_tiers < 1 ||
      n_tiers > kMaxTiers || seg_w < 1 || (words != 4 && words != 8))
    return -1;
  const long long n_pix = static_cast<long long>(h) * w;
  if (n_pix <= 0) return 0;
  Args a{};
  a.tex = Atlas{atlas, n_blocks, ah, aw, mip_x, mip_y};
  a.uv = uv;
  a.ddx = ddx;
  a.ddy = ddy;
  for (int s = 0; s < n_slots; ++s) {
    const int* const* pl = reinterpret_cast<const int* const*>(planes) + 6 * s;
    a.slots[s] = Slot{pl[0], pl[1], pl[2], pl[3], pl[4], pl[5]};
  }
  for (int t = 0; t < n_tiers; ++t) {
    const int* row = tiers + kTierInts * t;
    a.sel[t] = static_cast<const long long*>(sels[t]);
    a.sel_stride[t] = row[0];
    a.k[t] = row[1];
    a.taps[t] = row[2];
    for (int s = 0; s < kMaxSlots; ++s) a.taps_s[t][s] = row[3 + s];
  }
  a.out = out;
  a.h = h;
  a.w = w;
  a.n_slots = n_slots;
  a.n_tiers = n_tiers;
  a.seg_w = seg_w;
  a.max_taps = max_taps;
  const long long blocks = (n_pix + kThreads - 1) / kThreads * n_slots;
  if (blocks > 0x7FFFFFFFLL) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (words == 4) {
    aniso_slots_kernel<4><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(a);
  } else {
    aniso_slots_kernel<8><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
