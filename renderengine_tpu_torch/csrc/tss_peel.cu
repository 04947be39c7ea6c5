// The texture-space peel pass for Hopper: both pre-shaded translucent peel
// layers of a texture-space frame, shaded and composited into the frame's
// colour in one launch (tss_peel_kernel). It computes, bit for bit,
// renderengine_tpu_torch/shading/lightchart.py::tss_peel_composite_plain
// on a CUDA device:
//
//   for the farther layer, then the nearer one, at every pixel where the
//   layer's tri_id >= 0: lightchart.tss_shade_pre at its chart uv (_cell,
//   one 2x2 rgb9e5 block, four decodes, the bilinear mix; alpha from one
//   2x2 u8 alpha block, or the material's base-colour factor alpha when
//   the bake found alpha to be that factor), then
//     a = clamp(alpha, 0, 1);  rgb = rgb * (1 - a) + c * a
//   as graph/frame.py composites a peel back to front. A pixel a layer
//   does not cover takes a = 0 and c = 0 (rgb * 1 + 0: the plain
//   version's c * 0 is +0 there too, since every decoded colour is >= 0).
//
// It replaces no Pallas kernel: the JAX package shades each peel layer on
// a budgeted subset of screen tiles (graph/frame.py::shade_sparse) and
// leaves the arithmetic to XLA's fusion. In plain PyTorch every step is a
// kernel of its own, each round-tripping its [H, W] intermediates through
// device memory, and the tile selection, gather and scatter of the
// budgeted path come on top; a covered tile past the budget goes
// unshaded. Here every covered pixel is shaded, so there is no budget.
//
// What bounds it: bytes. Per pixel the two layers' tri ids and the colour
// (read and written once); per covered layer pixel its chart uv, the
// 16-byte rgb block and the 4-byte alpha block (or its material id and
// the factor). Nothing intermediate reaches device memory.
//
// Rounding: every multiply, add and subtract rounds on its own
// (__fmul_rn and its kin, built with -fmad=false), in the plain version's
// order. The alpha block's `/ 255.0` is PyTorch's CUDA division by a
// Python scalar: a multiply by the float reciprocal 1/255. The chart uv
// clamp bounds are the float32 roundings of PyTorch's scalars
// (`aw - 1.001`, `ah - 1.001`); a NaN chart uv clamps to 0 here, where
// the plain version's index would fault.
//
// Layouts: rgb [H, W, 3] f32 (in place); rgb blocks [ah * aw, 4] int32
// (rgb9e5 words of a texel's 2x2 clamp-to-edge block); alpha blocks
// [ah * aw] int32 (u8 a00 | a10 << 8 | a01 << 16 | a11 << 24); material
// table [n_mat, cols] f16 (column 3: the factor alpha); per layer tri id
// and material id [H, W] int32, chart uv [H, W, 2] f32.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "sampler.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLayers = 2;

struct Layer {
  const int* tri;
  const float* uv;
  const int* mat;
};

struct Args {
  float* rgb;
  const int4* rgb_blocks;
  const int* a_blocks;     // null: factor alpha from mat_all
  const __half* mat_all;
  int mat_cols;
  Layer layers[kLayers];
  long long n_pix;
  int aw;
  float x_max, y_max;
};

// (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (c01 * (1 - fx) + c11 * fx) * fy
__device__ __forceinline__ float bilerp(float c00, float c10, float c01,
                                        float c11, float fx, float fy,
                                        float gx, float gy) {
  const float top = add(mul(c00, gx), mul(c10, fx));
  const float bot = add(mul(c01, gx), mul(c11, fx));
  return add(mul(top, gy), mul(bot, fy));
}

// tss_shade_pre (+ the factor alpha) of one covered layer pixel
__device__ __forceinline__ void shade(const Args& a, const Layer& l,
                                      long long p, float c[3],
                                      float& alpha) {
  const float2 uv = __ldg(reinterpret_cast<const float2*>(l.uv) + p);
  const float x = fminf(fmaxf(uv.x, 0.0f), a.x_max);
  const float y = fminf(fmaxf(uv.y, 0.0f), a.y_max);
  const long long ix = static_cast<long long>(floorf(x));
  const long long iy = static_cast<long long>(floorf(y));
  const float fx = sub(x, static_cast<float>(ix));
  const float fy = sub(y, static_cast<float>(iy));
  const float gx = sub(1.0f, fx);
  const float gy = sub(1.0f, fy);
  const long long flat = iy * a.aw + ix;
  const int4 b = __ldg(a.rgb_blocks + flat);
  for (int ch = 0; ch < 3; ++ch) {
    const int s = 9 * ch;
    c[ch] = bilerp(rgb9e5(b.x, s), rgb9e5(b.y, s), rgb9e5(b.z, s),
                   rgb9e5(b.w, s), fx, fy, gx, gy);
  }
  if (a.a_blocks != nullptr) {
    const int ar = __ldg(a.a_blocks + flat);
    const float s = bilerp(static_cast<float>(ar & 255),
                           static_cast<float>((ar >> 8) & 255),
                           static_cast<float>((ar >> 16) & 255),
                           static_cast<float>((ar >> 24) & 255), fx, fy, gx,
                           gy);
    alpha = mul(s, 1.0f / 255.0f);
  } else {
    const long long m = __ldg(l.mat + p);
    alpha = __half2float(a.mat_all[m * a.mat_cols + 3]);
  }
}

__global__ void __launch_bounds__(kThreads) tss_peel_kernel(Args a) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (p >= a.n_pix) return;
  float* px = a.rgb + 3 * p;
  float r = px[0], g = px[1], bl = px[2];
  for (int li = kLayers - 1; li >= 0; --li) {
    const Layer& l = a.layers[li];
    float c[3] = {0.0f, 0.0f, 0.0f};
    float t = 0.0f;
    if (__ldg(l.tri + p) >= 0) {
      float alpha;
      shade(a, l, p, c, alpha);
      // Tensor.clamp(0, 1): NaN stays NaN
      t = alpha != alpha ? alpha : fminf(fmaxf(alpha, 0.0f), 1.0f);
    }
    const float keep = sub(1.0f, t);
    r = add(mul(r, keep), mul(c[0], t));
    g = add(mul(g, keep), mul(c[1], t));
    bl = add(mul(bl, keep), mul(c[2], t));
  }
  px[0] = r;
  px[1] = g;
  px[2] = bl;
}

}  // namespace

// One launch over the h x w pixels on `stream`. Returns 0 or a CUDA
// error code; -1 for arguments the kernel cannot take.
extern "C" int tss_peel_launch(float* rgb, const void* rgb_blocks,
                               const int* a_blocks, const void* mat_all,
                               int mat_cols, const int* tri0,
                               const float* uv0, const int* mat0,
                               const int* tri1, const float* uv1,
                               const int* mat1, int h, int w, int aw,
                               float x_max, float y_max, void* stream) {
  if (h < 0 || w < 0 || aw < 2 || (a_blocks == nullptr && mat_cols < 4))
    return -1;
  const long long n_pix = static_cast<long long>(h) * w;
  if (n_pix == 0) return 0;
  Args a{};
  a.rgb = rgb;
  a.rgb_blocks = static_cast<const int4*>(rgb_blocks);
  a.a_blocks = a_blocks;
  a.mat_all = static_cast<const __half*>(mat_all);
  a.mat_cols = mat_cols;
  a.layers[0] = Layer{tri0, uv0, mat0};
  a.layers[1] = Layer{tri1, uv1, mat1};
  a.n_pix = n_pix;
  a.aw = aw;
  a.x_max = x_max;
  a.y_max = y_max;
  const long long blocks = (n_pix + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return -1;
  tss_peel_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
