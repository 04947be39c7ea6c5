// Tile raster kernels for Hopper, K1 and K2: one thread block per
// 8x32-pixel tile, one thread per pixel. Both run the same per-pixel walk
// (walk() below), so they share one set of rounding rules.
//
// Replaces renderengine_tpu/raster/pallas_raster.py::_raster_kernel: single
// winner or the two nearest layers (dual), optional per-pixel peel bounds,
// dense or sparse tile grid, n_attrs 0, 4 (texture-space) and 8. For each
// tile the block walks the tile's binned (tile, triangle) pairs from the
// packed pair table,
// evaluates three edge planes plus the z and w numerator planes at every
// pixel centre, and keeps the nearest covered fragment:
//
//   cover = E_i + eps_i > 0 (i = 0..2) & w > 0 & 0 <= z <= w
//   depth = z / w                 (IEEE divide)
//   peel:   cover &= prev < depth <= zmax     (per-pixel bounds)
//   take  = cover & depth < d1    (d1 starts at the clear depth 1.0)
//   dual:   take2 = cover & depth > d1 & depth < d2
//           on take : layer 2 <- layer 1, layer 1 <- this fragment
//           on take2: layer 2 <- this fragment
//
// Pairs of a tile are stored in ascending triangle order, and the walk
// goes through them in that order with strict compares, so an exact depth
// tie goes to the lowest triangle id and a fragment equal in depth to
// layer 1 enters neither layer: what two successive single peels with
// depth > prev give, and the rule the TPU kernel gets from its 8-sublane
// folds, without the folds. A layer carries its triangle and material ids
// (integer-valued floats), its edge sum and either its two barycentric
// numerators (n_attrs = 0) or n_attrs rational attribute numerators; one
// reciprocal of the layer's own edge sum at tile end turns them into
// values (num * (1 / esum), reciprocal first, as the TPU kernel does). A
// layer with no winner reads depth 1.0, tri -1, everything else 0.
//
// Sparse grid: block s rasters tile tile_map[s] (the caller's choice of
// tiles, ascending), reads that tile's bounds and writes output slot s;
// the wrapper scatters slots into the full tile layout.
//
// Pair row layout (cpp floats per pair, cpp = 20 + 3 * n_attrs):
//   0..14 coef (e0 e1 e2 z w, each a*px + b*py + c) | 15..17 tie eps |
//   18 tri id | 19 material id | 20.. attribute planes (3 floats each)
// Bounds: [n_tiles, 2, 256] f32: prev | zmax, one value per pixel of the
// tile (the wrapper fills pixels outside the image so nothing passes).
// Output: [n_slots, (3 + n_num) * layers, 256] f32 planes, per layer:
// depth | tri | mat | nums.
//
// What bounds it on this card: bytes. Every pair costs each of the 256
// pixels 5 planes of 2 multiplies and 2 adds, 3 tie adds, a divide and 7
// compares (31 operations; 2 more compares in peel mode, 2 more in dual);
// the n_attrs attribute planes and the carried values are computed only
// when a fragment enters a layer. The pair row is read once per block and
// each output word written once. On an H100 (3.35 TB/s, 67 TFLOP/s FP32)
// the 1080p opaque Sponza pass (217k pairs over 8100 tiles, 11 output
// planes) moves 1.3e8 bytes, 0.039 ms, more than its ~1.8e9 operations
// cost at the FP32 peak; the 4096^2 depth-only shadow pass (466k pairs,
// 65536 tiles of 5 planes) moves 3.7e8 bytes, 0.11 ms; the dual peel of
// the translucent list (19k pairs, 2 bounds planes read and 22 planes
// written per tile) 2.0e8 bytes, 0.06 ms (chip_smoke.py prints these
// counts from its run for each launch shape). The design keeps the
// per-pixel loop free of memory traffic: a tile's rows are staged in
// shared memory in chunks and read by all 256 threads as broadcasts, and
// the carry stays in registers. What holds the opaque pass far above its
// bound is the serial walk: one block per tile lets the densest tile run
// alone at the end of the grid; chip_smoke.py times that tile by itself
// beside the whole opaque pass.
//
// Rounding: build without --use_fast_math (it flushes denormals and
// approximates the divide; the 1e-35 tie epsilon must survive) and with
// -fmad=false; the __fmul_rn/__fadd_rn intrinsics below also forbid
// contraction, so every plane rounds as (a*px + b*py) + c, matching the
// plain PyTorch version bit for bit.
//
// K2, the merged launch (merged_tile_kernel), replaces
// renderengine_tpu/raster/pallas_raster.py::_merged_kernel (launched by
// rasterize_pallas_merged): the texture-space opaque pass and its two
// nearest translucent layers in ONE tile walk over two pair tables, each of
// K1's row layout at n_attrs 4 (cpp = 32):
//
//   stream A (the opaque list): K1's single winner over the tile's span,
//     4 attributes;
//   stream B (the translucent list): K1's dual tracker with NO depth
//     bounds, interpolating only the first N_ATTRS_B (2 or 4) attributes;
//   the fold: each blend layer deeper than stream A's winning depth (1.0
//     where nothing opaque was drawn) is voided: depth 1, tri -1, material
//     and attributes 0, as an empty layer.
//
// The fold makes the result equal K1's opaque launch followed by K1's dual
// launch with peel bounds (-1, opaque depth): an occluded blend fragment is
// deeper than every visible one, so it can hold a tracker slot only while
// fewer than two visible fragments exist, and the cap then voids it. A tile
// without blend pairs writes the two empty layers without walking. Output:
// [n_tiles, (3 + 4) + 2 * (3 + N_ATTRS_B), 256] f32 planes: the opaque
// layer, then blend layers 1 and 2. Like K1 it is bound by bytes and held
// far above that bound by the serial walk of the densest tile. The TPU
// kernel's DMA rings, tiles-per-program and program-level skip of stream B
// are TPU tuning and are left out.

#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 32;
constexpr int kThreads = kTileH * kTileW;  // one thread per pixel
constexpr int kChunk = 64;                 // pairs staged per smem pass
constexpr int kMaxCols = 20 + 3 * 8;

__device__ __forceinline__ float plane(const float* r, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r[0], px), __fmul_rn(r[1], py)), r[2]);
}

// One depth layer of one pixel: the winner's depth, ids, edge sum and
// numerators.
template <int N_NUM>
struct Layer {
  float d = 1.0f, tri = -1.0f, mat = 0.0f, esum = 0.0f;
  float num[N_NUM];

  __device__ __forceinline__ Layer() {
#pragma unroll
    for (int i = 0; i < N_NUM; ++i) num[i] = 0.0f;
  }

  template <int N_ATTRS>
  __device__ __forceinline__ void set(const float* r, float px, float py,
                                      float depth, float e0, float e1,
                                      float e2) {
    d = depth;
    tri = r[18];
    mat = r[19];
    esum = __fadd_rn(__fadd_rn(e0, e1), e2);
    if (N_ATTRS == 0) {
      num[0] = e0;
      num[1] = e1;
    } else {
#pragma unroll
      for (int a = 0; a < N_NUM; ++a) num[a] = plane(r + 20 + 3 * a, px, py);
    }
  }

  // depth | tri | mat | num * (1 / esum), one plane of 256 floats each
  __device__ __forceinline__ void store(float* o) const {
    const float inv = __fdiv_rn(1.0f, esum == 0.0f ? 1.0f : esum);
    o[0] = d;
    o[kThreads] = tri;
    o[2 * kThreads] = mat;
#pragma unroll
    for (int a = 0; a < N_NUM; ++a)
      o[(3 + a) * kThreads] = __fmul_rn(num[a], inv);
  }
};

// Walk one tile's span [start, start + count) of a pair table whose rows
// carry N_ATTRS attribute planes; l1 (and with DUAL l2) take the winners.
// PEEL applies the per-pixel bounds prev < depth <= zmax. The layers
// interpolate their first N_NUM attributes (the two barycentric
// numerators at N_ATTRS 0).
template <int N_ATTRS, bool PEEL, bool DUAL, int N_NUM>
__device__ __forceinline__ void walk(const float* __restrict__ pairs,
                                     int start, int count, float px,
                                     float py, float prev, float zmax,
                                     float* rows, Layer<N_NUM>& l1,
                                     Layer<N_NUM>& l2) {
  constexpr int kCols = 20 + 3 * N_ATTRS;
  const int lane = threadIdx.x;
  for (int base = 0; base < count; base += kChunk) {
    const int n = min(kChunk, count - base);
    const float* src = pairs + (size_t)(start + base) * kCols;
    __syncthreads();  // the previous chunk is consumed
    for (int k = lane; k < n * kCols; k += kThreads) rows[k] = src[k];
    __syncthreads();
    for (int p = 0; p < n; ++p) {
      const float* r = rows + p * kCols;
      const float e0 = plane(r + 0, px, py);
      const float e1 = plane(r + 3, px, py);
      const float e2 = plane(r + 6, px, py);
      const float zn = plane(r + 9, px, py);
      const float wn = plane(r + 12, px, py);
      const float d = __fdiv_rn(zn, wn);
      bool cover = (__fadd_rn(e0, r[15]) > 0.0f) &&
                   (__fadd_rn(e1, r[16]) > 0.0f) &&
                   (__fadd_rn(e2, r[17]) > 0.0f) && (wn > 0.0f) &&
                   (zn >= 0.0f) && (zn <= wn);
      if (PEEL) cover = cover && (d > prev) && (d <= zmax);
      if (cover) {
        if (d < l1.d) {
          if (DUAL) l2 = l1;
          l1.template set<N_ATTRS>(r, px, py, d, e0, e1, e2);
        } else if (DUAL && d > l1.d && d < l2.d) {
          l2.template set<N_ATTRS>(r, px, py, d, e0, e1, e2);
        }
      }
    }
  }
}

// The pixel centre of this thread in the viewport's centred coordinates.
__device__ __forceinline__ void pixel(int tile, int ntx, int width,
                                      int full_height, int y0, float& px,
                                      float& py) {
  const int lane = threadIdx.x;
  const int org_x = (tile % ntx) * kTileW;
  const int org_y = (tile / ntx) * kTileH + y0;
  px = __fadd_rn((float)(org_x + lane % kTileW), 0.5f - (float)width * 0.5f);
  py = __fadd_rn((float)(org_y + lane / kTileW),
                 0.5f - (float)full_height * 0.5f);
}

template <int N_ATTRS, bool PEEL, bool DUAL>
__global__ void __launch_bounds__(kThreads)
raster_tile_kernel(const float* __restrict__ pairs,
                   const int* __restrict__ starts,
                   const int* __restrict__ counts,
                   const int* __restrict__ tile_map,
                   const float* __restrict__ bounds,
                   float* __restrict__ out, int ntx, int width,
                   int full_height, int y0) {
  constexpr int kNum = N_ATTRS > 0 ? N_ATTRS : 2;
  constexpr int kLayers = DUAL ? 2 : 1;
  __shared__ float rows[kChunk * kMaxCols];

  const int slot = blockIdx.x;
  const int tile = tile_map != nullptr ? tile_map[slot] : slot;
  const int lane = threadIdx.x;
  float px, py;
  pixel(tile, ntx, width, full_height, y0, px, py);
  float prev = 0.0f, zmax = 0.0f;
  if (PEEL) {
    const float* b = bounds + (size_t)tile * 2 * kThreads + lane;
    prev = b[0];
    zmax = b[kThreads];
  }

  Layer<kNum> l1, l2;
  walk<N_ATTRS, PEEL, DUAL>(pairs, starts[tile], counts[tile], px, py, prev,
                            zmax, rows, l1, l2);

  float* o = out + (size_t)slot * (3 + kNum) * kLayers * kThreads + lane;
  l1.store(o);
  if (DUAL) l2.store(o + (3 + kNum) * kThreads);
}

// K2: stream A's single winner, stream B's two nearest layers (the first
// N_ATTRS_B attributes), the fold under stream A's depth.
template <int N_ATTRS_B>
__global__ void __launch_bounds__(kThreads)
merged_tile_kernel(const float* __restrict__ pairs_a,
                   const int* __restrict__ starts_a,
                   const int* __restrict__ counts_a,
                   const float* __restrict__ pairs_b,
                   const int* __restrict__ starts_b,
                   const int* __restrict__ counts_b,
                   float* __restrict__ out, int ntx, int width,
                   int full_height, int y0) {
  constexpr int kAttrs = 4;  // attribute planes of both tables
  constexpr int kPlanesA = 3 + kAttrs;
  constexpr int kPlanesB = 3 + N_ATTRS_B;
  __shared__ float rows[kChunk * (20 + 3 * kAttrs)];

  const int tile = blockIdx.x;
  float px, py;
  pixel(tile, ntx, width, full_height, y0, px, py);
  float* o = out + (size_t)tile * (kPlanesA + 2 * kPlanesB) * kThreads +
             threadIdx.x;

  Layer<kAttrs> a1, a_unused;
  walk<kAttrs, false, false>(pairs_a, starts_a[tile], counts_a[tile], px, py,
                             0.0f, 0.0f, rows, a1, a_unused);
  a1.store(o);

  Layer<N_ATTRS_B> b1, b2;
  const int count_b = counts_b[tile];
  if (count_b > 0) {
    walk<kAttrs, false, true>(pairs_b, starts_b[tile], count_b, px, py, 0.0f,
                              0.0f, rows, b1, b2);
    if (b1.d > a1.d) b1 = Layer<N_ATTRS_B>();
    if (b2.d > a1.d) b2 = Layer<N_ATTRS_B>();
  }
  b1.store(o + kPlanesA * kThreads);
  b2.store(o + (kPlanesA + kPlanesB) * kThreads);
}

template <int N_ATTRS>
void launch(bool peel, bool dual, const float* pairs, const int* starts,
            const int* counts, const int* tile_map, const float* bounds,
            float* out, int n_slots, int ntx, int width, int full_height,
            int y0, cudaStream_t s) {
  if (dual) {
    raster_tile_kernel<N_ATTRS, true, true><<<n_slots, kThreads, 0, s>>>(
        pairs, starts, counts, tile_map, bounds, out, ntx, width, full_height,
        y0);
  } else if (peel) {
    raster_tile_kernel<N_ATTRS, true, false><<<n_slots, kThreads, 0, s>>>(
        pairs, starts, counts, tile_map, bounds, out, ntx, width, full_height,
        y0);
  } else {
    raster_tile_kernel<N_ATTRS, false, false><<<n_slots, kThreads, 0, s>>>(
        pairs, starts, counts, tile_map, bounds, out, ntx, width, full_height,
        y0);
  }
}

}  // namespace

// tile_map: null for the dense grid (slot s = tile s), else n_slots tile
// ids. bounds: null for no peel test; dual needs it. Returns the launch's
// CUDA error code (0 = launched), -1 for an unsupported mode.
extern "C" int raster_tile_launch(const float* pairs, const int* starts,
                                  const int* counts, const int* tile_map,
                                  const float* bounds, float* out,
                                  int n_slots, int ntx, int width,
                                  int full_height, int y0, int n_attrs,
                                  int dual, void* stream) {
  if (n_slots <= 0) return 0;
  if (dual && bounds == nullptr) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool peel = bounds != nullptr;
  if (n_attrs == 0) {
    launch<0>(peel, dual != 0, pairs, starts, counts, tile_map, bounds, out,
              n_slots, ntx, width, full_height, y0, s);
  } else if (n_attrs == 4) {
    launch<4>(peel, dual != 0, pairs, starts, counts, tile_map, bounds, out,
              n_slots, ntx, width, full_height, y0, s);
  } else if (n_attrs == 8) {
    launch<8>(peel, dual != 0, pairs, starts, counts, tile_map, bounds, out,
              n_slots, ntx, width, full_height, y0, s);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// K2 over the dense tile grid (n_tiles blocks, tile s = block s) of both
// tables. Returns the launch's CUDA error code (0 = launched), -1 for an
// unsupported n_attrs_b.
extern "C" int merged_tile_launch(const float* pairs_a, const int* starts_a,
                                  const int* counts_a, const float* pairs_b,
                                  const int* starts_b, const int* counts_b,
                                  float* out, int n_tiles, int ntx, int width,
                                  int full_height, int y0, int n_attrs_b,
                                  void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_attrs_b == 2) {
    merged_tile_kernel<2><<<n_tiles, kThreads, 0, s>>>(
        pairs_a, starts_a, counts_a, pairs_b, starts_b, counts_b, out, ntx,
        width, full_height, y0);
  } else if (n_attrs_b == 4) {
    merged_tile_kernel<4><<<n_tiles, kThreads, 0, s>>>(
        pairs_a, starts_a, counts_a, pairs_b, starts_b, counts_b, out, ntx,
        width, full_height, y0);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
