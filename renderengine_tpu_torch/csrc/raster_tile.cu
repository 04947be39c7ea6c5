// Tile raster kernels for Hopper, K1 and K2. Both walk binned (tile,
// triangle) pairs for 8x32-pixel tiles, one thread per pixel, through the
// same device functions (walk_rows, resolve below), so they share one set
// of rounding rules.
//
// K1 (raster_tile_kernel) replaces
// renderengine_tpu/raster/pallas_raster.py::_raster_kernel: single winner
// or the two nearest layers (dual), optional per-pixel peel bounds, dense
// or sparse tile grid, n_attrs 0, 4 (texture-space) and 8. For each pair of
// a tile it evaluates three edge planes plus the z and w numerator planes
// at every pixel centre and keeps the nearest covered fragment:
//
//   cover = E_i + eps_i > 0 (i = 0..2) & w > 0 & 0 <= z <= w
//   depth = z / w                 (IEEE divide)
//   peel:   cover &= prev < depth <= zmax     (per-pixel bounds)
//   take  = cover & depth < d1    (d1 starts at the clear depth 1.0)
//   dual:   take2 = cover & depth > d1 & depth < d2
//           on take : layer 2 <- layer 1, layer 1 <- this fragment
//           on take2: layer 2 <- this fragment
//
// A layer carries its triangle and material ids (integer-valued floats),
// its edge sum and either its two barycentric numerators (n_attrs = 0) or
// n_attrs rational attribute numerators; one reciprocal of the layer's own
// edge sum at the end turns them into values (num * (1 / esum)). A layer
// with no winner reads depth 1.0, tri -1, everything else 0. Sparse grid:
// output slot s holds tile tile_map[s]; the wrapper scatters slots into
// the full tile layout.
//
// K2 (merged_tile_kernel) replaces
// renderengine_tpu/raster/pallas_raster.py::_merged_kernel (launched by
// rasterize_pallas_merged): the texture-space opaque pass and its two
// nearest translucent layers over two pair tables of K1's row layout at
// n_attrs 4: stream A (opaque) is K1's single winner with 4 attributes,
// stream B (translucent) K1's dual tracker with NO bounds on the first
// N_ATTRS_B (2 or 4) attributes, and the fold voids each blend layer
// deeper than A's depth (an empty layer). That equals K1's opaque launch
// followed by K1's dual launch with peel bounds (-1, opaque depth): an
// occluded blend fragment is deeper than every visible one.
//
// The selection, order-free. Pairs of a tile are stored in ascending
// triangle order (binning sorts by tile << tri_bits | tri), and a walk in
// that order with strict compares computes, over the fragments that pass
// (covered, inside the peel bounds, depth < 1.0):
//   layer 1 = the lexicographic minimum of (depth, pair index);
//   layer 2 = the same minimum over the passing fragments with depth
//             strictly greater than layer 1's (equal depths enter neither);
// and K2's fold is applied after both. Both minima are associative and
// commutative, so any cut of a tile's span into chunks merges exactly:
//   L1 = min over the chunks' L1;
//   L2 = min over {every chunk's L1 and L2} with depth > L1's depth
// (the true L2 is its own chunk's L1 or L2: a chunk holding two depths
// below it would hold one below the global L1). Every value a layer
// stores (depth, ids, edge sum, numerators, num * (1 / esum)) is a
// function of the (pair, pixel) alone, so the merge recomputes the
// winner's values from its pair row with the same arithmetic, bit for
// bit. tests/test_torch_split_merge.py holds this rule on the CPU.
//
// The work split. A work item is at most kItem pairs of one tile's span
// (K2: of the tile's A span followed by its B span). A tile with at most
// kItem pairs is one item and writes its planes directly. A denser tile
// becomes ceil(count / kItem) items: each walks its chunk carrying only
// 64-bit keys (canonical depth bits << 32 | pair index; depth + 0.0 turns
// -0.0 into +0.0, which the walk's compares already treat as equal),
// writes them to scratch, and bumps the tile's arrival counter after a
// __threadfence(); the last item to arrive merges the keys by the rule
// above, recomputes the winners from their rows (keeping the sign of a
// -0.0 depth) and writes the planes. Work is handed out on the card, and
// the host never reads it: block s walks slot s (one tile, chunk 0) and
// counts itself registered as it starts; the block of a split tile first
// takes the tile's key rows and queues its chunks 1..n-1. Helper blocks
// past the slots (at most (resident blocks a SM - 1) a SM, so slot
// blocks always find room) wait until every slot block has registered,
// then claim queued chunks with one atomicAdd each until the queue is
// empty; slot blocks wait on nothing, so the wait always ends. Claims
// start only once the queue is complete because claims made while it
// grows must be bounded (a compare-and-swap, or per-tile counters found
// through a shared cursor), and every idle block retrying them on the
// same counters serializes the chunks. Blocks are dispatched in order in
// practice, so the helpers start with the last wave and the split tiles'
// chunks run beside it. The launch resets its own counters: the merging
// item zeroes its tile's arrivals, and every helper counts itself out
// after its last claim, the last one zeroing the queue and registration
// counters (by then every slot block has registered, its last use of
// them). So the counters start at 0 for every launch, a replayed one (a
// CUDA graph) too, and no memset runs between launches. The scratch is sized
// from the pair table's rows, which bound the chunks, and the keys by
// the layers the launch carries. One workspace serves a device, so its
// launches must not overlap: the wrapper orders a launch on a new stream
// after the previous stream's work.
//
// Asynchronous staging. An item's rows (at most kItem, 80/128/176 B each,
// 16-B aligned) land in shared memory by Hopper's 1D bulk copy
// (cp.async.bulk with an mbarrier), kStage rows a copy, all issued by one
// thread when the block starts; the walk waits on each copy's barrier in
// turn, so rows k+1.. arrive while row group k is walked, and the walk has
// no __syncthreads. Per fragment, the three edge tests come first; a warp
// (one 32-pixel row of the tile) skips the z/w planes and the divide of a
// pair that covers none of its pixels, and the IEEE divide runs only
// where the edge, w and z tests pass.
//
// What bounds it on this card: the function is bound by bytes (pair rows
// read once, output planes written once; chip_smoke.py::k1_bound and
// k2_bound count them), but the walk issues about 31 FP32 operations per
// pair-pixel plus the divide on covered pixels, with no FMA (the rounding
// forbids it), so with the work spread over all 132 SMs the kernels are
// held by the walk's instruction issue and by writing the output planes:
// on an NVIDIA H100 80GB HBM3 at 700.00 W the 1080p opaque launch's
// kernel runs 0.131 ms against a bound of 0.039 ms, the 4096^2 shadow
// map's 0.344 ms against 0.111 ms (chip_smoke.py, the profiler's device
// time; PERF.md has every shape). Without the split, the densest tile
// (2833 pairs of the opaque pass) walked by one block set the launch's
// time alone.
//
// Rounding: build without --use_fast_math (it flushes denormals and
// approximates the divide; the 1e-35 tie epsilon must survive) and with
// -fmad=false; the __fmul_rn/__fadd_rn intrinsics also forbid
// contraction, so every plane rounds as (a*px + b*py) + c, matching the
// plain PyTorch versions bit for bit. Planes are never stepped from pixel
// to pixel (that rounds differently), and tensor cores cannot give these
// bits; the work stays on FP32 cores.
//
// Pair row layout (cpp floats per pair, cpp = 20 + 3 * n_attrs):
//   0..14 coef (e0 e1 e2 z w, each a*px + b*py + c) | 15..17 tie eps |
//   18 tri id | 19 material id | 20.. attribute planes (3 floats each)
// Bounds: [n_tiles, 2, 256] f32: prev | zmax per pixel. K1 output:
// [n_slots, (3 + n_num) * layers, 256] f32 planes, per layer depth | tri |
// mat | nums. K2 output: [n_tiles, (3 + 4) + 2 * (3 + N_ATTRS_B), 256].
//
// Beside them, clock_stamp_kernel: the device clock stamps of the frame's
// passes (utils/profiling.py::Stamps), one thread a launch.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

using u64 = unsigned long long;
constexpr int kTileH = 8;
constexpr int kTileW = 32;
constexpr int kThreads = kTileH * kTileW;  // one thread per pixel
constexpr int kItem = 64;                  // pairs per work item
constexpr int kStage = 16;                 // pairs per bulk copy
// K2's item may cut one copy in two at the A/B boundary
constexpr int kMaxStages = kItem / kStage + 1;
// resident blocks a SM asked of ptxas for K2 and K1 without DUAL (K1's
// dual walk carries two layers and runs best unconstrained)
constexpr int kMinBlocks = 6;
constexpr unsigned kFull = 0xffffffffu;
constexpr u64 kEmptyKey = (u64(0x3F800000u) << 32) | 0xFFFFFFFFu;
static_assert(kItem % kStage == 0, "an item is whole copies");

__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

__device__ __forceinline__ float plane(const float* r, float px, float py) {
  return plane(r[0], r[1], r[2], px, py);
}

// --- mbarrier and bulk copy -------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(u64* bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_addr(bars + i)),
                   "r"(1)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Make the barriers fresh for the next item of a block that walks several
// (every thread is past its last wait on them).
__device__ __forceinline__ void bar_reinit(u64* bars, int n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) {
      asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(
                       smem_addr(bars + i))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_addr(bars + i)),
                   "r"(1)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// one thread: copy `bytes` from global src to shared dst, completing on bar
__device__ __forceinline__ void bulk_copy(u64* bar, float* dst,
                                          const float* src, uint32_t bytes) {
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(b),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

__device__ __forceinline__ void bar_wait(u64* bar) {
  const uint32_t b = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b)
        : "memory");
  } while (!done);
}

// Stage an item's rows: [0, na) from a, then [na, na + nb) from b, kStage
// rows a copy, copy j completing on bars[j]. Issued by thread 0.
template <int kCols>
__device__ __forceinline__ void stage_rows(float* rows, u64* bars,
                                           const float* a, int na,
                                           const float* b, int nb) {
  if (threadIdx.x != 0) return;
  // the rows buffer may hold an earlier item, read by the generic proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  int j = 0;
  for (int o = 0; o < na; o += kStage, ++j)
    bulk_copy(bars + j, rows + o * kCols, a + (size_t)o * kCols,
              min(kStage, na - o) * kCols * 4);
  for (int o = 0; o < nb; o += kStage, ++j)
    bulk_copy(bars + j, rows + (na + o) * kCols, b + (size_t)o * kCols,
              min(kStage, nb - o) * kCols * 4);
}

// --- what a walk carries ----------------------------------------------------

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
  __device__ __forceinline__ void set(const float* r, unsigned, float px,
                                      float py, float depth, float e0,
                                      float e1, float e2) {
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

// What a chunk of a split tile carries: the depth and pair index.
struct Key {
  float d = 1.0f;
  unsigned idx = 0xFFFFFFFFu;

  template <int N_ATTRS>
  __device__ __forceinline__ void set(const float*, unsigned i, float,
                                      float, float depth, float, float,
                                      float) {
    d = depth;
    idx = i;
  }

  // (depth bits, pair index); +0.0 for -0.0, kEmptyKey with no winner
  __device__ __forceinline__ u64 key() const {
    return (u64(__float_as_uint(__fadd_rn(d, 0.0f))) << 32) | idx;
  }
};

// --- the walk ---------------------------------------------------------------

// Walk n staged rows (pair indices idx0..) of a table whose rows carry
// N_ATTRS attribute planes; l1 (and with DUAL l2) take the winners. PEEL
// applies the per-pixel bounds prev < depth <= zmax.
template <int N_ATTRS, bool PEEL, bool DUAL, class L>
__device__ __forceinline__ void walk_rows(const float* rows, int n,
                                          unsigned idx0, float px, float py,
                                          float prev, float zmax, L& l1,
                                          L& l2) {
  constexpr int kCols = 20 + 3 * N_ATTRS;
  for (int p = 0; p < n; ++p) {
    const float* r = rows + p * kCols;
    const float4 c0 = *reinterpret_cast<const float4*>(r);
    const float4 c1 = *reinterpret_cast<const float4*>(r + 4);
    const float4 c2 = *reinterpret_cast<const float4*>(r + 8);
    const float4 c3 = *reinterpret_cast<const float4*>(r + 12);
    const float4 c4 = *reinterpret_cast<const float4*>(r + 16);
    const float e0 = plane(c0.x, c0.y, c0.z, px, py);
    const float e1 = plane(c0.w, c1.x, c1.y, px, py);
    const float e2 = plane(c1.z, c1.w, c2.x, px, py);
    const bool edge = (__fadd_rn(e0, c3.w) > 0.0f) &&
                      (__fadd_rn(e1, c4.x) > 0.0f) &&
                      (__fadd_rn(e2, c4.y) > 0.0f);
    if (!__any_sync(kFull, edge)) continue;  // no pixel of this row
    const float zn = plane(c2.y, c2.z, c2.w, px, py);
    const float wn = plane(c3.x, c3.y, c3.z, px, py);
    if (!(edge && (wn > 0.0f) && (zn >= 0.0f) && (zn <= wn))) continue;
    const float d = __fdiv_rn(zn, wn);
    if (PEEL && !((d > prev) && (d <= zmax))) continue;
    if (d < l1.d) {
      if (DUAL) l2 = l1;
      l1.template set<N_ATTRS>(r, idx0 + p, px, py, d, e0, e1, e2);
    } else if (DUAL && d > l1.d && d < l2.d) {
      l2.template set<N_ATTRS>(r, idx0 + p, px, py, d, e0, e1, e2);
    }
  }
}

// Walk n rows staged at `rows` by copies bars[j], bars[j + 1], ...,
// waiting for each copy before its rows; j moves past them.
template <int N_ATTRS, bool PEEL, bool DUAL, class L>
__device__ __forceinline__ void walk_staged(const float* rows, u64* bars,
                                            int& j, int n, unsigned idx0,
                                            float px, float py, float prev,
                                            float zmax, L& l1, L& l2) {
  constexpr int kCols = 20 + 3 * N_ATTRS;
  for (int o = 0; o < n; o += kStage, ++j) {
    bar_wait(bars + j);
    walk_rows<N_ATTRS, PEEL, DUAL>(rows + o * kCols, min(kStage, n - o),
                                   idx0 + o, px, py, prev, zmax, l1, l2);
  }
}

// --- the merge of a split tile ----------------------------------------------

// Fold one chunk's key into the merged (k1, k2); with DUAL, k2 is the
// least key whose depth is strictly greater than k1's.
template <bool DUAL>
__device__ __forceinline__ void merge_key(u64& k1, u64& k2,
                                          u64 x) {
  const uint32_t dx = uint32_t(x >> 32), d1 = uint32_t(k1 >> 32);
  if (x < k1) {
    if (DUAL && dx < d1) k2 = k1;
    k1 = x;
  } else if (DUAL && dx > d1 && x < k2) {
    k2 = x;
  }
}

// The layer a key names, recomputed from its pair row as the walk
// computes it (the clear layer for kEmptyKey).
template <int N_ATTRS, int N_NUM>
__device__ __forceinline__ void resolve(const float* __restrict__ pairs,
                                        u64 key, float px, float py,
                                        Layer<N_NUM>& l) {
  if (key == kEmptyKey) return;
  const float* r = pairs + (size_t)uint32_t(key) * (20 + 3 * N_ATTRS);
  const float e0 = plane(r + 0, px, py);
  const float e1 = plane(r + 3, px, py);
  const float e2 = plane(r + 6, px, py);
  const float d = __fdiv_rn(plane(r + 9, px, py), plane(r + 12, px, py));
  l.template set<N_ATTRS>(r, 0, px, py, d, e0, e1, e2);
}

// Publish this item's keys (stored by the caller) and count its arrival;
// true in the last item of the tile to arrive, which then sees every
// item's keys and leaves the counter at 0 for the next launch.
__device__ __forceinline__ bool arrive_last(int* counter, int n_items) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == n_items - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

__device__ __forceinline__ int items_of(int count) {
  return count <= kItem ? 1 : (count + kItem - 1) / kItem;
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

// --- the work queue ---------------------------------------------------------

constexpr int kCtr = 8;  // counters at the head of the int32 workspace

// The int32 workspace a device's launches share, one at a time. It
// starts zeroed and every launch leaves it so: the arrivals by the
// merging item, the counters by the launch's last helper to finish. Only
// thread 0 of a block touches the counters.
struct Work {
  int* ctr;       // [1] chunks queued, [2] slot blocks registered,
                  // [3] key rows taken, [4] chunks claimed, [5] helpers
                  // done
  int* arrivals;  // [slots] finished items of each split tile
  int4* queue;    // chunks k >= 1 of split tiles: (slot, k, key row, 0)
};

// A helper past its last claim counts itself out; the launch's last one
// zeroes the counters for the next launch (the other helpers are past
// their last use of them, and every slot block registered, its last use,
// before any helper claimed).
__device__ __forceinline__ void helper_done(const Work& w, int n_helpers) {
  if (threadIdx.x != 0) return;
  __threadfence();
  if (atomicAdd(w.ctr + 5, 1) != n_helpers - 1) return;
  for (int i = 0; i < kCtr; ++i) w.ctr[i] = 0;
}

// A slot block counts itself registered as it starts; a split tile's
// block first takes the tile's n key rows and queues its chunks 1..n-1
// (returns the first key row).
__device__ __forceinline__ int register_slot(const Work& w, int slot,
                                             int n) {
  __shared__ int base, pos;
  if (n > 1) {
    if (threadIdx.x == 0) {
      base = atomicAdd(w.ctr + 3, n);
      pos = atomicAdd(w.ctr + 1, n - 1);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n - 1; i += kThreads)
      w.queue[pos + i] = make_int4(slot, i + 1, base, 0);
    __threadfence();
    __syncthreads();
  }
  if (threadIdx.x == 0) atomicAdd(w.ctr + 2, 1);
  return n > 1 ? base : -1;
}

// A helper block: wait until every slot block has registered (slot
// blocks wait on nothing, and the helpers leave room for them on every
// SM), then claim queued chunks one at a time; false when none is left.
__device__ __forceinline__ void wait_registered(const Work& w, int n_slots) {
  if (threadIdx.x == 0) {
    while (*reinterpret_cast<volatile int*>(w.ctr + 2) < n_slots)
      __nanosleep(256);
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ bool claim(const Work& w, int4& chunk) {
  __shared__ int4 c;
  __syncthreads();  // every thread has read the previous claim
  if (threadIdx.x == 0) {
    const int q = atomicAdd(w.ctr + 4, 1);
    c = q < *reinterpret_cast<volatile int*>(w.ctr + 1)
            ? __ldcg(w.queue + q)
            : make_int4(-1, 0, 0, 0);
  }
  __syncthreads();
  chunk = c;
  return chunk.x >= 0;
}

// --- K1 ---------------------------------------------------------------------

struct K1Args {
  const float* pairs;
  const int* starts;
  const int* counts;
  const int* tile_map;  // null: the dense grid, slot s = tile s
  const float* bounds;  // null: no peel test
  float* out;
  u64* keys;  // [key rows, layers, 256]
  Work w;
  int n_slots;  // blocks past n_slots are helpers
  int ntx, width, full_height, y0;
};

// Chunk k of split slot `slot` (key rows from `base`): walk it carrying
// keys, publish them; the tile's last chunk to finish merges and writes.
template <int N_ATTRS, bool PEEL, bool DUAL>
__device__ __forceinline__ void k1_chunk(const K1Args& a, int slot, int k,
                                         int base, float* rows, u64* bars) {
  constexpr int kCols = 20 + 3 * N_ATTRS;
  constexpr int kNum = N_ATTRS > 0 ? N_ATTRS : 2;
  constexpr int kLayers = DUAL ? 2 : 1;
  const int tile = a.tile_map != nullptr ? a.tile_map[slot] : slot;
  const int start = a.starts[tile], count = a.counts[tile];
  const int off = k * kItem;
  const int n = min(kItem, count - off);
  stage_rows<kCols>(rows, bars, a.pairs + (size_t)(start + off) * kCols, n,
                    nullptr, 0);
  const int lane = threadIdx.x;
  float px, py, prev = 0.0f, zmax = 0.0f;
  pixel(tile, a.ntx, a.width, a.full_height, a.y0, px, py);
  if (PEEL) {
    prev = a.bounds[(size_t)tile * 2 * kThreads + lane];
    zmax = a.bounds[(size_t)tile * 2 * kThreads + kThreads + lane];
  }
  Key c1, c2;
  int j = 0;
  walk_staged<N_ATTRS, PEEL, DUAL>(rows, bars, j, n, start + off, px, py,
                                   prev, zmax, c1, c2);
  const size_t stride = (size_t)kLayers * kThreads;
  u64* kb = a.keys + (size_t)base * stride + lane;
  kb[k * stride] = c1.key();
  if (DUAL) kb[k * stride + kThreads] = c2.key();
  const int n_items = items_of(count);
  if (!arrive_last(a.w.arrivals + slot, n_items)) return;

  u64 k1 = kEmptyKey, k2 = kEmptyKey;
  for (int c = 0; c < n_items; ++c) {
    merge_key<DUAL>(k1, k2, __ldcg(kb + c * stride));
    if (DUAL) merge_key<DUAL>(k1, k2, __ldcg(kb + c * stride + kThreads));
  }
  float* o = a.out + (size_t)slot * (3 + kNum) * kLayers * kThreads + lane;
  Layer<kNum> l1, l2;
  resolve<N_ATTRS>(a.pairs, k1, px, py, l1);
  l1.store(o);
  if (DUAL) {
    resolve<N_ATTRS>(a.pairs, k2, px, py, l2);
    l2.store(o + (3 + kNum) * kThreads);
  }
}

template <int N_ATTRS, bool PEEL, bool DUAL>
__global__ void __launch_bounds__(kThreads, DUAL ? 1 : kMinBlocks)
raster_tile_kernel(const K1Args a) {
  constexpr int kCols = 20 + 3 * N_ATTRS;
  constexpr int kNum = N_ATTRS > 0 ? N_ATTRS : 2;
  constexpr int kLayers = DUAL ? 2 : 1;
  __shared__ __align__(16) float rows[kItem * kCols];
  __shared__ __align__(8) u64 bars[kMaxStages];

  const int slot = blockIdx.x;
  bar_init(bars, kMaxStages);
  if (slot >= a.n_slots) {  // a helper: walk queued chunks
    wait_registered(a.w, a.n_slots);
    int4 c;
    for (bool first = true; claim(a.w, c); first = false) {
      if (!first) bar_reinit(bars, kMaxStages);
      k1_chunk<N_ATTRS, PEEL, DUAL>(a, c.x, c.y, c.z, rows, bars);
    }
    helper_done(a.w, gridDim.x - a.n_slots);
    return;
  }
  const int tile = a.tile_map != nullptr ? a.tile_map[slot] : slot;
  const int start = a.starts[tile], count = a.counts[tile];
  const int base = register_slot(a.w, slot, items_of(count));
  if (count > kItem) {
    k1_chunk<N_ATTRS, PEEL, DUAL>(a, slot, 0, base, rows, bars);
    return;
  }
  // one item: walk the tile and write its planes directly
  stage_rows<kCols>(rows, bars, a.pairs + (size_t)start * kCols, count,
                    nullptr, 0);
  const int lane = threadIdx.x;
  float px, py, prev = 0.0f, zmax = 0.0f;
  pixel(tile, a.ntx, a.width, a.full_height, a.y0, px, py);
  if (PEEL) {
    prev = a.bounds[(size_t)tile * 2 * kThreads + lane];
    zmax = a.bounds[(size_t)tile * 2 * kThreads + kThreads + lane];
  }
  Layer<kNum> l1, l2;
  int j = 0;
  walk_staged<N_ATTRS, PEEL, DUAL>(rows, bars, j, count, start, px, py, prev,
                                   zmax, l1, l2);
  float* o = a.out + (size_t)slot * (3 + kNum) * kLayers * kThreads + lane;
  l1.store(o);
  if (DUAL) l2.store(o + (3 + kNum) * kThreads);
}

// --- K2 ---------------------------------------------------------------------

struct K2Args {
  const float* pairs_a;
  const int* starts_a;
  const int* counts_a;
  const float* pairs_b;
  const int* starts_b;
  const int* counts_b;
  float* out;
  u64* keys;  // [key rows, 3, 256]
  Work w;
  int n_tiles;  // blocks past n_tiles are helpers
  int ntx, width, full_height, y0;
};

constexpr int kAttrsK2 = 4;                   // attribute planes of both tables
constexpr int kColsK2 = 20 + 3 * kAttrsK2;

// An item of K2: pairs [lo, lo + kItem) of the tile's A span followed by
// its B span, staged; sets the A rows and B rows it holds.
__device__ __forceinline__ void k2_stage(const K2Args& a, int tile, int k,
                                         float* rows, u64* bars, int& na,
                                         int& nb, unsigned& ia,
                                         unsigned& ib) {
  const int ca = a.counts_a[tile], cb = a.counts_b[tile];
  const int lo = k * kItem, hi = min(lo + kItem, ca + cb);
  const int a0 = min(lo, ca), b0 = max(lo, ca) - ca;
  na = min(hi, ca) - a0;
  nb = max(hi, ca) - ca - b0;
  ia = a.starts_a[tile] + a0;
  ib = a.starts_b[tile] + b0;
  stage_rows<kColsK2>(rows, bars, a.pairs_a + (size_t)ia * kColsK2, na,
                      a.pairs_b + (size_t)ib * kColsK2, nb);
}

// stream A's layer, the fold of both blend layers under it, the stores
template <int N_ATTRS_B>
__device__ __forceinline__ void k2_store(const K2Args& a, int tile,
                                         const Layer<kAttrsK2>& a1,
                                         Layer<N_ATTRS_B>& b1,
                                         Layer<N_ATTRS_B>& b2) {
  constexpr int kPlanesA = 3 + kAttrsK2;
  constexpr int kPlanesB = 3 + N_ATTRS_B;
  float* o = a.out + (size_t)tile * (kPlanesA + 2 * kPlanesB) * kThreads +
             threadIdx.x;
  a1.store(o);
  if (b1.d > a1.d) b1 = Layer<N_ATTRS_B>();
  if (b2.d > a1.d) b2 = Layer<N_ATTRS_B>();
  b1.store(o + kPlanesA * kThreads);
  b2.store(o + (kPlanesA + kPlanesB) * kThreads);
}

template <int N_ATTRS_B>
__device__ __forceinline__ void k2_chunk(const K2Args& a, int tile, int k,
                                         int base, float* rows, u64* bars) {
  int na, nb;
  unsigned ia, ib;
  k2_stage(a, tile, k, rows, bars, na, nb, ia, ib);
  const int lane = threadIdx.x;
  float px, py;
  pixel(tile, a.ntx, a.width, a.full_height, a.y0, px, py);
  Key ka, ka_unused, kb1, kb2;
  int j = 0;
  walk_staged<kAttrsK2, false, false>(rows, bars, j, na, ia, px, py, 0.0f,
                                      0.0f, ka, ka_unused);
  walk_staged<kAttrsK2, false, true>(rows + na * kColsK2, bars, j, nb, ib,
                                     px, py, 0.0f, 0.0f, kb1, kb2);
  const size_t stride = 3 * kThreads;
  u64* kb = a.keys + (size_t)base * stride + lane;
  kb[k * stride] = ka.key();
  kb[k * stride + kThreads] = kb1.key();
  kb[k * stride + 2 * kThreads] = kb2.key();
  const int n_items = items_of(a.counts_a[tile] + a.counts_b[tile]);
  if (!arrive_last(a.w.arrivals + tile, n_items)) return;

  u64 k_a = kEmptyKey, k_unused = kEmptyKey, k1 = kEmptyKey, k2 = kEmptyKey;
  for (int c = 0; c < n_items; ++c) {
    merge_key<false>(k_a, k_unused, __ldcg(kb + c * stride));
    merge_key<true>(k1, k2, __ldcg(kb + c * stride + kThreads));
    merge_key<true>(k1, k2, __ldcg(kb + c * stride + 2 * kThreads));
  }
  Layer<kAttrsK2> a1;
  Layer<N_ATTRS_B> b1, b2;
  resolve<kAttrsK2>(a.pairs_a, k_a, px, py, a1);
  resolve<kAttrsK2>(a.pairs_b, k1, px, py, b1);
  resolve<kAttrsK2>(a.pairs_b, k2, px, py, b2);
  k2_store(a, tile, a1, b1, b2);
}

// Stream A's single winner, stream B's two nearest layers (the first
// N_ATTRS_B attributes), the fold under stream A's depth.
template <int N_ATTRS_B>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
merged_tile_kernel(const K2Args a) {
  __shared__ __align__(16) float rows[kItem * kColsK2];
  __shared__ __align__(8) u64 bars[kMaxStages];

  const int tile = blockIdx.x;
  bar_init(bars, kMaxStages);
  if (tile >= a.n_tiles) {  // a helper: walk queued chunks
    wait_registered(a.w, a.n_tiles);
    int4 c;
    for (bool first = true; claim(a.w, c); first = false) {
      if (!first) bar_reinit(bars, kMaxStages);
      k2_chunk<N_ATTRS_B>(a, c.x, c.y, c.z, rows, bars);
    }
    helper_done(a.w, gridDim.x - a.n_tiles);
    return;
  }
  const int count = a.counts_a[tile] + a.counts_b[tile];
  const int base = register_slot(a.w, tile, items_of(count));
  if (count > kItem) {
    k2_chunk<N_ATTRS_B>(a, tile, 0, base, rows, bars);
    return;
  }
  // one item: walk both spans and write the planes directly
  int na, nb;
  unsigned ia, ib;
  k2_stage(a, tile, 0, rows, bars, na, nb, ia, ib);
  float px, py;
  pixel(tile, a.ntx, a.width, a.full_height, a.y0, px, py);
  Layer<kAttrsK2> a1, a_unused;
  Layer<N_ATTRS_B> b1, b2;
  int j = 0;
  walk_staged<kAttrsK2, false, false>(rows, bars, j, na, 0, px, py, 0.0f,
                                      0.0f, a1, a_unused);
  walk_staged<kAttrsK2, false, true>(rows + na * kColsK2, bars, j, nb, 0, px,
                                     py, 0.0f, 0.0f, b1, b2);
  k2_store(a, tile, a1, b1, b2);
}

// --- launches ---------------------------------------------------------------

// The int32 workspace for launches of up to cap_slots slots over tables
// of up to rows pair rows in all: the counters, the arrivals, the queue
// (fewer than rows / kItem chunks beyond the first of each split tile).
long long queue_len(long long rows) { return rows / kItem + 1; }

long long int_words(int cap_slots, long long rows) {
  return kCtr + (cap_slots + 3) / 4 * 4 + 4 * queue_len(rows);
}

// Key rows of a launch over rows pair rows: its split chunks number below
// 2 * rows / kItem (ceil(c / kItem) < 2 c / kItem for c > kItem).
long long key_rows(long long rows) { return 2 * rows / kItem + 1; }

Work carve(int* ws, int cap_slots) {
  Work w;
  w.ctr = ws;
  w.arrivals = ws + kCtr;
  w.queue = reinterpret_cast<int4*>(w.arrivals + (cap_slots + 3) / 4 * 4);
  return w;
}

// The grid of a kernel: the slots, then helper blocks, as many as the
// queue could hold up to (resident blocks a SM - 1) a SM, so that slot
// blocks always find room even if helpers were dispatched first.
// (occ: the kernel's resident blocks a SM, from the occupancy query)
int grid_of(int occ, int n_slots, long long rows) {
  static int sms[64] = {};  // SMs of each device, queried once
  int dev = 0;
  cudaGetDevice(&dev);
  int& n_sm = sms[dev & 63];
  if (n_sm == 0)
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const long long helpers = std::max(1, n_sm * (occ - 1));
  return n_slots + (int)std::min(queue_len(rows), helpers);
}

template <class Kernel>
int occupancy(Kernel kernel) {
  int occ = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, 0);
  return occ;
}

template <int N_ATTRS, bool PEEL, bool DUAL>
void launch_k1(const K1Args& a, long long rows, cudaStream_t s) {
  static const int occ = occupancy(raster_tile_kernel<N_ATTRS, PEEL, DUAL>);
  raster_tile_kernel<N_ATTRS, PEEL, DUAL>
      <<<grid_of(occ, a.n_slots, rows), kThreads, 0, s>>>(a);
}

template <int N_ATTRS_B>
void launch_k2(const K2Args& a, long long rows, cudaStream_t s) {
  static const int occ = occupancy(merged_tile_kernel<N_ATTRS_B>);
  merged_tile_kernel<N_ATTRS_B>
      <<<grid_of(occ, a.n_tiles, rows), kThreads, 0, s>>>(a);
}

template <int N_ATTRS>
void launch_k1_mode(bool peel, bool dual, const K1Args& a, long long rows,
                    cudaStream_t s) {
  if (dual) {
    launch_k1<N_ATTRS, true, true>(a, rows, s);
  } else if (peel) {
    launch_k1<N_ATTRS, true, false>(a, rows, s);
  } else {
    launch_k1<N_ATTRS, false, false>(a, rows, s);
  }
}

// --- device clock stamps ----------------------------------------------------

// One thread reads the device clock (%globaltimer, ns) into a stamp
// buffer of 2 * n_regions slots (utils/profiling.py::Stamps): a region's
// entry writes buf[slot], its exit adds the time since then to
// buf[n_regions + slot]. With `out`, the durations are then copied there
// and cleared (the frame program's last stamp).
__global__ void clock_stamp_kernel(long long* buf, int slot, int exit,
                                   long long* out, int n_regions) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const long long now = static_cast<long long>(t);
  if (exit) {
    buf[n_regions + slot] += now - buf[slot];
  } else {
    buf[slot] = now;
  }
  if (out != nullptr) {
    for (int i = 0; i < n_regions; ++i) {
      out[i] = buf[n_regions + i];
      buf[n_regions + i] = 0;
    }
  }
}

}  // namespace

// Pairs per work item.
extern "C" int raster_item_pairs() { return kItem; }

// int32 words of the workspace for launches of up to cap_slots slots over
// tables of up to rows pair rows in all; it starts zeroed.
extern "C" long long raster_int_words(int cap_slots, long long rows) {
  return int_words(cap_slots, rows);
}

// 64-bit words of the key scratch for a launch over rows pair rows that
// carries `layers` layers a pixel (K1: 1, or 2 with dual; K2: 3); needs
// no zeroing.
extern "C" long long raster_key_words(long long rows, int layers) {
  return key_rows(rows) * layers * kThreads;
}

// K1 on `stream`. tile_map: null for the dense grid (slot s = tile s),
// else n_slots tile ids. bounds: null for no peel test; dual needs it.
// ints: raster_int_words(cap_slots, rows) words, zeroed before its first
// launch, left zeroed by each; keys: raster_key_words(rows, 1 or 2)
// words; n_slots <= cap_slots, rows = the table's. Launches sharing
// ints must not overlap. Returns the CUDA error code (0 = launched), -1
// for an unsupported mode.
extern "C" int raster_tile_launch(const float* pairs, const int* starts,
                                  const int* counts, const int* tile_map,
                                  const float* bounds, float* out, int* ints,
                                  u64* keys, int cap_slots, int n_slots,
                                  int rows, int ntx, int width,
                                  int full_height, int y0, int n_attrs,
                                  int dual, void* stream) {
  if (n_slots <= 0) return 0;
  if (dual && bounds == nullptr) return -1;
  if (n_attrs != 0 && n_attrs != 4 && n_attrs != 8) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const K1Args a{pairs, starts, counts, tile_map, bounds, out, keys,
                 carve(ints, cap_slots), n_slots, ntx, width, full_height,
                 y0};
  const bool peel = bounds != nullptr;
  if (n_attrs == 0) {
    launch_k1_mode<0>(peel, dual != 0, a, rows, s);
  } else if (n_attrs == 4) {
    launch_k1_mode<4>(peel, dual != 0, a, rows, s);
  } else {
    launch_k1_mode<8>(peel, dual != 0, a, rows, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2 over the dense tile grid of both tables on `stream`; ints and keys
// as for K1 (keys: raster_key_words(rows, 3)), rows = both tables' rows.
// Returns the CUDA error code (0 = launched), -1 for an unsupported
// n_attrs_b.
extern "C" int merged_tile_launch(const float* pairs_a, const int* starts_a,
                                  const int* counts_a, const float* pairs_b,
                                  const int* starts_b, const int* counts_b,
                                  float* out, int* ints, u64* keys,
                                  int cap_slots, int n_tiles, int rows,
                                  int ntx, int width, int full_height,
                                  int y0, int n_attrs_b, void* stream) {
  if (n_tiles <= 0) return 0;
  if (n_attrs_b != 2 && n_attrs_b != 4) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const K2Args a{pairs_a, starts_a, counts_a, pairs_b, starts_b, counts_b,
                 out, keys, carve(ints, cap_slots), n_tiles, ntx, width,
                 full_height, y0};
  if (n_attrs_b == 2) {
    launch_k2<2>(a, rows, s);
  } else {
    launch_k2<4>(a, rows, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// One clock stamp (clock_stamp_kernel) on `stream`; out may be null.
// Returns the CUDA error code (0 = launched).
extern "C" int clock_stamp_launch(long long* buf, int slot, int exit,
                                  long long* out, int n_regions,
                                  void* stream) {
  clock_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      buf, slot, exit, out, n_regions);
  return static_cast<int>(cudaGetLastError());
}
