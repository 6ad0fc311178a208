// Multilevel RoIAlign forward and backward for Hopper (sm_90a), plain C
// interface for ctypes. The backward is described at d2t_roi_align_bwd below.
//
// The forward replaces the TPU kernel `roi_align_pallas_multilevel`
// (detectron2_tpu/ops/pallas/roi_align_pallas.py:226, body `_make_kernel`).
// It is held to the exact formulation `_roi_align_multilevel_xla`
// (detectron2_tpu/ops/roi_align.py:769-874), not to the TPU kernel's
// DMA-window approximation: no fixed [48,64] window, no small/big window
// split, no channel chunking. Every sample reads its four taps from the full
// level map.
//
// Per roi r (assigned level l, image b), with s = sampling_ratio (2 when 0):
//   x0 = box.x0 * scale_l - off, ...  (off = 0.5 when aligned, else 0 and the
//   roi w/h are clamped to >= 1: the v1 grid)
//   bin (py, px) = mean over its s*s samples of bilinear(feature_l[b], y, x),
//   y = y0 + (py + (iy + 0.5) / s) * bin_h, likewise x;
//   a sample outside [-1, size] on either axis contributes 0; coordinates
//   clamp to [0, size-1] and the upper tap is min(lo + 1, size - 1).
//
// What bounds it on the card: memory traffic, never arithmetic (about 10
// flops per sample and channel). At the Mask R-CNN R50-FPN batch of 16 images
// at 800x1344 the box pool writes 16000*49*256*2 B = 0.40 GB of bf16 output
// and the mask pool 0.16 GB, and the rois together touch about 0.4 GB of
// p2-p5; but every roi gathers its own footprint (7-28 pixels a side at its
// level, 256 channels: about 0.2 MB), so the traffic between L2 and the SMs
// is 16000 footprints, a few GB, whatever DRAM sees, and every 16-byte tap
// costs some 30 instructions (the multiplies and adds stay unfused, see
// Build). The design keeps that traffic to one pass over each footprint,
// computes nothing twice and makes every access wide:
//  - features are NHWC, so a tap is one contiguous C-vector; a thread owns 8
//    adjacent bf16 channels (4 float32) and moves each tap as one 16-byte
//    load through the read-only path and each bin as one 16-byte store; 32
//    threads cover C = 256, so a block of 8 warps has 8 bins in flight;
//  - one block owns a roi (or, for a small pool, a band of its output rows,
//    so that the card is filled): the taps that neighbouring samples and
//    bins share are served by L1 while the roi is in flight. Staging the
//    footprint of a channel chunk in shared memory instead (one copy, then
//    every tap from there) was measured 1.3 to 3.9 times slower at the
//    main-path pools and is not kept;
//  - coordinates once per roi: the block first fills a shared table, per
//    axis, of the ph*s (pw*s) sample rows' (columns') {lo, hi, frac, inside},
//    computed with the plain version's expressions in its order; every bin
//    reads it. Tap selection and the order of the float32 sums are the
//    plain version's: in float32 the two agree bit for bit;
//  - C that is not a whole number of 16-byte words, or a pointer that is not
//    16-byte aligned, takes the same kernel with one channel per thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
//        -Xcompiler -fPIC. -fmad=false keeps the coordinate arithmetic
// rounded op by op, as the plain PyTorch version and XLA compute it, so that
// floor() lands on the same tap at bin edges.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define D2T_MAX_LEVELS 8

struct D2tLevels {
  const void* ptr[D2T_MAX_LEVELS];  // [B, H_l, W_l, C] contiguous, NHWC
  int H[D2T_MAX_LEVELS];
  int W[D2T_MAX_LEVELS];
  float scale[D2T_MAX_LEVELS];
  long long row_base[D2T_MAX_LEVELS];  // level's first row in the flat [sum B*H_l*W_l, C] buffer
  int num_levels;
};

__device__ __forceinline__ float d2t_load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float d2t_load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void d2t_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void d2t_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One axis of a sample: taps, fraction and the inside test of the XLA
// formulation (`_prep` in ops/roi_align.py).
__device__ __forceinline__ void d2t_axis(float coord, int size, int* lo, int* hi,
                                         float* frac, bool* inside) {
  const float sizef = (float)size;
  *inside = (coord >= -1.0f) && (coord <= sizef);
  float c = fminf(fmaxf(coord, 0.0f), sizef - 1.0f);
  float l = floorf(c);
  *frac = c - l;
  *lo = (int)l;
  *hi = min(*lo + 1, size - 1);
}

// One sample row or column of a roi: what d2t_axis gives for it.
struct D2tAxisEntry {
  int lo, hi;
  float frac;
  int inside;
};

// A roi's sample grid on its level: first sample's origin and bin sizes.
struct D2tRoiGrid {
  float y0, x0, bin_h, bin_w;
};

__device__ __forceinline__ D2tRoiGrid d2t_roi_grid(const float* boxes, int r, float scale, int aligned,
                                                   int ph, int pw) {
  const float off = aligned ? 0.5f : 0.0f;
  const float x0 = boxes[4 * r + 0] * scale - off;
  const float y0 = boxes[4 * r + 1] * scale - off;
  const float x1 = boxes[4 * r + 2] * scale - off;
  const float y1 = boxes[4 * r + 3] * scale - off;
  float roi_w = x1 - x0;
  float roi_h = y1 - y0;
  if (!aligned) {
    roi_w = fmaxf(roi_w, 1.0f);
    roi_h = fmaxf(roi_h, 1.0f);
  }
  D2tRoiGrid g;
  g.y0 = y0;
  g.x0 = x0;
  g.bin_h = roi_h / (float)ph;
  g.bin_w = roi_w / (float)pw;
  return g;
}

// Entry k of a roi's axis table: sample row k for k < ny, else sample column
// k - ny; the very expressions of the plain version, in its order.
__device__ __forceinline__ D2tAxisEntry d2t_axis_entry(const D2tRoiGrid& g, int k, int ny, int s, int H,
                                                       int W) {
  const bool is_y = k < ny;
  const int kk = is_y ? k : k - ny;
  const int bin = kk / s, sub = kk - bin * s;
  const float coord = (is_y ? g.y0 : g.x0) + ((float)bin + ((float)sub + 0.5f) / (float)s) * (is_y ? g.bin_h : g.bin_w);
  D2tAxisEntry e;
  bool inside;
  d2t_axis(coord, is_y ? H : W, &e.lo, &e.hi, &e.frac, &inside);
  e.inside = inside ? 1 : 0;
  return e;
}

// VEC adjacent channels of one pixel: one load (through the read-only
// path), its float32 values, and one store.
template <typename T, int VEC>
struct D2tChannels;

template <>
struct D2tChannels<__nv_bfloat16, 8> {
  typedef uint4 Raw;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& raw, float (&v)[8]) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct D2tChannels<float, 4> {
  typedef float4 Raw;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& raw, float (&v)[4]) {
    v[0] = raw.x;
    v[1] = raw.y;
    v[2] = raw.z;
    v[3] = raw.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <typename T>
struct D2tChannels<T, 1> {
  typedef float Raw;
  static __device__ __forceinline__ Raw load(const T* p) { return d2t_load(p); }
  static __device__ __forceinline__ void unpack(const Raw& raw, float (&v)[1]) { v[0] = raw; }
  static __device__ __forceinline__ void store(T* p, const float (&v)[1]) { d2t_store(p, v[0]); }
};

constexpr int D2T_FWD_THREADS = 256;

// Block (r, part) pools output rows [part * ph / parts, (part + 1) * ph /
// parts) of roi r. A thread owns VEC adjacent channels of one bin at a time:
// `lanes` threads cover C, the block's other threads other bins.
template <typename T, int VEC>
__global__ void __launch_bounds__(D2T_FWD_THREADS)
    d2t_roi_align_fwd_kernel(D2tLevels lv, const float* __restrict__ boxes,
                             const int* __restrict__ batch_idx, const int* __restrict__ levels,
                             T* __restrict__ out, int C, int ph, int pw, int s, int aligned) {
  extern __shared__ __align__(16) unsigned char d2t_smem[];
  D2tAxisEntry* ytab = reinterpret_cast<D2tAxisEntry*>(d2t_smem);  // [ph * s]
  D2tAxisEntry* xtab = ytab + ph * s;                              // [pw * s]

  const int r = blockIdx.x;
  const int l = levels[r];
  const int b = batch_idx[r];
  const int H = lv.H[l];
  const int W = lv.W[l];
  const float scale = lv.scale[l];
  const T* plane = (const T*)lv.ptr[l] + (size_t)b * H * W * C;
  const D2tRoiGrid grid = d2t_roi_grid(boxes, r, scale, aligned, ph, pw);
  const float count = (float)(s * s);

  // each sample row's and column's taps, once per roi
  const int ny = ph * s, nx = pw * s;
  for (int i = threadIdx.x; i < ny + nx; i += blockDim.x) ytab[i] = d2t_axis_entry(grid, i, ny, s, H, W);
  __syncthreads();

  const int vecs = C / VEC;  // channel vectors of one pixel
  const int lanes = vecs < (int)blockDim.x ? vecs : (int)blockDim.x;
  const int slots = blockDim.x / lanes;  // bins in flight
  const int lane = threadIdx.x % lanes, slot = threadIdx.x / lanes;
  if (slot >= slots) return;
  const int row_begin = (int)(((long long)blockIdx.y * ph) / gridDim.y);
  const int row_end = (int)(((long long)(blockIdx.y + 1) * ph) / gridDim.y);

  for (int bin = row_begin * pw + slot; bin < row_end * pw; bin += slots) {
    const int py = bin / pw, px = bin - py * pw;
    for (int cv = lane; cv < vecs; cv += lanes) {
      const T* chan = plane + cv * VEC;
      typedef D2tChannels<T, VEC> Ch;
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
      // one sample's four taps, added in the plain version's order
      auto add_sample = [&](const D2tAxisEntry& ya, const D2tAxisEntry& xa, const typename Ch::Raw (&raw)[4]) {
        const float fy = ya.frac, wy0 = 1.0f - fy;
        const float fx = xa.frac, wx0 = 1.0f - fx;
        float v00[VEC], v01[VEC], v10[VEC], v11[VEC];
        Ch::unpack(raw[0], v00);
        Ch::unpack(raw[1], v01);
        Ch::unpack(raw[2], v10);
        Ch::unpack(raw[3], v11);
        const float w00 = wy0 * wx0, w01 = wy0 * fx, w10 = fy * wx0, w11 = fy * fx;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          acc[i] += v00[i] * w00 + v01[i] * w01 + v10[i] * w10 + v11[i] * w11;
        }
      };
      auto load_sample = [&](const D2tAxisEntry& ya, const D2tAxisEntry& xa, typename Ch::Raw (&raw)[4]) {
        const T* row_lo = chan + (size_t)ya.lo * W * C;
        const T* row_hi = chan + (size_t)ya.hi * W * C;
        raw[0] = Ch::load(row_lo + (size_t)xa.lo * C);
        raw[1] = Ch::load(row_lo + (size_t)xa.hi * C);
        raw[2] = Ch::load(row_hi + (size_t)xa.lo * C);
        raw[3] = Ch::load(row_hi + (size_t)xa.hi * C);
      };
      for (int iy = 0; iy < s; ++iy) {
        const D2tAxisEntry ya = ytab[py * s + iy];
        if (!ya.inside) continue;
        for (int ix = 0; ix < s; ++ix) {
          const D2tAxisEntry xa = xtab[px * s + ix];
          if (!xa.inside) continue;
          typename Ch::Raw raw[4];
          load_sample(ya, xa, raw);
          add_sample(ya, xa, raw);
        }
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = acc[i] / count;
      D2tChannels<T, VEC>::store(out + (((size_t)r * ph + py) * pw + px) * C + cv * VEC, acc);
    }
  }
}

template <typename T, int VEC>
int d2t_launch_fwd(const D2tLevels& lv, const float* boxes, const int* batch_idx,
                          const int* level_idx, void* out, int R, int C, int ph, int pw, int s,
                          int aligned, cudaStream_t st) {
  // enough blocks for a small pool: a roi's output rows split over `parts` blocks
  int parts = (4096 + R - 1) / R;
  parts = parts < 1 ? 1 : (parts > ph ? ph : parts);
  const size_t smem = (size_t)(ph + pw) * s * sizeof(D2tAxisEntry);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)R, (unsigned)parts);
  d2t_roi_align_fwd_kernel<T, VEC><<<grid, D2T_FWD_THREADS, smem, st>>>(
      lv, boxes, batch_idx, level_idx, (T*)out, C, ph, pw, s, aligned);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. Writes the path taken to *path: 1 when a
// thread moves 16 bytes of channels at a time (C a multiple of 16 bytes and
// every level and the output 16-byte aligned), 0 for the one-channel path.
// Returns cudaGetLastError() after the launch.
extern "C" int d2t_roi_align_fwd(const D2tLevels* levels, const float* boxes,
                                 const int* batch_idx, const int* level_idx, void* out, int R,
                                 int C, int ph, int pw, int sampling_ratio, int aligned, int dtype,
                                 void* stream, int* path) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int vec = dtype == 0 ? 4 : 8;
  bool wide = C % vec == 0 && ((uintptr_t)out & 15) == 0;
  for (int i = 0; i < levels->num_levels; ++i) wide = wide && ((uintptr_t)levels->ptr[i] & 15) == 0;
  if (path != nullptr) *path = wide ? 1 : 0;
  if (R == 0) return 0;
  const int s = sampling_ratio > 0 ? sampling_ratio : 2;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    return wide ? d2t_launch_fwd<float, 4>(*levels, boxes, batch_idx, level_idx, out, R, C, ph, pw, s, aligned, st)
                : d2t_launch_fwd<float, 1>(*levels, boxes, batch_idx, level_idx, out, R, C, ph, pw, s, aligned, st);
  }
  return wide ? d2t_launch_fwd<__nv_bfloat16, 8>(*levels, boxes, batch_idx, level_idx, out, R, C, ph, pw, s, aligned, st)
              : d2t_launch_fwd<__nv_bfloat16, 1>(*levels, boxes, batch_idx, level_idx, out, R, C, ph, pw, s, aligned, st);
}

// ---------------------------------------------------------------- backward
//
// Replaces the TPU kernel `roi_align_pallas_backward`
// (detectron2_tpu/ops/pallas/roi_align_pallas.py:521, body `_make_bwd_kernel`).
// It is the exact adjoint, in the features, of the forward above (and so of
// `_roi_align_multilevel_xla`), not of the TPU kernel's clamped [48,64]
// window: each inside sample of bin (py, px) adds g[r, py, px, c] / s^2 times
// its four bilinear weights -- the forward's (1-fy)(1-fx), (1-fy)fx,
// fy(1-fx), fy.fx -- to its four taps. Boxes and indices get no gradient.
//
// The TPU kernel builds each roi's gradient window in VMEM and
// read-modify-writes it into the level plane; its grid runs in order, so
// overlapping windows do not race. Blocks here run in no order, so this is
// a gather over output tiles that writes the gradient once, in its dtype,
// with no float32 accumulator in device memory and no atomics:
//  1. prep: one warp per roi writes its axis table (d2t_axis_entry, the
//     forward's code: {lo, hi, frac, inside} of each sample row, then each
//     sample column), the rectangle of pixels its inside samples tap and
//     its plane (level * B + image);
//  2. bin: each (image, level) plane is cut into D2T_TILE x D2T_TILE pixel
//     tiles; one warp per tile walks the rois in order, tests their
//     rectangles 32 at a time and appends hits with __ballot_sync/__popc:
//     one pass counts, a one-block scan (d2t_bwd_scan_kernel) turns the
//     counts into offsets, a second pass fills the lists, in roi order;
//  3. accumulate: a warp owns one pixel row of D2T_BWD_COLS columns of a
//     tile and 32 channel words (8 bf16 or 4 float32 channels a lane, or one
//     channel on the scalar path), in float32 registers. It takes the
//     tile's list 32 rois at a time, keeps those whose rectangle meets its
//     pixels and fetches each kept roi's table entries while the one before
//     is added. Per roi: a ballot finds the sample rows that tap its row and
//     their bins go, with their weights wy, to a warp-private list in shared
//     memory; a ballot finds the sample columns that tap its columns, and
//     every cotangent word those bins will need is prefetched into L1; then
//     for each x bin in order, its weight at each column (the taps' (1 - f)
//     then f, in sample order, over s^2) from the bin's samples by shuffles,
//     and for each y bin of the list in order one 16-byte cotangent load
//     (512 contiguous bytes a warp), D2T_BWD_LOADS in flight, added with a
//     fused multiply-add to every column the x bin taps. Every (pixel,
//     channel) has one owner and every float32 sum one order, so the result
//     is bitwise reproducible. Against the plain version (index_add_ of
//     each sample's term) the order differs and each bin's sample weights
//     are summed first: within 1e-5 of the sum of |terms|;
//  4. the warp writes its pixels once, zeros included, as 16-byte stores in
//     the gradient's dtype: no memset, no cast pass.
// C that is not whole 16-byte words, or a pointer that is not 16-byte
// aligned, takes the same kernels one channel per lane.
//
// What bounds it on the card: bytes. The gradient over every level is
// written once (0.366 GB in bf16 at the R50-FPN train step, 8 images at
// 800x1344, C = 256) and the cotangent read once (0.103 GB a pool): 0.14 ms
// at 3.35 TB/s. The design adds the cotangent reread by every block a roi
// meets (from L2, mostly) and the tables and lists (a few MB). What holds it
// back is neither: a build that skipped the rois ran at about the write
// bound, and one whose cotangent loads all hit one address was not much
// faster than this one. The per-roi work of each warp (ballots, shuffles,
// the bins' weights, the terms) is the cost; 3 blocks an SM (80 registers)
// and 2 loads in flight were the best of 2-4 and 2-4. Rois stacked on a few
// pixels (the all-zero rows that pad a batch) put all their terms on the
// one or two warps that own those pixels.
//
// Tried and dropped (edited copies of this file built on the card; PERF.md
// has the times chip_smoke.py took of the last two): the first design, a float32
// accumulator over all levels zeroed with cudaMemsetAsync, four float32
// atomicAdd per inside sample and channel (0.82e9 a pool) and a cast pass
// (its accumulator alone moved 2.0 and 1.7 GB a pool, and its sums changed
// order from run to run); one bin walk per tile that tested every roi's
// level, image and rectangle one after another (now the plane first, four
// groups of 32 rois' loads at once); per-term weights computed inside the
// y-bin loop, one dependent load at a time (a pile of padded rows then
// cost more than all the other rois together); per-column x-bin lists in
// shared memory (two ballots a column, each warp); 8 and 16 columns a warp,
// 32x32 tiles; one loop for the x weights at every s (3-4% slower at
// s = 2); that loop with s left to run time (15-30% slower again).

constexpr int D2T_TILE = 16;          // list tiles: D2T_TILE x D2T_TILE pixels of one plane
constexpr int D2T_BWD_WARPS = 8;      // warps of an accumulating block, one pixel row each
constexpr int D2T_BWD_COLS = 4;       // pixel columns a warp owns
constexpr int D2T_BWD_LOADS = 2;      // cotangent words a lane has in flight
constexpr int D2T_BWD_MIN_BLOCKS = 3; // accumulating blocks an SM holds (caps the registers at 80)
constexpr unsigned D2T_FULL = 0xffffffffu;
constexpr int D2T_INT_MAX = 0x7fffffff;
constexpr int D2T_BINS = 33;  // bins within a chunk of 32 samples, at most

__host__ __device__ __forceinline__ int d2t_tiles_of_plane(int H, int W) {
  return ((H + D2T_TILE - 1) / D2T_TILE) * ((W + D2T_TILE - 1) / D2T_TILE);
}

// Tile t of all planes, level-major, then image, tile row, tile column.
__device__ __forceinline__ void d2t_tile_of(const D2tLevels& lv, int B, int t, int* l, int* b, int* ty, int* tx) {
  int i = 0;
  for (; i < lv.num_levels - 1; ++i) {
    const int n = B * d2t_tiles_of_plane(lv.H[i], lv.W[i]);
    if (t < n) break;
    t -= n;
  }
  const int tiles_x = (lv.W[i] + D2T_TILE - 1) / D2T_TILE;
  const int per_image = d2t_tiles_of_plane(lv.H[i], lv.W[i]);
  *l = i;
  *b = t / per_image;
  t -= *b * per_image;
  *ty = t / tiles_x;
  *tx = t - *ty * tiles_x;
}

// 1. One warp per roi: its axis table, entry k as an int4 {lo, hi, frac
// bits, inside}; {ymin, ymax, xmin, xmax} of the pixels its inside samples
// tap; and its plane, level * B + image, or -1 when no sample is inside.
__global__ void d2t_bwd_prep_kernel(D2tLevels lv, int B, const float* __restrict__ boxes,
                                    const int* __restrict__ batch_idx, const int* __restrict__ levels,
                                    int4* __restrict__ tab, int4* __restrict__ foot, int* __restrict__ plane, int R,
                                    int ph, int pw, int s, int aligned) {
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  const int l = levels[r];
  const int H = lv.H[l], W = lv.W[l];
  const D2tRoiGrid grid = d2t_roi_grid(boxes, r, lv.scale[l], aligned, ph, pw);
  const int ny = ph * s, nt = ny + pw * s;
  int ymin = D2T_INT_MAX, ymax = -D2T_INT_MAX, xmin = D2T_INT_MAX, xmax = -D2T_INT_MAX;
  for (int k = lane; k < nt; k += 32) {
    const D2tAxisEntry e = d2t_axis_entry(grid, k, ny, s, H, W);
    tab[(size_t)r * nt + k] = make_int4(e.lo, e.hi, __float_as_int(e.frac), e.inside);
    if (e.inside && k < ny) {
      ymin = min(ymin, e.lo);
      ymax = max(ymax, e.hi);
    } else if (e.inside) {
      xmin = min(xmin, e.lo);
      xmax = max(xmax, e.hi);
    }
  }
  ymin = __reduce_min_sync(D2T_FULL, ymin);
  ymax = __reduce_max_sync(D2T_FULL, ymax);
  xmin = __reduce_min_sync(D2T_FULL, xmin);
  xmax = __reduce_max_sync(D2T_FULL, xmax);
  if (lane == 0) {
    foot[r] = make_int4(ymin, ymax, xmin, xmax);
    plane[r] = ymin <= ymax && xmin <= xmax ? l * B + batch_idx[r] : -1;
  }
}

// 2. One warp per tile: the rois whose rectangle meets it, in roi order;
// counted (FILL false) or written from offsets[t] on (FILL true). Four
// groups of 32 rois' planes are loaded before any is tested.
template <bool FILL>
__global__ void d2t_bwd_bin_kernel(D2tLevels lv, int B, const int* __restrict__ plane,
                                   const int4* __restrict__ foot, int* __restrict__ counts,
                                   const int* __restrict__ offsets, int* __restrict__ lists, int R, int tiles) {
  const int t = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= tiles) return;
  int l, b, ty, tx;
  d2t_tile_of(lv, B, t, &l, &b, &ty, &tx);
  const int mine = l * B + b;
  const int y0 = ty * D2T_TILE, x0 = tx * D2T_TILE;
  const int y1 = y0 + D2T_TILE - 1, x1 = x0 + D2T_TILE - 1;
  int* list = FILL ? lists + offsets[t] : nullptr;
  int n = 0;
  for (int r0 = 0; r0 < R; r0 += 128) {
    int p[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + 32 * u + lane;
      p[u] = r < R ? __ldg(plane + r) : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + 32 * u + lane;
      bool hit = false;
      if (p[u] == mine) {
        const int4 f = __ldg(foot + r);
        hit = f.x <= y1 && f.y >= y0 && f.z <= x1 && f.w >= x0;
      }
      const unsigned m = __ballot_sync(D2T_FULL, hit);
      if (FILL && hit) list[n + __popc(m & ((1u << lane) - 1u))] = r;
      n += __popc(m);
    }
  }
  if (!FILL && lane == 0) counts[t] = n;
}

// Exclusive scan of the tile counts in one block: offsets[0..tiles].
__global__ void __launch_bounds__(1024) d2t_bwd_scan_kernel(const int* __restrict__ counts,
                                                            int* __restrict__ offsets, int tiles) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int carry = 0;
  for (int base = 0; base < tiles; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < tiles ? counts[i] : 0;
    int x = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(D2T_FULL, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < warps ? warp_sums[lane] : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(D2T_FULL, w, d);
        if (lane >= d) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    if (i < tiles) offsets[i] = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    carry += warp_sums[warps - 1];
    __syncthreads();  // the next chunk rewrites warp_sums
  }
  if (threadIdx.x == 0) offsets[tiles] = carry;
}

// Bits [first, first + s) of a 32-sample chunk, clipped to it: the samples
// of one bin.
__device__ __forceinline__ unsigned d2t_bin_bits(int first, int s) {
  const int a = max(first, 0), e = min(first + s, 32);
  const unsigned upto = e >= 32 ? D2T_FULL : ((1u << e) - 1u);
  return upto & ~((1u << a) - 1u);
}

// One axis's weight of a bin's samples at one pixel: the lower-tap weights
// (1 - frac) of the samples in `lo`, then the upper-tap weights (frac) of
// those in `hi`, in sample order; lane k holds sample k's frac. The masks
// are the same in every lane.
__device__ __forceinline__ float d2t_axis_weight(unsigned lo, unsigned hi, float frac) {
  float w = 0.0f;
  while (lo) {
    const int k = __ffs(lo) - 1;
    lo &= lo - 1u;
    w += 1.0f - __shfl_sync(D2T_FULL, frac, k);
  }
  while (hi) {
    const int k = __ffs(hi) - 1;
    hi &= hi - 1u;
    w += __shfl_sync(D2T_FULL, frac, k);
  }
  return w;
}

// One y bin of a roi at a warp's pixel row: the offset of its cotangent
// row, by * pw * C, and its weight wy.
struct D2tYBin {
  int offset;
  float w;
};

// Roi r's share of a warp's pixels (3), sample rows and columns in chunks of
// 32 (SS: s when it is a compile-time constant, else 0). The y bins that tap
// the warp's row go to its shared list `yb`; then for each x bin that taps
// one of its columns, in order, the bin's weight at every column
// (wx / s^2), and for each y bin of the list, in order, one cotangent word
// (D2T_BWD_LOADS loads at a time), added to every column the bin taps with weight
// wy * (wx / s^2). ye0 / xe0: this lane's entry of the first chunks,
// fetched ahead by the caller.
template <typename T, int VEC, int COLS, int SS>
__device__ __forceinline__ void d2t_bwd_roi(const int4* __restrict__ e, int4 ye0, int4 xe0,
                                            const T* __restrict__ groi, D2tYBin* yb, float (&acc)[COLS][VEC],
                                            bool has_c, int Y, int X0, int C, int pw, int s_arg, int ny, int nx,
                                            float count) {
  typedef D2tChannels<T, VEC> Ch;
  const int s = SS > 0 ? SS : s_arg;
  const int lane = threadIdx.x & 31;
  for (int yc = 0; yc < ny; yc += 32) {
    const int4 ye = yc == 0 ? ye0 : (yc + lane < ny ? __ldg(e + yc + lane) : make_int4(0, 0, 0, 0));
    const unsigned ylo = __ballot_sync(D2T_FULL, ye.w && ye.x == Y);
    const unsigned yhi = __ballot_sync(D2T_FULL, ye.w && ye.y == Y);
    if ((ylo | yhi) == 0u) continue;
    const float yfrac = __int_as_float(ye.z);
    int nyb = 0;
    for (unsigned ym = ylo | yhi; ym;) {
      const int by = (yc + __ffs(ym) - 1) / s;
      const unsigned bm = d2t_bin_bits(by * s - yc, s);
      ym &= ~bm;
      const float wy = d2t_axis_weight(ylo & bm, yhi & bm, yfrac);
      if (lane == 0) yb[nyb] = D2tYBin{by * pw * C, wy};
      ++nyb;
    }
    __syncwarp();
    for (int xc = 0; xc < nx; xc += 32) {
      const int4 xe = xc == 0 ? xe0 : (xc + lane < nx ? __ldg(e + ny + xc + lane) : make_int4(0, 0, 0, 0));
      const int dlo = xe.w ? xe.x - X0 : -1, dhi = xe.w ? xe.y - X0 : -1;
      const float xfrac = __int_as_float(xe.z);
      unsigned xm = __ballot_sync(D2T_FULL, (unsigned)dlo < (unsigned)COLS || (unsigned)dhi < (unsigned)COLS);
      if (has_c) {
        // every cotangent word the loop below reads, requested at once: the
        // loads then wait for one round trip, not one per bin
        for (unsigned m = xm; m;) {
          const int bx = (xc + __ffs(m) - 1) / s;
          m &= ~d2t_bin_bits(bx * s - xc, s);
          for (int k = 0; k < nyb; ++k) {
            asm volatile("prefetch.global.L1 [%0];" ::"l"(groi + (size_t)bx * C + yb[k].offset));
          }
        }
      }
      while (xm) {
        const int bx = (xc + __ffs(xm) - 1) / s;
        const int first = bx * s - xc;
        xm &= ~d2t_bin_bits(first, s);
        // the bin's weight at each column: lower taps, then upper taps, in
        // sample order
        float wx[COLS];
        unsigned hit = 0u;
#pragma unroll
        for (int j = 0; j < COLS; ++j) wx[j] = 0.0f;
        // Two forms of the same sums in the same order. With s known at
        // compile time each sample's taps and fraction are shuffled once,
        // into registers (3 shuffles a sample, not 4): at s = 2 that measured
        // 3-4% faster than the one loop below unrolled (PERF.md).
        if (SS > 0) {
          int dl[SS > 0 ? SS : 1], dh[SS > 0 ? SS : 1];
          float f[SS > 0 ? SS : 1];
#pragma unroll
          for (int i = 0; i < SS; ++i) {
            const int src = min(max(first + i, 0), 31);
            const bool in_chunk = first + i >= 0 && first + i < 32;
            dl[i] = in_chunk ? __shfl_sync(D2T_FULL, dlo, src) : -1;
            dh[i] = in_chunk ? __shfl_sync(D2T_FULL, dhi, src) : -1;
            f[i] = __shfl_sync(D2T_FULL, xfrac, src);
          }
#pragma unroll
          for (int part = 0; part < 2; ++part) {
#pragma unroll
            for (int i = 0; i < SS; ++i) {
#pragma unroll
              for (int j = 0; j < COLS; ++j) {
                if ((part ? dh[i] : dl[i]) == j) {
                  wx[j] += part ? f[i] : 1.0f - f[i];
                  hit |= 1u << j;
                }
              }
            }
          }
        } else {
#pragma unroll
          for (int part = 0; part < 2; ++part) {
            for (int i = 0; i < s; ++i) {
              const int src = first + i;
              if (src < 0 || src > 31) continue;
              const int d = __shfl_sync(D2T_FULL, part ? dhi : dlo, src);
              const float f = __shfl_sync(D2T_FULL, xfrac, src);
#pragma unroll
              for (int j = 0; j < COLS; ++j) {
                if (d == j) {
                  wx[j] += part ? f : 1.0f - f;
                  hit |= 1u << j;
                }
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < COLS; ++j) wx[j] = SS == 2 ? wx[j] * 0.25f : wx[j] / count;
        const T* gcol = groi + (size_t)bx * C;
        auto add = [&](const typename Ch::Raw& raw, float wy) {
          float v[VEC];
          Ch::unpack(raw, v);
#pragma unroll
          for (int j = 0; j < COLS; ++j) {
            if (hit & (1u << j)) {
              const float w = wy * wx[j];
#pragma unroll
              for (int i = 0; i < VEC; ++i) acc[j][i] = __fmaf_rn(v[i], w, acc[j][i]);
            }
          }
        };
        int k = 0;
        for (; k + D2T_BWD_LOADS <= nyb; k += D2T_BWD_LOADS) {
          typename Ch::Raw raw[D2T_BWD_LOADS];
          float wy[D2T_BWD_LOADS];
#pragma unroll
          for (int u = 0; u < D2T_BWD_LOADS; ++u) {
            const D2tYBin q = yb[k + u];
            wy[u] = q.w;
            if (has_c) raw[u] = Ch::load(gcol + q.offset);
          }
          if (has_c) {
#pragma unroll
            for (int u = 0; u < D2T_BWD_LOADS; ++u) add(raw[u], wy[u]);
          }
        }
        for (; k < nyb; ++k) {
          const D2tYBin q = yb[k];
          if (has_c) add(Ch::load(gcol + q.offset), q.w);
        }
      }
    }
    __syncwarp();  // the next chunk rewrites yb
  }
}

// 3-4. Block (tile, channel group, part): warp w owns pixel row
// ty * D2T_TILE + (part / parts_x) * D2T_BWD_WARPS + w, columns
// tx * D2T_TILE + (part % parts_x) * COLS + [0, COLS), and channel words
// group * 32 + lane. It takes the tile's list 32 rois at a time, keeps
// those whose rectangle meets its pixels, and fetches each kept roi's table
// entries while the one before is added.
template <typename T, int VEC, int COLS, int SS>
__global__ void __launch_bounds__(D2T_BWD_WARPS * 32, D2T_BWD_MIN_BLOCKS)
    d2t_roi_align_bwd_kernel(D2tLevels lv, int B, const int4* __restrict__ tab, const int4* __restrict__ foot,
                             const int* __restrict__ offsets, const int* __restrict__ lists,
                             const T* __restrict__ grad, T* __restrict__ out, int C, int ph, int pw, int s) {
  __shared__ D2tYBin ybins[D2T_BWD_WARPS][D2T_BINS];
  constexpr int PARTS_X = D2T_TILE / COLS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x;
  int l, b, ty, tx;
  d2t_tile_of(lv, B, t, &l, &b, &ty, &tx);
  const int H = lv.H[l], W = lv.W[l];
  const int Y = ty * D2T_TILE + (int)(blockIdx.z / PARTS_X) * D2T_BWD_WARPS + warp;
  const int X0 = tx * D2T_TILE + (int)(blockIdx.z % PARTS_X) * COLS;
  if (Y >= H || X0 >= W) return;
  const int cv = blockIdx.y * 32 + lane;
  const bool has_c = cv < C / VEC;
  const int ny = ph * s, nx = pw * s, nt = ny + nx;
  const float count = (float)(s * s);

  float acc[COLS][VEC];
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[j][i] = 0.0f;
  }

  const int4 zero = make_int4(0, 0, 0, 0);
  const int end = offsets[t + 1];
  for (int n0 = offsets[t]; n0 < end; n0 += 32) {
    const int rl = n0 + lane < end ? lists[n0 + lane] : -1;
    bool hit = false;
    if (rl >= 0) {
      const int4 f = __ldg(foot + rl);
      hit = f.x <= Y && f.y >= Y && f.z <= X0 + COLS - 1 && f.w >= X0;
    }
    unsigned todo = __ballot_sync(D2T_FULL, hit);
    int r = 0;
    int4 ye = zero, xe = zero;
    if (todo) {
      r = __shfl_sync(D2T_FULL, rl, __ffs(todo) - 1);
      const int4* e = tab + (size_t)r * nt;
      ye = lane < ny ? __ldg(e + lane) : zero;
      xe = lane < nx ? __ldg(e + ny + lane) : zero;
    }
    while (todo) {
      const int cur = r;
      const int4 cy = ye, cx = xe;
      todo &= todo - 1u;
      if (todo) {
        r = __shfl_sync(D2T_FULL, rl, __ffs(todo) - 1);
        const int4* e = tab + (size_t)r * nt;
        ye = lane < ny ? __ldg(e + lane) : zero;
        xe = lane < nx ? __ldg(e + ny + lane) : zero;
      }
      d2t_bwd_roi<T, VEC, COLS, SS>(tab + (size_t)cur * nt, cy, cx,
                                    grad + (size_t)cur * ph * pw * C + (size_t)cv * VEC, ybins[warp], acc, has_c, Y,
                                    X0, C, pw, s, ny, nx, count);
    }
  }
  if (!has_c) return;
  T* row = out + ((size_t)lv.row_base[l] + ((size_t)b * H + Y) * W) * C + (size_t)cv * VEC;
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    if (X0 + j < W) D2tChannels<T, VEC>::store(row + (size_t)(X0 + j) * C, acc[j]);
  }
}

// The int32 scratch of one backward call: the axis tables, the rectangles,
// the tile counts, the offsets and the lists (a roi meets at most every
// tile of its plane). Offsets in ints into one buffer; returns the total.
static long long d2t_bwd_layout(const D2tLevels& lv, int B, int R, int ph, int pw, int s, long long* tiles,
                                long long off[6]) {
  long long t = 0;
  int per_plane = 0;
  for (int i = 0; i < lv.num_levels; ++i) {
    const int n = d2t_tiles_of_plane(lv.H[i], lv.W[i]);
    per_plane = n > per_plane ? n : per_plane;
    t += (long long)B * n;
  }
  *tiles = t;
  long long at = 0;
  off[0] = at;  // axis tables, int4 [R, (ph + pw) * s]
  at += (long long)R * (ph + pw) * s * 4;
  off[1] = at;  // rectangles, int4 [R]
  at += (long long)R * 4;
  off[5] = at;  // planes [R]
  at += R;
  off[2] = at;  // counts [tiles]
  at += t;
  off[3] = at;  // offsets [tiles + 1]
  at += t + 1;
  off[4] = at;  // lists
  at += (long long)R * per_plane;
  return at;
}

template <typename T, int VEC>
int d2t_launch_bwd(const D2tLevels& lv, int B, const float* boxes, const int* batch_idx, const int* level_idx,
                   const void* grad, void* out, int* scratch, int R, int C, int ph, int pw, int s, int aligned,
                   cudaStream_t st) {
  long long tiles, off[6];
  const long long total = d2t_bwd_layout(lv, B, R, ph, pw, s, &tiles, off);
  if (tiles == 0) return 0;  // no pixel to write
  if (tiles >= (long long)D2T_INT_MAX || total >= (long long)D2T_INT_MAX) return (int)cudaErrorInvalidValue;
  int4* tab = reinterpret_cast<int4*>(scratch + off[0]);
  int4* foot = reinterpret_cast<int4*>(scratch + off[1]);
  int* counts = scratch + off[2];
  int* offsets = scratch + off[3];
  int* lists = scratch + off[4];
  int* plane = scratch + off[5];
  const int n = (int)tiles;
  if (R > 0) {
    d2t_bwd_prep_kernel<<<(R + 7) / 8, 256, 0, st>>>(lv, B, boxes, batch_idx, level_idx, tab, foot, plane, R, ph,
                                                     pw, s, aligned);
  }
  const unsigned tile_blocks = (unsigned)((n + 7) / 8);
  d2t_bwd_bin_kernel<false><<<tile_blocks, 256, 0, st>>>(lv, B, plane, foot, counts, offsets, lists, R, n);
  d2t_bwd_scan_kernel<<<1, 1024, 0, st>>>(counts, offsets, n);
  d2t_bwd_bin_kernel<true><<<tile_blocks, 256, 0, st>>>(lv, B, plane, foot, counts, offsets, lists, R, n);
  const dim3 grid((unsigned)n, (unsigned)((C / VEC + 31) / 32),
                  (unsigned)((D2T_TILE / D2T_BWD_WARPS) * (D2T_TILE / D2T_BWD_COLS)));
  if (s == 2) {
    d2t_roi_align_bwd_kernel<T, VEC, D2T_BWD_COLS, 2><<<grid, D2T_BWD_WARPS * 32, 0, st>>>(
        lv, B, tab, foot, offsets, lists, (const T*)grad, (T*)out, C, ph, pw, s);
  } else {
    d2t_roi_align_bwd_kernel<T, VEC, D2T_BWD_COLS, 0><<<grid, D2T_BWD_WARPS * 32, 0, st>>>(
        lv, B, tab, foot, offsets, lists, (const T*)grad, (T*)out, C, ph, pw, s);
  }
  return (int)cudaGetLastError();
}

// The int32 scratch, in elements, that d2t_roi_align_bwd needs.
extern "C" long long d2t_roi_align_bwd_scratch(const D2tLevels* levels, int B, int R, int ph, int pw,
                                               int sampling_ratio) {
  long long tiles, off[6];
  return d2t_bwd_layout(*levels, B, R, ph, pw, sampling_ratio > 0 ? sampling_ratio : 2, &tiles, off);
}

// grad: [R, ph, pw, C] in `dtype` (0 = float32, 1 = bfloat16); out: the
// levels' gradients flattened as [sum_l B*H_l*W_l, C] in `dtype`, every
// element written here; scratch: d2t_roi_align_bwd_scratch(...) int32,
// 16-byte aligned. Writes the path taken to *path (1: 16 bytes of channels
// a lane, C a multiple of 16 bytes and grad and out 16-byte aligned; 0: one
// channel). Returns cudaGetLastError() after the launches.
extern "C" int d2t_roi_align_bwd(const D2tLevels* levels, int B, const float* boxes, const int* batch_idx,
                                 const int* level_idx, const void* grad, void* out, int* scratch, int R, int C,
                                 int ph, int pw, int sampling_ratio, int aligned, int dtype, void* stream,
                                 int* path) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int vec = dtype == 0 ? 4 : 8;
  const bool wide = C % vec == 0 && ((uintptr_t)out & 15) == 0 && ((uintptr_t)grad & 15) == 0;
  if (path != nullptr) *path = wide ? 1 : 0;
  const int s = sampling_ratio > 0 ? sampling_ratio : 2;
  cudaStream_t st = (cudaStream_t)stream;
  const D2tLevels& lv = *levels;
  if (dtype == 0) {
    return wide ? d2t_launch_bwd<float, 4>(lv, B, boxes, batch_idx, level_idx, grad, out, scratch, R, C, ph, pw, s, aligned, st)
                : d2t_launch_bwd<float, 1>(lv, B, boxes, batch_idx, level_idx, grad, out, scratch, R, C, ph, pw, s, aligned, st);
  }
  return wide ? d2t_launch_bwd<__nv_bfloat16, 8>(lv, B, boxes, batch_idx, level_idx, grad, out, scratch, R, C, ph, pw, s, aligned, st)
              : d2t_launch_bwd<__nv_bfloat16, 1>(lv, B, boxes, batch_idx, level_idx, grad, out, scratch, R, C, ph, pw, s, aligned, st);
}
