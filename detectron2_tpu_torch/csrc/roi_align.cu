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
  const float bin_h = roi_h / (float)ph;
  const float bin_w = roi_w / (float)pw;
  const float count = (float)(s * s);

  // each sample row's and column's taps, once per roi, with the very
  // expressions of the plain version in their order
  const int ny = ph * s, nx = pw * s;
  for (int i = threadIdx.x; i < ny + nx; i += blockDim.x) {
    const bool is_y = i < ny;
    const int k = is_y ? i : i - ny;
    const int bin = k / s, sub = k - bin * s;
    const float coord = (is_y ? y0 : x0) + ((float)bin + ((float)sub + 0.5f) / (float)s) * (is_y ? bin_h : bin_w);
    D2tAxisEntry e;
    bool inside;
    d2t_axis(coord, is_y ? H : W, &e.lo, &e.hi, &e.frac, &inside);
    e.inside = inside ? 1 : 0;
    (is_y ? ytab : xtab)[k] = e;
  }
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
// window: no window, no small/big split, no channel chunks. Each inside
// sample of bin (py, px) adds g[r, py, px, c] / s^2 times its four bilinear
// weights -- the very products (wy * wx) the forward multiplies by -- to its
// four taps. Boxes, batch and level indices get no gradient.
//
// Design: the levels' gradients live in one float32 accumulator flattened
// as [sum_l B*H_l*W_l, C] (the plain version's layout, ops/roi_align.py),
// zeroed first; one block per (roi, output row) and one thread per channel,
// as the forward; each sample scatters its four weighted taps with
// float32 atomicAdd. Rows are C contiguous floats, so a warp's 32 atomics
// hit 32 neighbouring words and coalesce. A bfloat16 gradient is one
// rounding of the float32 sum, done by a last pass over the accumulator;
// a float32 gradient is the accumulator itself.
//
// What bounds it on the card: memory traffic and atomic throughput. At the
// Mask R-CNN R50-FPN train step (8 images at 800x1344, C=256, box pool 4096
// rois at 7x7, mask pool 1024 rois at 14x14, s=2) each pool issues about
// 4096*49*16*256 = 0.82e9 (box) and 1024*196*16*256 = 0.82e9 (mask) atomic
// adds, while zeroing and casting the 0.73 GB accumulator moves about
// 1.8 GB; the arithmetic is negligible.
//
// The atomics make the order of each float32 sum change from run to run, so
// the result is not bitwise reproducible; each element is within
// 1e-5 * (the same sum over |g|) of the exact one. A deterministic
// (sorted or segmented) design, shared-memory pre-reduction of the taps a
// block shares, and vector atomics (red.global.add.v4.f32) are later work.

template <typename T>
__global__ void d2t_roi_align_bwd_kernel(D2tLevels lv, const float* __restrict__ boxes,
                                         const int* __restrict__ batch_idx,
                                         const int* __restrict__ levels,
                                         const T* __restrict__ grad, float* __restrict__ acc,
                                         int C, int ph, int pw, int s, int aligned) {
  const int r = blockIdx.x;
  const int py = blockIdx.y;
  const int l = levels[r];
  const int b = batch_idx[r];
  const int H = lv.H[l];
  const int W = lv.W[l];
  const float scale = lv.scale[l];
  float* plane = acc + ((size_t)lv.row_base[l] + (size_t)b * H * W) * C;

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
  const float bin_h = roi_h / (float)ph;
  const float bin_w = roi_w / (float)pw;
  const float count = (float)(s * s);

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    for (int px = 0; px < pw; ++px) {
      const float g = d2t_load(grad + (((size_t)r * ph + py) * pw + px) * C + c) / count;
      for (int iy = 0; iy < s; ++iy) {
        const float y = y0 + ((float)py + ((float)iy + 0.5f) / (float)s) * bin_h;
        int ylo, yhi;
        float fy;
        bool yin;
        d2t_axis(y, H, &ylo, &yhi, &fy, &yin);
        for (int ix = 0; ix < s; ++ix) {
          const float x = x0 + ((float)px + ((float)ix + 0.5f) / (float)s) * bin_w;
          int xlo, xhi;
          float fx;
          bool xin;
          d2t_axis(x, W, &xlo, &xhi, &fx, &xin);
          if (!(yin && xin)) continue;
          const float wy0 = 1.0f - fy, wx0 = 1.0f - fx;
          atomicAdd(plane + ((size_t)ylo * W + xlo) * C + c, g * (wy0 * wx0));
          atomicAdd(plane + ((size_t)ylo * W + xhi) * C + c, g * (wy0 * fx));
          atomicAdd(plane + ((size_t)yhi * W + xlo) * C + c, g * (fy * wx0));
          atomicAdd(plane + ((size_t)yhi * W + xhi) * C + c, g * (fy * fx));
        }
      }
    }
  }
}

__global__ void d2t_f32_to_bf16_kernel(const float* __restrict__ in, __nv_bfloat16* __restrict__ out,
                                       size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    out[i] = __float2bfloat16_rn(in[i]);
  }
}

// grad: [R, ph, pw, C] in `dtype` (0 = float32, 1 = bfloat16); acc: float32
// [total_rows, C] scratch, zeroed here; out: [total_rows, C] in `dtype`
// (the same buffer as acc for float32). Returns the first CUDA error.
extern "C" int d2t_roi_align_bwd(const D2tLevels* levels, const float* boxes,
                                 const int* batch_idx, const int* level_idx, const void* grad,
                                 float* acc, void* out, long long total_rows, int R, int C, int ph,
                                 int pw, int sampling_ratio, int aligned, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t n = (size_t)total_rows * C;
  cudaError_t err = cudaMemsetAsync(acc, 0, n * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  if (R > 0) {
    const int s = sampling_ratio > 0 ? sampling_ratio : 2;
    const int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
    dim3 grid((unsigned)R, (unsigned)ph);
    if (dtype == 0) {
      d2t_roi_align_bwd_kernel<float><<<grid, threads, 0, st>>>(
          *levels, boxes, batch_idx, level_idx, (const float*)grad, acc, C, ph, pw, s, aligned);
    } else {
      d2t_roi_align_bwd_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
          *levels, boxes, batch_idx, level_idx, (const __nv_bfloat16*)grad, acc, C, ph, pw, s,
          aligned);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (dtype == 1 && n > 0) {
    const size_t blocks = (n + 255) / 256;
    d2t_f32_to_bf16_kernel<<<(unsigned)(blocks < 65535 * 16 ? blocks : 65535 * 16), 256, 0, st>>>(
        acc, (__nv_bfloat16*)out, n);
  }
  return (int)cudaGetLastError();
}
