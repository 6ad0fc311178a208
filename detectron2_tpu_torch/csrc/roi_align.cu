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
// What bounds it on the card: memory bandwidth. At the Mask R-CNN R50-FPN
// batch of 16 images at 800x1344 the box pool writes 16000*49*256*2 B = 0.40 GB
// of bf16 output and the mask pool 1600*196*256*2 B = 0.16 GB; the roi
// footprints it reads span p2-p5, about 0.73 GB for all four levels. The
// arithmetic (about 10 flops per sample and channel) is far below the card's
// rate. The design answers that with layout alone: features are NHWC, so
// the four taps of a sample are four contiguous C-vectors and the threads of
// a block (one per channel) read each tap as one coalesced row; each output
// row of a roi is one block, so a roi's taps are reused through L1/L2 while
// its rows are in flight; accumulation is in f32 registers, and the output is
// written once in the feature dtype. Vectorised loads, shared-memory reuse
// of taps across bins and a persistent schedule are later work.
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

template <typename T>
__global__ void d2t_roi_align_fwd_kernel(D2tLevels lv, const float* __restrict__ boxes,
                                         const int* __restrict__ batch_idx,
                                         const int* __restrict__ levels, T* __restrict__ out,
                                         int C, int ph, int pw, int s, int aligned) {
  const int r = blockIdx.x;
  const int py = blockIdx.y;
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

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    for (int px = 0; px < pw; ++px) {
      float acc = 0.0f;
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
          const float v00 = d2t_load(plane + ((size_t)ylo * W + xlo) * C + c);
          const float v01 = d2t_load(plane + ((size_t)ylo * W + xhi) * C + c);
          const float v10 = d2t_load(plane + ((size_t)yhi * W + xlo) * C + c);
          const float v11 = d2t_load(plane + ((size_t)yhi * W + xhi) * C + c);
          acc += v00 * (wy0 * wx0) + v01 * (wy0 * fx) + v10 * (fy * wx0) + v11 * (fy * fx);
        }
      }
      d2t_store(out + (((size_t)r * ph + py) * pw + px) * C + c, acc / count);
    }
  }
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int d2t_roi_align_fwd(const D2tLevels* levels, const float* boxes,
                                 const int* batch_idx, const int* level_idx, void* out, int R,
                                 int C, int ph, int pw, int sampling_ratio, int aligned, int dtype,
                                 void* stream) {
  if (R == 0) return 0;
  const int s = sampling_ratio > 0 ? sampling_ratio : 2;
  const int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
  dim3 grid((unsigned)R, (unsigned)ph);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    d2t_roi_align_fwd_kernel<float><<<grid, threads, 0, st>>>(
        *levels, boxes, batch_idx, level_idx, (float*)out, C, ph, pw, s, aligned);
  } else if (dtype == 1) {
    d2t_roi_align_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        *levels, boxes, batch_idx, level_idx, (__nv_bfloat16*)out, C, ph, pw, s, aligned);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
