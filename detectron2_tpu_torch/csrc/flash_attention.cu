// Attention with a decomposed relative-position bias for Hopper (sm_90a),
// forward only, plain C interface for ctypes. Two entry points over one
// device code:
//
//   d2t_flash_attn_fwd    replaces the TPU kernel `flash_attention`
//                         (detectron2_tpu/ops/pallas/flash_attention.py:296,
//                         body `_kernel` :31): factors [B, S, Hk], [B, S, Wk];
//   d2t_flash_attn_fwd_t  replaces `flash_attention_v2_t` / `flash_attention_v2`
//                         (same file :189 / :260, body `_kernel_v2` :95):
//                         factors transposed, [B, Hk, S], [B, Wk, S].
//
// Both compute, for q, k, v [B, S, D] (B = batch * heads):
//
//   out[b, i] = sum_j softmax_j(scale * q[b, i] . k[b, j]
//                               + rel_h[b, i, j / Wk] + rel_w[b, i, j % Wk]) v[b, j]
//
// with Hk * Wk = S; without factors the bias is 0. The [S, S] scores never
// reach device memory. As in the TPU kernel, q is multiplied by `scale` in
// q's dtype, score and bias add in float32, the softmax runs in float32, the
// probabilities are cast to v's dtype before the second product when that
// runs on tensor cores, and the division by their sum comes last. S need not
// divide a tile: tail keys score -inf, tail queries are computed and not
// stored. The two entry points differ only in the strides they hand to the
// code that reads the factors.
//
// What the TPU kernel did for Mosaic's sake is not carried over as such: its
// 0/1 selection matmuls rebuild the bias tile because Mosaic cannot reshape
// or lane-slice in registers. Here the bias of key j is rel_h[i][j / Wk] +
// rel_w[i][j % Wk], fetched or, where that is cheaper, folded into the first
// product: cheaper in the window kernel below (32 more channels); at
// [96, 4096, 64] with Hk = Wk = 64 the wgmma kernel takes 1.29 ms with the
// bias folded (80 more channels a tile) against 1.13 ms with it added to the
// scores (NVIDIA H100 80GB HBM3, 700 W, `chip_smoke.py` phase 8), so shapes
// are dispatched to the latter and d2t_flash_attn_fwd_folded keeps the former
// for that comparison.
//
// What bounds it on the card: for the ViTDet-B global blocks ([96, 4096, 64],
// 4 * S^2 * D = 412 GFLOP a launch against 0.3 GB moved) the tensor cores and,
// at D = 64, the exponentials (one ex2 per score at 16 a clock and SM is as
// long as the two products); for the windowed blocks ([2400, 196, 64],
// 24 GFLOP against 0.27 GB) the memory.
//
// Four kernels; which one a launch takes depends on dtype and shape alone
// (choose_path below, the one statement of the table) and is reported to the
// caller:
//
//   wgmma       bfloat16, D = 64, S > 208 (or S <= 208 with Hk + Wk > 32):
//               128 queries a block, two consumer warpgroups of 64 queries and
//               a producer warp that keeps 128-key tiles of k and v in flight
//               with TMA (3-D tensor maps, 128-byte swizzle, a ring of 4
//               stages, full/empty mbarriers); q . k^T and p . v are
//               wgmma.mma_async, the probabilities staying in registers as
//               the A operand and v read MN-major from its [key][channel]
//               tile; p . v of one tile runs under the next tile's softmax
//               and the warpgroups alternate at the tensor cores. For
//               Wk = 32 or 64 the bias costs one add per score: the w terms
//               live in registers, the h terms arrive a tile ahead.
//               For any other Wk both factors' rows of the block's 128
//               queries are staged in shared memory and indexed per score:
//               83840 bytes are left for them, so the pitched Hk + Wk may be
//               327 at most (any grid near a square up to S = 26000).
//   mma_window  bfloat16, D = 64, S <= 208 and no bias or Hk + Wk <= 32: one
//               block owns the whole batch-head (a ViTDet window), stages k
//               and v once, and its warps score 16-query tiles against all
//               keys (mma.sync; 13 x 16 = 208 covers S = 196 with 6% padding
//               where 64-row tiles waste 23%); the bias is 32 more channels
//               of the first product.
//   mma_tiled   bfloat16 at every other head dim (a multiple of 16 from 32
//               to 128; an odd number of 16-channel k steps ends on an
//               ldmatrix.x2), and D = 64 with factors wider than that (a
//               grid of a few very long rows): 64 queries x 64 keys a
//               step on mma.sync, k and v tiles double-buffered with
//               cp.async, the bias from the factor rows of 64 queries staged
//               in shared memory (pitched Hk + Wk up to 1454 at D = 64).
//   simt_f32    float32 (the comparison runs; TF32 would keep 3 digits): a
//               plain SIMT kernel with 4 x 8 register tiles, the tight
//               reference for the staging and indexing the others share.
//
// Nothing falls back: a launch that its kernel cannot take (shared memory,
// grid size, a tensor map that cannot be encoded) returns the error.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no -fmad=false: nothing here depends on op-by-op
//        rounding). sm_90a, not sm_90: wgmma and setmaxnreg need it. The
//        tensor maps come from cuTensorMapEncodeTiled, reached through
//        cudaGetDriverEntryPoint, so nothing links against libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 4 warps
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* rel_h;  // null: no bias
  const void* rel_w;
  void* out;
  int S, Hk, Wk, n_qt;
  // element strides of the factors along the query and along h / w
  long long h_sq, h_sh, w_sq, w_sh;
  int q_fast;  // the factors are contiguous along the query (transposed layout)
  float scale;
};

// Row pitch of a staged factor of n columns: for even n an even pitch whose
// half is odd, so that the rows of a warp's 8 queries fall into distinct
// banks and a pair of columns is one aligned 32-bit word; n itself for odd n.
__host__ __device__ __forceinline__ int factor_pitch(int n) {
  return (n & 1) || ((n >> 1) & 1) ? n : n + 2;
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// Stage rows q0..q0+63 of one factor ([.., n] per query) into dst[64][pitch],
// by the `nthreads` threads numbered `tid`.
template <typename T>
__device__ void load_factor(T* dst, int pitch, const T* src, int q0, int S, int n, long long sq,
                            long long sh, int q_fast, int tid, int nthreads) {
  const int total = BQ * n;
  for (int idx = tid; idx < total; idx += nthreads) {
    int r, c;
    if (q_fast) {
      r = idx % BQ;
      c = idx / BQ;
    } else {
      r = idx / n;
      c = idx - r * n;
    }
    const int qi = q0 + r;
    dst[r * pitch + c] = qi < S ? src[(long long)qi * sq + (long long)c * sh] : zero<T>();
  }
}

// (j / Wk) | (j % Wk) << 16 of the tile's keys; keys past S (masked later) read 0.
__device__ __forceinline__ void key_table(int* khw, int k0, int S, int Wk) {
  if (threadIdx.x < BK) {
    const int j = k0 + threadIdx.x;
    const int h = j < S ? j / Wk : 0;
    const int w = j < S ? j - h * Wk : 0;
    khw[threadIdx.x] = h | (w << 16);
  }
}

// ------------------------------------------------------------- bfloat16 path

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c[16x8] += a[16x16] * b[16x8], bf16 inputs, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_ptr) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_ptr);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_ptr) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_ptr);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Two 8x8 matrices: lanes 0-15 give the row addresses (the others are ignored).
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* smem_ptr) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_ptr);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// 2^x for x <= 0 (and -inf -> 0): the hardware approximation, 2 ulp.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared without passing through registers; `bytes` = 0
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src, int bytes) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes));
}
// 4 bytes global -> shared without passing through registers.
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* src) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copy of 64 rows of D bf16 from row0 on (rows past S as zeros).
template <int D>
__device__ __forceinline__ void start_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                                int S) {
  constexpr int PITCH = D + 8;
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH;
    const bool in = row0 + r < S;
    cp_async16(dst + r * PITCH + c * 8, src + (size_t)(in ? row0 + r : 0) * D + c * 8, in ? 16 : 0);
  }
}

// Stage 64 rows of q from row0 on (rows past S as zeros), each multiplied by
// `scale` and rounded to bf16: q * scale in q's dtype.
template <int D>
__device__ void load_q_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0, int S,
                            float scale) {
  constexpr int PITCH = D + 8;
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c * 8);
    }
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      h2[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(dst + r * PITCH + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_bf16_kernel(Params p) {
  typedef __nv_bfloat16 bf16;
  constexpr int PITCH = D + 8;  // 16 bytes of padding: conflict-free fragment loads
  constexpr int KT = D / 16;    // k steps of q . k
  constexpr int NT = D / 8;     // n tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv_s = q_s + BQ * PITCH;  // two stages of a k tile and a v tile
  int* khw_s = reinterpret_cast<int*>(kv_s + 4 * BK * PITCH);
  bf16* rh_s = reinterpret_cast<bf16*>(khw_s + BK);
  const bool has_bias = p.rel_h != nullptr;
  const int pitch_h = factor_pitch(p.Hk), pitch_w = factor_pitch(p.Wk);
  bf16* rw_s = rh_s + BQ * pitch_h;

  const int b = blockIdx.x / p.n_qt;
  const int q0 = (blockIdx.x - b * p.n_qt) * BQ;
  const int S = p.S;
  const size_t base = (size_t)b * S * D;
  const bf16* Q = static_cast<const bf16*>(p.q) + base;
  const bf16* K = static_cast<const bf16*>(p.k) + base;
  const bf16* V = static_cast<const bf16*>(p.v) + base;
  bf16* O = static_cast<bf16*>(p.out) + base;

  // the first k and v tiles are on their way while q and the factors are staged
  start_tile_bf16<D>(kv_s, K, 0, S);
  start_tile_bf16<D>(kv_s + BK * PITCH, V, 0, S);
  cp_async_commit();
  const float scale = __bfloat162float(__float2bfloat16_rn(p.scale));
  load_q_bf16<D>(q_s, Q, q0, S, scale);
  if (has_bias) {
    const bf16* RH = static_cast<const bf16*>(p.rel_h) + (size_t)b * S * p.Hk;
    const bf16* RW = static_cast<const bf16*>(p.rel_w) + (size_t)b * S * p.Wk;
    load_factor<bf16>(rh_s, pitch_h, RH, q0, S, p.Hk, p.h_sq, p.h_sh, p.q_fast, threadIdx.x, THREADS);
    load_factor<bf16>(rw_s, pitch_w, RW, q0, S, p.Wk, p.w_sq, p.w_sh, p.q_fast, threadIdx.x, THREADS);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's two query rows in the tile

  uint32_t qf[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    qf[kt][0] = ld32(q_s + r0 * PITCH + kt * 16 + 2 * t);
    qf[kt][1] = ld32(q_s + r1 * PITCH + kt * 16 + 2 * t);
    qf[kt][2] = ld32(q_s + r0 * PITCH + kt * 16 + 8 + 2 * t);
    qf[kt][3] = ld32(q_s + r1 * PITCH + kt * 16 + 8 + 2 * t);
  }

  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  }
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  int stage = 0;
  for (int k0 = 0; k0 < S; k0 += BK) {
    // the next tile's copy runs under this tile's arithmetic
    if (k0 + BK < S) {
      bf16* next = kv_s + (stage ^ 1) * 2 * BK * PITCH;
      start_tile_bf16<D>(next, K, k0 + BK, S);
      start_tile_bf16<D>(next + BK * PITCH, V, k0 + BK, S);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: this tile has landed
    if (has_bias) key_table(khw_s, k0, S, p.Wk);
    __syncthreads();
    const bf16* k_s = kv_s + stage * 2 * BK * PITCH;
    const bf16* v_s = k_s + BK * PITCH;

    // scores of 16 queries x 64 keys: s[nt] covers keys 8 nt .. 8 nt + 7;
    // one ldmatrix brings the k fragments of two k steps (32 channels)
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* krow = k_s + (nt * 8 + (lane & 7)) * PITCH + (lane >> 3) * 8;
#pragma unroll
      for (int kp = 0; kp < KT / 2; ++kp) {
        uint32_t kb[4];
        ldmatrix_x4(kb, krow + kp * 32);
        mma_bf16(s[nt], qf[2 * kp], kb[0], kb[1]);
        mma_bf16(s[nt], qf[2 * kp + 1], kb[2], kb[3]);
      }
      if (KT & 1) {  // D = 48, 80, 112: the last k step alone, lanes 0-15 give its rows
        uint32_t kb[2];
        ldmatrix_x2(kb, krow + (KT - 1) * 16);
        mma_bf16(s[nt], qf[KT - 1], kb[0], kb[1]);
      }
    }

    if (has_bias) {
      const bf16* rh0 = rh_s + r0 * pitch_h;
      const bf16* rh1 = rh_s + r1 * pitch_h;
      const bf16* rw0 = rw_s + r0 * pitch_w;
      const bf16* rw1 = rw_s + r1 * pitch_w;
      if ((p.Wk & 1) == 0) {
        // even Wk: a thread's two adjacent keys share their row of the
        // token grid and are one 32-bit word of the w factor
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
          const int hw = khw_s[nt * 8 + 2 * t];
          const int h = hw & 0xffff, w = hw >> 16;
          const float h0 = __bfloat162float(rh0[h]), h1 = __bfloat162float(rh1[h]);
          const float2 w0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rw0 + w));
          const float2 w1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rw1 + w));
          s[nt][0] = s[nt][0] + h0 + w0.x;
          s[nt][1] = s[nt][1] + h0 + w0.y;
          s[nt][2] = s[nt][2] + h1 + w1.x;
          s[nt][3] = s[nt][3] + h1 + w1.y;
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int hw = khw_s[nt * 8 + 2 * t + e];
            const int h = hw & 0xffff, w = hw >> 16;
            s[nt][e] = s[nt][e] + __bfloat162float(rh0[h]) + __bfloat162float(rw0[w]);
            s[nt][2 + e] = s[nt][2 + e] + __bfloat162float(rh1[h]) + __bfloat162float(rw1[w]);
          }
        }
      }
    }
    if (k0 + BK > S) {  // the last tile: keys past S score -inf
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (k0 + nt * 8 + 2 * t + e >= S) s[nt][e] = s[nt][2 + e] = -INFINITY;
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // a row's 64 scores lie in the 4 lanes of its group
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile holds a valid key, so the new maxima are finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = fast_exp2((m0 - mn0) * LOG2E), c1 = fast_exp2((m1 - mn1) * LOG2E);
    m0 = mn0;
    m1 = mn1;
    // exp(s - m) = 2^(s log2(e) - m log2(e)): one multiply-add and one ex2
    const float ml0 = mn0 * LOG2E, ml1 = mn1 * LOG2E;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = fast_exp2(fmaf(s[nt][e], LOG2E, -ml0));
        const float p1 = fast_exp2(fmaf(s[nt][2 + e], LOG2E, -ml1));
        s[nt][e] = p0;
        s[nt][2 + e] = p1;
        sum0 += p0;
        sum1 += p1;
      }
    }
    // per-lane partial sums: every lane of a row scales by the same c
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      o[nt][0] *= c0;
      o[nt][1] *= c0;
      o[nt][2] *= c1;
      o[nt][3] *= c1;
    }

    // out += p . v: two score n tiles are one A fragment of 16 keys
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
      pa[1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
      pa[2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      pa[3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
      // lane -> row of one of four 8x8 blocks of v: keys 16 kt + (0|8) + 0..7,
      // channels 8 (2 np + (0|1)) .. + 7
      const int mat = lane >> 3;
      const bf16* vrow = v_s + (kt * 16 + (mat & 1) * 8 + (lane & 7)) * PITCH + (mat >> 1) * 8;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + np * 16);
        mma_bf16(o[2 * np], pa, vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next copy lands in it
    stage ^= 1;
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (q0 + r0 < S) {
      *reinterpret_cast<uint32_t*>(O + (size_t)(q0 + r0) * D + col) =
          pack_bf16(o[nt][0] / l0, o[nt][1] / l0);
    }
    if (q0 + r1 < S) {
      *reinterpret_cast<uint32_t*>(O + (size_t)(q0 + r1) * D + col) =
          pack_bf16(o[nt][2] / l1, o[nt][3] / l1);
    }
  }
}

// -------------------------------------------------------------- float32 path

template <int D>
__device__ void load_tile_f32(float* dst, const float* src, int row0, int S, float scale) {
  constexpr int PITCH = D + 1;
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    dst[r * PITCH + c] = row0 + r < S ? src[(size_t)(row0 + r) * D + c] * scale : 0.f;
  }
}

// Thread (ty, tx) of 16 x 8 owns query rows 4 ty .. 4 ty + 3 and the keys
// (then the output channels) tx + 8 j: a row's 8 threads are 8 adjacent lanes.
template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32_kernel(Params p) {
  constexpr int PITCH = D + 1;  // odd pitch: conflict-free column walks
  constexpr int PP = BK + 1;
  constexpr int DJ = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* k_s = q_s + BQ * PITCH;
  float* v_s = k_s + BK * PITCH;
  float* p_s = v_s + BK * PITCH;
  int* khw_s = reinterpret_cast<int*>(p_s + BQ * PP);
  float* rh_s = reinterpret_cast<float*>(khw_s + BK);
  const bool has_bias = p.rel_h != nullptr;
  const int pitch_h = factor_pitch(p.Hk), pitch_w = factor_pitch(p.Wk);
  float* rw_s = rh_s + BQ * pitch_h;

  const int b = blockIdx.x / p.n_qt;
  const int q0 = (blockIdx.x - b * p.n_qt) * BQ;
  const int S = p.S;
  const size_t base = (size_t)b * S * D;
  const float* Q = static_cast<const float*>(p.q) + base;
  const float* K = static_cast<const float*>(p.k) + base;
  const float* V = static_cast<const float*>(p.v) + base;
  float* O = static_cast<float*>(p.out) + base;

  load_tile_f32<D>(q_s, Q, q0, S, p.scale);
  if (has_bias) {
    const float* RH = static_cast<const float*>(p.rel_h) + (size_t)b * S * p.Hk;
    const float* RW = static_cast<const float*>(p.rel_w) + (size_t)b * S * p.Wk;
    load_factor<float>(rh_s, pitch_h, RH, q0, S, p.Hk, p.h_sq, p.h_sh, p.q_fast, threadIdx.x, THREADS);
    load_factor<float>(rw_s, pitch_w, RW, q0, S, p.Wk, p.w_sq, p.w_sh, p.q_fast, threadIdx.x, THREADS);
  }

  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  float o[4][DJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and q, factors are staged)
    load_tile_f32<D>(k_s, K, k0, S, 1.f);
    load_tile_f32<D>(v_s, V, k0, S, 1.f);
    if (has_bias) key_table(khw_s, k0, S, p.Wk);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(4 * ty + i) * PITCH + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = k_s[(tx + 8 * j) * PITCH + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 8 * j;
      const bool valid = k0 + col < S;
      const int hw = has_bias ? khw_s[col] : 0;
      const int h = hw & 0xffff, w = hw >> 16;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a = s[i][j];
        if (has_bias) {
          const int r = 4 * ty + i;
          a = a + rh_s[r * pitch_h + h] + rw_s[r * pitch_w + w];
        }
        s[i][j] = valid ? a : -INFINITY;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[i], mx);  // finite: every tile holds a valid key
      const float corr = expf(m[i] - mn);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pv = expf(s[i][j] - mn);
        sum += pv;
        p_s[(4 * ty + i) * PP + tx + 8 * j] = pv;
      }
      l[i] = l[i] * corr + sum;  // per-lane partial sum, as in the bf16 path
#pragma unroll
      for (int j = 0; j < DJ; ++j) o[i][j] *= corr;
    }
    __syncwarp();  // a row's probabilities are written and read by one warp

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(4 * ty + i) * PP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = v_s[c * PITCH + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < DJ; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const int qi = q0 + 4 * ty + i;
    if (qi < S) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) O[(size_t)qi * D + tx + 8 * j] = o[i][j] / li;
    }
  }
}

// ------------------------------------------- bfloat16, D = 64, whole windows
//
// S <= 208 and Hk + Wk <= 32: one block owns one batch-head (a ViTDet
// window) and stages its k and v once, with cp.async. Warps own query tiles
// of 16 rows (13 x 16 = 208 covers S = 196 with 6% padding where 64-row
// tiles waste 23%) and score each against every key; up to 128 keys that is
// one pass with no running maximum, beyond it two halves, so that a thread
// holds at most 56 scores and rescales its 32 output sums once. The bias
// rides in the first product: the query rows of rel_h | rel_w are 32 more
// channels of q and a 0/1 selector (channel j / Wk and channel Hk + j % Wk
// are 1) 32 more channels of key j, so q' . k' = q . k + rel_h[q][j / Wk] +
// rel_w[q][j % Wk], each product with a 1 exact and the sum in the float32
// accumulator. Even and odd Wk are one code path. The selector is built in
// shared memory; the batch-head's factors are copied there as they lie, and
// q comes straight from global memory into A fragments.

constexpr int WIN_D = 64;
constexpr int WIN_EXT = 32;               // channels the folded bias adds
constexpr int WIN_PITCH = WIN_D + 8;      // 16 bytes of padding: conflict-free ldmatrix
constexpr int WIN_EPITCH = WIN_EXT + 8;
constexpr int WIN_MAX_S = 208;

// two query tiles of 16 rows per warp
__host__ __device__ constexpr int win_warps(int nkt) { return (nkt + 1) / 2; }

// One 32-bit pair of q from global memory, times `scale`, rounded to bf16.
__device__ __forceinline__ uint32_t ldq_scaled(const __nv_bfloat16* Q, int row, int col, int S,
                                               float scale) {
  if (row >= S) return 0u;
  uint32_t raw = __ldg(reinterpret_cast<const unsigned int*>(Q + (size_t)row * WIN_D + col));
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw));
  return pack_bf16(f.x * scale, f.y * scale);
}

// Channels c, c + 1 of query row `row` of rel_h | rel_w | 0, as one bf16 pair,
// from the block's copies of its batch-head's factors (in the caller's layout).
__device__ __forceinline__ uint32_t ld_factor_pair(const Params& p, const uint16_t* rh,
                                                   const uint16_t* rw, int row, int c, int S) {
  uint32_t pair = 0u;
  if (row < S) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = c + e;
      unsigned f = 0u;
      if (ch < p.Hk) {
        f = rh[row * (int)p.h_sq + ch * (int)p.h_sh];
      } else if (ch < p.Hk + p.Wk) {
        f = rw[row * (int)p.w_sq + (ch - p.Hk) * (int)p.w_sh];
      }
      pair |= f << (16 * e);
    }
  }
  return pair;
}

// The 16 x 64 A fragments of query tile `qt`, scaled, straight from global memory.
__device__ __forceinline__ void load_q_fragments(uint32_t (&qf)[4][4], const __nv_bfloat16* Q, int qt,
                                                 int S, float scale, int lane) {
  const int r0 = qt * 16 + (lane >> 2), r1 = r0 + 8, t = lane & 3;
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    qf[kt][0] = ldq_scaled(Q, r0, kt * 16 + 2 * t, S, scale);
    qf[kt][1] = ldq_scaled(Q, r1, kt * 16 + 2 * t, S, scale);
    qf[kt][2] = ldq_scaled(Q, r0, kt * 16 + 8 + 2 * t, S, scale);
    qf[kt][3] = ldq_scaled(Q, r1, kt * 16 + 8 + 2 * t, S, scale);
  }
}

// The running softmax state of a thread's two query rows.
struct RowState {
  float m0, m1, l0, l1;
};

// Keys 16 KT0 .. 16 (KT0 + NKT) - 1 of one query tile: scores, the running
// softmax update and p . v into o. `k_s`, `ke_s`, `v_s` point at the window's
// first key.
template <int KT0, int NKT, bool BIAS>
__device__ __forceinline__ void window_keys(const __nv_bfloat16* k_s, const __nv_bfloat16* ke_s,
                                            const __nv_bfloat16* v_s, const uint32_t (&qf)[4][4],
                                            const uint32_t (&qe)[2][4], float (&o)[8][4],
                                            RowState& st, int S, int lane) {
  typedef __nv_bfloat16 bf16;
  constexpr int NT = 2 * NKT;
  const int t = lane & 3;
  // s[nt] covers keys 16 KT0 + 8 nt .. + 7
  float s[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const int key = KT0 * 16 + nt * 8 + (lane & 7);
    const bf16* krow = k_s + key * WIN_PITCH + (lane >> 3) * 8;
    uint32_t kb[4];
#pragma unroll
    for (int kp = 0; kp < 2; ++kp) {
      ldmatrix_x4(kb, krow + kp * 32);
      mma_bf16(s[nt], qf[2 * kp], kb[0], kb[1]);
      mma_bf16(s[nt], qf[2 * kp + 1], kb[2], kb[3]);
    }
    if (BIAS) {
      ldmatrix_x4(kb, ke_s + key * WIN_EPITCH + (lane >> 3) * 8);
      mma_bf16(s[nt], qe[0], kb[0], kb[1]);
      mma_bf16(s[nt], qe[1], kb[2], kb[3]);
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (KT0 * 16 + nt * 8 + 2 * t + e >= S) s[nt][e] = s[nt][2 + e] = -INFINITY;  // keys past S
    }
    mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
    mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // the first keys are valid, so the running maxima are finite from there on
  const float mn0 = fmaxf(st.m0, mx0), mn1 = fmaxf(st.m1, mx1);
  if (KT0 > 0) {
    const float c0 = fast_exp2((st.m0 - mn0) * LOG2E), c1 = fast_exp2((st.m1 - mn1) * LOG2E);
    st.l0 *= c0;
    st.l1 *= c1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      o[nt][0] *= c0;
      o[nt][1] *= c0;
      o[nt][2] *= c1;
      o[nt][3] *= c1;
    }
  }
  st.m0 = mn0;
  st.m1 = mn1;
  const float ml0 = mn0 * LOG2E, ml1 = mn1 * LOG2E;

  // out += p . v: the probabilities of 16 keys are one A fragment
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt) {
    float pr[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        pr[4 * h + e] = fast_exp2(fmaf(s[2 * kt + h][e], LOG2E, -ml0));
        pr[4 * h + 2 + e] = fast_exp2(fmaf(s[2 * kt + h][2 + e], LOG2E, -ml1));
        st.l0 += pr[4 * h + e];
        st.l1 += pr[4 * h + 2 + e];
      }
    }
    uint32_t pa[4];
    pa[0] = pack_bf16(pr[0], pr[1]);
    pa[1] = pack_bf16(pr[2], pr[3]);
    pa[2] = pack_bf16(pr[4], pr[5]);
    pa[3] = pack_bf16(pr[6], pr[7]);
    const int mat = lane >> 3;
    const bf16* vrow =
        v_s + ((KT0 + kt) * 16 + (mat & 1) * 8 + (lane & 7)) * WIN_PITCH + (mat >> 1) * 8;
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vrow + np * 16);
      mma_bf16(o[2 * np], pa, vb[0], vb[1]);
      mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
    }
  }
}

template <int NKT, bool BIAS>
__global__ void __launch_bounds__(32 * win_warps(NKT), NKT > 8 ? 2 : 4)
    flash_window_bf16_kernel(Params p) {
  typedef __nv_bfloat16 bf16;
  constexpr int ROWS = 16 * NKT;  // keys (and queries) the block covers
  // more than 8 key steps go in two halves, so that a thread holds at most
  // 56 scores: the second half rescales the 32 output sums once
  constexpr int NKT0 = NKT > 8 ? (NKT + 1) / 2 : NKT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][72]
  bf16* v_s = k_s + ROWS * WIN_PITCH;             // [ROWS][72]
  bf16* ke_s = v_s + ROWS * WIN_PITCH;            // [ROWS][40] selector of key j
  uint16_t* rh_s = reinterpret_cast<uint16_t*>(ke_s + ROWS * WIN_EPITCH);  // the batch-head's rel_h, as given
  uint16_t* rw_s = rh_s + ((p.S * p.Hk + 1) & ~1);                         // and its rel_w

  const int b = blockIdx.x;
  const int S = p.S;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const size_t base = (size_t)b * S * WIN_D;
  const bf16* Q = static_cast<const bf16*>(p.q) + base;
  const bf16* K = static_cast<const bf16*>(p.k) + base;
  const bf16* V = static_cast<const bf16*>(p.v) + base;
  bf16* O = static_cast<bf16*>(p.out) + base;
  const uint16_t* RH = static_cast<const uint16_t*>(p.rel_h) + (size_t)b * S * p.Hk;
  const uint16_t* RW = static_cast<const uint16_t*>(p.rel_w) + (size_t)b * S * p.Wk;

  for (int idx = tid; idx < ROWS * 8; idx += nthreads) {
    const int r = idx >> 3, c = idx & 7;
    const bool in = r < S;
    const size_t off = (size_t)(in ? r : 0) * WIN_D + c * 8;
    cp_async16(k_s + r * WIN_PITCH + c * 8, K + off, in ? 16 : 0);
    cp_async16(v_s + r * WIN_PITCH + c * 8, V + off, in ? 16 : 0);
  }
  cp_async_commit();
  if (BIAS) {
    // the selector rows, the same for every batch-head: channel j / Wk and
    // channel Hk + j % Wk of key j are 1
    const int Hk = p.Hk, Wk = p.Wk;
    // this batch-head's factors, copied as they lie (S * Hk and S * Wk
    // values): asynchronously in 4-byte words where their count is even
    if (((S * Hk) | (S * Wk)) & 1) {
      for (int idx = tid; idx < S * Hk; idx += nthreads) rh_s[idx] = __ldg(RH + idx);
      for (int idx = tid; idx < S * Wk; idx += nthreads) rw_s[idx] = __ldg(RW + idx);
    } else {
      for (int idx = tid; idx < S * Hk / 2; idx += nthreads) cp_async4(rh_s + 2 * idx, RH + 2 * idx);
      for (int idx = tid; idx < S * Wk / 2; idx += nthreads) cp_async4(rw_s + 2 * idx, RW + 2 * idx);
      cp_async_commit();
    }
    // r / Wk for r * Wk < 2^16 (r, Wk <= 208) as a multiply and a shift
    const unsigned recip = (65536u + Wk - 1) / Wk;
    constexpr unsigned ONE = 0x3f80u;  // bf16 1.0
    for (int idx = tid; idx < ROWS * (WIN_EXT / 2); idx += nthreads) {
      const int r = idx / (WIN_EXT / 2), cp = idx % (WIN_EXT / 2);
      uint32_t sel = 0u;
      if (r < S) {
        const int h = (int)((r * recip) >> 16), w = r - h * Wk;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * cp + e;
          if (c == h || c == Hk + w) sel |= ONE << (16 * e);
        }
      }
      *reinterpret_cast<uint32_t*>(ke_s + r * WIN_EPITCH + 2 * cp) = sel;
    }
  }
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float scale = __bfloat162float(__float2bfloat16_rn(p.scale));
  cp_async_wait<0>();
  __syncthreads();

  for (int qt = warp; qt * 16 < S; qt += nwarps) {
    const int r0 = qt * 16 + g, r1 = r0 + 8;
    uint32_t qf[4][4];
    load_q_fragments(qf, Q, qt, S, scale, lane);
    uint32_t qe[2][4] = {};
    if (BIAS) {  // the query rows of rel_h | rel_w: 32 more channels of q
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        qe[kt][0] = ld_factor_pair(p, rh_s, rw_s, r0, kt * 16 + 2 * t, S);
        qe[kt][1] = ld_factor_pair(p, rh_s, rw_s, r1, kt * 16 + 2 * t, S);
        qe[kt][2] = ld_factor_pair(p, rh_s, rw_s, r0, kt * 16 + 8 + 2 * t, S);
        qe[kt][3] = ld_factor_pair(p, rh_s, rw_s, r1, kt * 16 + 8 + 2 * t, S);
      }
    }
    float o[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
    RowState st = {-INFINITY, -INFINITY, 0.f, 0.f};
    window_keys<0, NKT0, BIAS>(k_s, ke_s, v_s, qf, qe, o, st, S, lane);
    if constexpr (NKT0 < NKT) {
      window_keys<NKT0, NKT - NKT0, BIAS>(k_s, ke_s, v_s, qf, qe, o, st, S, lane);
    }

    float l0 = st.l0, l1 = st.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      if (r0 < S) {
        *reinterpret_cast<uint32_t*>(O + (size_t)r0 * WIN_D + col) = pack_bf16(o[nt][0] / l0, o[nt][1] / l0);
      }
      if (r1 < S) {
        *reinterpret_cast<uint32_t*>(O + (size_t)r1 * WIN_D + col) = pack_bf16(o[nt][2] / l1, o[nt][3] / l1);
      }
    }
  }
}

// ----------------------------------- bfloat16, D = 64, long sequences: wgmma
//
// One block owns 128 queries of one batch-head: two consumer warpgroups of
// 64 queries each and a producer warpgroup whose first thread keeps tiles of
// 128 keys (k and v apart) in flight with TMA into a ring of shared-memory
// stages, 128-byte swizzled, tracked by full/empty mbarrier pairs. The
// consumers run q . k^T with wgmma (q and k from shared memory) and p . v with
// the probabilities as the register A operand and v read MN-major from the
// same [key][channel] tile, so v is never transposed. p . v of tile j - 1 is
// sent out together with q . k^T of tile j and runs under tile j's softmax; the
// two warpgroups take turns at the tensor cores through a pair of named
// barriers, so one's softmax and bias add run under the other's products.
// The compiler serializes wgmma it cannot prove to run in uniform control
// flow (each then waits for the one before): the warpgroup's role comes from
// a value broadcast over the warp, and no wgmma stands under a branch.

constexpr int WG_BQ = 128;       // queries per block, 64 per consumer warpgroup
constexpr int WG_BK = 128;       // keys per tile
constexpr int WG_STAGES = 4;     // ring depth, for k and for v
constexpr int WG_THREADS = 384;  // two consumer warpgroups and the producer's
constexpr int WG_TILE_BYTES = WG_BK * 64 * 2;
constexpr int WG_BAR_OFFSET = WG_TILE_BYTES * (1 + 2 * WG_STAGES);
constexpr int WG_FACTOR_OFFSET = WG_BAR_OFFSET + 128;
// the folded-bias variant's operands, tiles of 128-byte rows like k's: per
// warpgroup 64 query rows of rel_w and of rel_h (8 KB each), the w selector
// of a key tile (16 KB) and the 8 h selectors (16 channels each, 32 KB)
constexpr int WG_FOLD_OFFSET = WG_BAR_OFFSET + 1024;
constexpr int WG_FOLD_BYTES = 5 * WG_TILE_BYTES;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One [1][128][64] box of a [B][S][64] bf16 tensor into shared memory; rows
// past S arrive as zeros.
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row), "r"(b)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Shared-memory matrix descriptor of a tile of 128-byte rows, 128-byte
// swizzled, groups of 8 rows 1024 bytes apart (K-major: a row is one m or n
// index; MN-major: a row is one k index and holds 64 n indices).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;            // leading byte offset: unused within one swizzle atom
  d |= (uint64_t)(1024 >> 4) << 32;  // stride byte offset
  d |= (uint64_t)1 << 62;            // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving uses of the registers across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define D2T_F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define D2T_F16(a, i) D2T_F4(a, i), D2T_F4(a, i + 4), D2T_F4(a, i + 8), D2T_F4(a, i + 12)

// d[64 x 128] (+)= a[64 x 16] . b[128 x 16]^T, both from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : D2T_F16(d, 0), D2T_F16(d, 16), D2T_F16(d, 32), D2T_F16(d, 48)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] (+)= a[64 x 16] . b[16 x 64], a from registers, b from shared
// memory MN-major (rows are k indices).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t* a, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D2T_F16(d, 0), D2T_F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// 64 query rows from q0 of one factor of n <= 64 columns as a wgmma A tile:
// 128-byte rows, 16-byte chunk c of row r at chunk c ^ (r & 7), columns from n
// on and rows from S on zero. By the warpgroup's 128 threads.
__device__ void stage_factor_tile(unsigned char* dst, const __nv_bfloat16* src, int q0, int S, int n,
                                  long long sq, long long sh, int q_fast, int tid) {
  for (int idx = tid; idx < 64 * 8; idx += 128) {
    // lanes run along what is contiguous in memory: columns, or queries
    const int r = q_fast ? idx & 63 : idx >> 3, c = q_fast ? idx >> 6 : idx & 7;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < S) {
      const __nv_bfloat16* row = src + (long long)(q0 + r) * sq;
      if (sh == 1 && (n & 7) == 0) {
        if (8 * c < n) val = *reinterpret_cast<const uint4*>(row + 8 * c);
      } else {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (8 * c + i < n) e[i] = row[(long long)(8 * c + i) * sh];
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * 128 + ((c ^ (r & 7)) << 4)) = val;
  }
}

// A 16-byte chunk of a 0/1 selector row: bf16 1.0 at element `one` where that
// lies in channels 8 c .. 8 c + 7, zeros elsewhere.
__device__ __forceinline__ uint4 selector_chunk(int one, int c) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if ((one >> 3) == c) w[(one & 7) >> 1] = 0x3F80u << (16 * (one & 1));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// BIAS: 0 none; 1 Wk = 2^LOG2_WK in {32, 64}: Wk divides the key tile, so a
// thread's w terms are the same in every tile and stay in registers (times
// log2 e, in float32), and a tile spans 128 / Wk rows of the token grid,
// whose h terms are fetched from global memory one tile ahead: no factor is
// staged, and the bias costs one add per score; 2 any Hk, Wk: both factors
// staged in shared memory, two indexed loads per score; 3 Wk = 64, Hk <= 64,
// the bias folded into the first product (the TPU kernel's selection matmuls,
// kept for the comparison of the two ways at the ViTDet-B global shape, never
// chosen by shape): q's rows gain the query's 64 w terms and its 16 h terms
// around the tile's two grid rows as 80 more channels, the key tile a 0/1
// selector of each key's column and row, so a tile takes 9 wgmma for its
// scores where it took 4, and the softmax adds nothing.
template <int BIAS, int LOG2_WK>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_wgmma_bf16_kernel(const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v, Params p) {
  typedef __nv_bfloat16 bf16;
  extern __shared__ unsigned char smem_unaligned[];
  // the swizzle pattern repeats every 1024 bytes: tiles start on that boundary
  unsigned char* sm = smem_unaligned + ((1024u - (smem_u32(smem_unaligned) & 1023u)) & 1023u);
  const uint32_t sm_addr = smem_u32(sm);
  const uint32_t k_addr = sm_addr + WG_TILE_BYTES;
  const uint32_t v_addr = k_addr + WG_STAGES * WG_TILE_BYTES;
  const uint32_t bar_addr = sm_addr + WG_BAR_OFFSET;
  // barriers: full k, empty k, full v, empty v, WG_STAGES of each
  auto full_k = [&](int s) { return bar_addr + 8u * s; };
  auto empty_k = [&](int s) { return bar_addr + 8u * (WG_STAGES + s); };
  auto full_v = [&](int s) { return bar_addr + 8u * (2 * WG_STAGES + s); };
  auto empty_v = [&](int s) { return bar_addr + 8u * (3 * WG_STAGES + s); };

  const int S = p.S;
  const int b = blockIdx.x / p.n_qt;
  const int q0 = (blockIdx.x - b * p.n_qt) * WG_BQ;
  const int n_tiles = (S + WG_BK - 1) / WG_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 8);  // one arrival per consumer warp
      mbar_init(empty_v(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (BIAS == 3) {
    // key n of a tile lies in grid column n % 64; in tile i (mod 8) it lies in
    // row 2 i + n / 64 of the 16 rows that the tile's h channels cover
    unsigned char* selw = sm + WG_FOLD_OFFSET + 2 * WG_TILE_BYTES;
    unsigned char* selh = selw + WG_TILE_BYTES;
    for (int idx = threadIdx.x; idx < 3 * 128 * 8; idx += WG_THREADS) {
      const int tile = idx >> 10, n = (idx >> 3) & 127, c = idx & 7;
      uint4 val;
      if (tile == 0) {
        val = selector_chunk(n & 63, c);
      } else {
        const int i = (tile - 1) * 4 + (c >> 1);  // 16 channels, two chunks, per i
        val = selector_chunk(2 * i + (n >> 6), c & 1);
      }
      unsigned char* dst = tile == 0 ? selw : selh + (tile - 1) * WG_TILE_BYTES;
      *reinterpret_cast<uint4*>(dst + n * 128 + ((c ^ (n & 7)) << 4)) = val;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // broadcast from lane 0, so that the compiler sees a warp-uniform value:
  // wgmma on a path it takes for divergent is serialized
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  if (wg == 2) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int stage = 0, parity = 1;  // the ring starts empty: the first waits pass
      for (int tile = 0; tile < n_tiles; ++tile) {
        mbar_wait(empty_k(stage), parity);
        mbar_expect_tx(full_k(stage), WG_TILE_BYTES);
        tma_load_tile(k_addr + stage * WG_TILE_BYTES, &map_k, full_k(stage), tile * WG_BK, b);
        mbar_wait(empty_v(stage), parity);
        mbar_expect_tx(full_v(stage), WG_TILE_BYTES);
        tma_load_tile(v_addr + stage * WG_TILE_BYTES, &map_v, full_v(stage), tile * WG_BK, b);
        if (++stage == WG_STAGES) {
          stage = 0;
          parity ^= 1;
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's rows of the warpgroup's 64
    const int wq0 = q0 + wg * 64;               // the warpgroup's first query
    const size_t base = (size_t)b * S * 64;
    const bf16* Q = static_cast<const bf16*>(p.q) + base;
    bf16* O = static_cast<bf16*>(p.out) + base;
    unsigned char* q_s = sm + wg * (64 * 128);
    const int pitch_h = factor_pitch(p.Hk), pitch_w = factor_pitch(p.Wk);
    bf16* rh_s = reinterpret_cast<bf16*>(sm + WG_FACTOR_OFFSET) + wg * 64 * (pitch_h + pitch_w);
    bf16* rw_s = rh_s + 64 * pitch_h;

    // q * scale, rounded to bf16, in the swizzled layout wgmma reads: the
    // 16-byte chunk c of row r lies at chunk c ^ (r & 7)
    const float scale = __bfloat162float(__float2bfloat16_rn(p.scale));
    for (int idx = tid; idx < 64 * 8; idx += 128) {
      const int r = idx >> 3, c = idx & 7;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (wq0 + r < S) val = *reinterpret_cast<const uint4*>(Q + (size_t)(wq0 + r) * 64 + c * 8);
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h2[i]);
        h2[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
      *reinterpret_cast<uint4*>(q_s + r * 128 + ((c ^ (r & 7)) << 4)) = val;
    }
    const bf16* RH = static_cast<const bf16*>(p.rel_h) + (size_t)b * S * p.Hk;
    const bf16* RW = static_cast<const bf16*>(p.rel_w) + (size_t)b * S * p.Wk;
    if (BIAS == 2) {
      load_factor<bf16>(rh_s, pitch_h, RH, wq0, S, p.Hk, p.h_sq, p.h_sh, p.q_fast, tid, 128);
      load_factor<bf16>(rw_s, pitch_w, RW, wq0, S, p.Wk, p.w_sq, p.w_sh, p.q_fast, tid, 128);
    }
    unsigned char* fw_s = sm + WG_FOLD_OFFSET + wg * (64 * 128);  // BIAS 3: the factors as A tiles
    unsigned char* fh_s = fw_s + WG_TILE_BYTES;
    if (BIAS == 3) {
      stage_factor_tile(fw_s, RW, wq0, S, p.Wk, p.w_sq, p.w_sh, p.q_fast, tid);
      stage_factor_tile(fh_s, RH, wq0, S, p.Hk, p.h_sq, p.h_sh, p.q_fast, tid);
    }
    // the warpgroup's writes are visible to its wgmma reads (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_bar_sync(1 + wg, 128);

    const bf16* rh0 = rh_s + r0 * pitch_h;  // BIAS 2: the staged rows of r0 and r1
    const bf16* rh1 = rh_s + r1 * pitch_h;
    const bf16* rw0 = rw_s + r0 * pitch_w;
    const bf16* rw1 = rw_s + r1 * pitch_w;
    // BIAS 1: per row, the w terms of the thread's key columns (column pair j
    // of a tile has w = (8 j + 2 t) % Wk, so pairs j and j + NW share theirs)
    // and the h terms of the tile's NH grid rows, all times log2 e
    constexpr int WK = 1 << LOG2_WK;
    constexpr int NH = BIAS == 1 ? WG_BK / WK : 1;  // grid rows a tile spans
    constexpr int NW = BIAS == 1 ? WK / 8 : 1;      // column pairs of one grid row
    const bool in0 = wq0 + r0 < S, in1 = wq0 + r1 < S;
    const bf16* gh0 = RH + (long long)(wq0 + r0) * p.h_sq;  // row r0's h terms, p.h_sh apart
    const bf16* gh1 = RH + (long long)(wq0 + r1) * p.h_sq;
    float wl0[2 * NW], wl1[2 * NW], hl0[NH], hl1[NH];
    if (BIAS == 1) {
      const bf16* gw0 = RW + (long long)(wq0 + r0) * p.w_sq;
      const bf16* gw1 = RW + (long long)(wq0 + r1) * p.w_sq;
#pragma unroll
      for (int i = 0; i < 2 * NW; ++i) {
        const long long w = (8 * (i >> 1) + 2 * t + (i & 1)) * p.w_sh;
        wl0[i] = in0 ? __bfloat162float(gw0[w]) * LOG2E : 0.f;
        wl1[i] = in1 ? __bfloat162float(gw1[w]) * LOG2E : 0.f;
      }
    }

    const uint64_t q_desc = wgmma_desc(smem_u32(q_s));
    const uint64_t fw_desc = wgmma_desc(smem_u32(fw_s)), fh_desc = wgmma_desc(smem_u32(fh_s));
    const uint64_t selw_desc = wgmma_desc(sm_addr + WG_FOLD_OFFSET + 2 * WG_TILE_BYTES);
    const uint64_t selh_desc0 = wgmma_desc(sm_addr + WG_FOLD_OFFSET + 3 * WG_TILE_BYTES);
    const uint64_t selh_desc1 = wgmma_desc(sm_addr + WG_FOLD_OFFSET + 4 * WG_TILE_BYTES);
    float s[64], o[32];
    uint32_t pk[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float c0 = 0.f, c1 = 0.f;  // what the newest tile's maxima scale the older sums by
    int k_stage = 0, k_parity = 0, v_stage = 0, v_parity = 0;

    // The h terms of the tile at key k0, raw: they are fetched a tile ahead
    // and converted only where the softmax uses them, so the loads' latency
    // falls under a whole tile's work.
    uint16_t hraw0[NH], hraw1[NH], hnext0[NH], hnext1[NH];
    auto fetch_h = [&](int k0, uint16_t (&d0)[NH], uint16_t (&d1)[NH]) {
      if (BIAS == 1) {
        const uint16_t* u0 = reinterpret_cast<const uint16_t*>(gh0);
        const uint16_t* u1 = reinterpret_cast<const uint16_t*>(gh1);
#pragma unroll
        for (int i = 0; i < NH; ++i) {
          const int h = (k0 >> LOG2_WK) + i;
          d0[i] = in0 && h < p.Hk ? __ldg(u0 + (long long)h * p.h_sh) : (uint16_t)0;
          d1[i] = in1 && h < p.Hk ? __ldg(u1 + (long long)h * p.h_sh) : (uint16_t)0;
        }
      }
    };
    // the fetched terms become the current tile's, times log2 e
    auto rotate_h = [&]() {
      if (BIAS == 1) {
#pragma unroll
        for (int i = 0; i < NH; ++i) {
          hl0[i] = __uint_as_float((uint32_t)hraw0[i] << 16) * LOG2E;
          hl1[i] = __uint_as_float((uint32_t)hraw1[i] << 16) * LOG2E;
          hraw0[i] = hnext0[i];
          hraw1[i] = hnext1[i];
        }
      }
    };
    // s = q . k^T of the tile in stage k_stage, one commit group
    auto start_qk = [&](int tile) {
      const uint64_t k_desc = wgmma_desc(k_addr + k_stage * WG_TILE_BYTES);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // 16 channels on: 32 bytes within the swizzled row
        wgmma_ss_m64n128k16(s, q_desc + 2 * kk, k_desc + 2 * kk, kk > 0);
      }
      if (BIAS == 3) {  // + rel_w . its selector + rel_h's 16 channels . theirs
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss_m64n128k16(s, fw_desc + 2 * kk, selw_desc + 2 * kk, 1);
        }
        const uint64_t selh_desc = (tile & 4) ? selh_desc1 : selh_desc0;
        wgmma_ss_m64n128k16(s, fh_desc + 2 * (tile >> 3), selh_desc + 2 * (tile & 3), 1);
      }
      wgmma_commit();
    };
    // o += p . v of the tile in stage v_stage, one commit group
    auto start_pv = [&]() {
      const uint64_t v_desc = wgmma_desc(v_addr + v_stage * WG_TILE_BYTES);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        // 16 keys on: two groups of 8 rows, 2048 bytes
        wgmma_rs_m64n64k16(o, pk + 4 * kk, v_desc + 128 * kk, 1);
      }
      wgmma_commit();
    };
    auto release = [&](uint32_t bar, int& stage, int& parity) {
      if (lane == 0) mbar_arrive(bar);
      if (++stage == WG_STAGES) {
        stage = 0;
        parity ^= 1;
      }
    };
    // bias, tail mask and the running softmax over the tile's scores; leaves
    // the unnormalised probabilities in s.
    // s[4 j + 0, 1]: row r0, keys k0 + 8 j + 2 t, + 1; s[4 j + 2, 3]: row r1
    auto softmax = [&](int k0) {
      if (BIAS == 1) {  // (s + w) log2 e: one multiply-add
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          s[4 * j + 0] = fmaf(s[4 * j + 0], LOG2E, wl0[2 * (j % NW) + 0]);
          s[4 * j + 1] = fmaf(s[4 * j + 1], LOG2E, wl0[2 * (j % NW) + 1]);
          s[4 * j + 2] = fmaf(s[4 * j + 2], LOG2E, wl1[2 * (j % NW) + 0]);
          s[4 * j + 3] = fmaf(s[4 * j + 3], LOG2E, wl1[2 * (j % NW) + 1]);
        }
      } else if (BIAS == 2) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + 2 * t + e;
            if (key < S) {
              const int h = key / p.Wk, w = key - h * p.Wk;
              s[4 * j + e] = s[4 * j + e] + __bfloat162float(rh0[h]) + __bfloat162float(rw0[w]);
              s[4 * j + 2 + e] = s[4 * j + 2 + e] + __bfloat162float(rh1[h]) + __bfloat162float(rw1[w]);
            }
          }
        }
      }
      if (k0 + WG_BK > S) {  // the last tile: keys past S score -inf
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (k0 + 8 * j + 2 * t + e >= S) s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
          }
        }
      }
      // The row maxima. BIAS 1 works in units of log2 e throughout: the h term
      // of a grid row joins the maximum of that row's keys, not every key.
      float mx0 = -INFINITY, mx1 = -INFINITY;
      if (BIAS == 1) {
#pragma unroll
        for (int gr = 0; gr < NH; ++gr) {
          float g0 = -INFINITY, g1 = -INFINITY;
#pragma unroll
          for (int j = gr * NW; j < (gr + 1) * NW; ++j) {
            g0 = fmaxf(g0, fmaxf(s[4 * j + 0], s[4 * j + 1]));
            g1 = fmaxf(g1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
          }
          mx0 = fmaxf(mx0, g0 + hl0[gr]);
          mx1 = fmaxf(mx1, g1 + hl1[gr]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * j + 0], s[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // every tile holds a valid key, so the new maxima are finite
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      constexpr float TO_LOG2 = BIAS == 1 ? 1.f : LOG2E;
      c0 = fast_exp2((m0 - mn0) * TO_LOG2);
      c1 = fast_exp2((m1 - mn1) * TO_LOG2);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
      if (BIAS == 1) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float d0 = hl0[j / NW] - mn0, d1 = hl1[j / NW] - mn1;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p0 = fast_exp2(s[4 * j + e] + d0);
            const float p1 = fast_exp2(s[4 * j + 2 + e] + d1);
            s[4 * j + e] = p0;
            s[4 * j + 2 + e] = p1;
            sum0 += p0;
            sum1 += p1;
          }
        }
      } else {
        // exp(s - m) = 2^(s log2(e) - m log2(e)): one multiply-add and one ex2
        const float ml0 = mn0 * LOG2E, ml1 = mn1 * LOG2E;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p0 = fast_exp2(fmaf(s[4 * j + e], LOG2E, -ml0));
            const float p1 = fast_exp2(fmaf(s[4 * j + 2 + e], LOG2E, -ml1));
            s[4 * j + e] = p0;
            s[4 * j + 2 + e] = p1;
            sum0 += p0;
            sum1 += p1;
          }
        }
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
    };
    // the probabilities as A fragments (16 keys each: rows r0, r1 of keys 2 t,
    // + 1 and 8 + 2 t, + 1), and the older output sums rescaled
    auto pack_and_rescale = [&]() {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pk[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pk[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pk[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pk[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j + 0] *= c0;
        o[4 * j + 1] *= c0;
        o[4 * j + 2] *= c1;
        o[4 * j + 3] *= c1;
      }
    };

    // The warpgroups alternate at the tensor cores: barrier 3 + wg opens
    // warpgroup wg's turn, and warpgroup 1 opens warpgroup 0's first. Every
    // step below is unconditional: wgmma under a branch is serialized.
    if (wg == 1) named_bar_arrive(3, 256);

    // tile 0: scores only
    fetch_h(0, hraw0, hraw1);
    fetch_h(WG_BK, hnext0, hnext1);
    mbar_wait(full_k(k_stage), k_parity);
    named_bar_sync(3 + wg, 256);
    wgmma_fence();
    start_qk(0);
    named_bar_arrive(3 + (wg ^ 1), 256);
    wgmma_wait<0>();
    fence_regs(s);
    release(empty_k(k_stage), k_stage, k_parity);
    rotate_h();
    softmax(0);
    pack_and_rescale();

    // tile j: its scores and p . v of tile j - 1 go out together; p . v runs
    // under tile j's softmax
    for (int tile = 1; tile < n_tiles; ++tile) {
      const int k0 = tile * WG_BK;
      fetch_h(k0 + WG_BK, hnext0, hnext1);
      mbar_wait(full_k(k_stage), k_parity);
      named_bar_sync(3 + wg, 256);
      wgmma_fence();
      start_qk(tile);
      mbar_wait(full_v(v_stage), v_parity);
      start_pv();
      named_bar_arrive(3 + (wg ^ 1), 256);
      wgmma_wait<1>();  // the scores are there; p . v may still run
      fence_regs(s);
      release(empty_k(k_stage), k_stage, k_parity);
      rotate_h();
      softmax(k0);
      wgmma_wait<0>();  // p . v of the tile before: its probabilities and o are free
      fence_regs(o);
      release(empty_v(v_stage), v_stage, v_parity);
      pack_and_rescale();
    }

    // p . v of the last tile
    mbar_wait(full_v(v_stage), v_parity);
    named_bar_sync(3 + wg, 256);
    wgmma_fence();
    start_pv();
    if (wg == 0) named_bar_arrive(4, 256);
    wgmma_wait<0>();
    fence_regs(o);

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (wq0 + r0 < S) {
        *reinterpret_cast<uint32_t*>(O + (size_t)(wq0 + r0) * 64 + col) =
            pack_bf16(o[4 * j + 0] / l0, o[4 * j + 1] / l0);
      }
      if (wq0 + r1 < S) {
        *reinterpret_cast<uint32_t*>(O + (size_t)(wq0 + r1) * 64 + col) =
            pack_bf16(o[4 * j + 2] / l1, o[4 * j + 3] / l1);
      }
    }
  }
}

// -------------------------------------------------------------------- launch

constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on sm_90

// The wgmma kernel's shared memory: tiles and barriers (1024 bytes to align
// the tiles), and with `staged` both factors' rows of the block's queries.
size_t wgmma_smem(bool staged, int Hk, int Wk) {
  size_t smem = 1024 + WG_FACTOR_OFFSET;
  if (staged) smem += (size_t)WG_BQ * (factor_pitch(Hk) + factor_pitch(Wk)) * 2;
  return smem;
}

// Which kernel a launch takes: a function of dtype, D, S, Hk and Wk alone.
enum Path {
  PATH_NONE = 0,
  PATH_SIMT_F32 = 1,
  PATH_MMA_TILED = 2,
  PATH_MMA_WINDOW = 3,
  PATH_WGMMA = 4,
  PATH_WGMMA_FOLDED = 5,  // never chosen by shape: d2t_flash_attn_fwd_folded asks for it
};

int choose_path(int dtype, int S, int D, bool has_bias, int Hk, int Wk) {
  if (dtype == 0) return PATH_SIMT_F32;
  if (D != 64) return PATH_MMA_TILED;
  if (S <= WIN_MAX_S && (!has_bias || Hk + Wk <= WIN_EXT)) return PATH_MMA_WINDOW;
  // indexed factors (a Wk other than 32 and 64) of 128 queries must fit
  if (has_bias && Wk != 32 && Wk != 64 && wgmma_smem(true, Hk, Wk) > MAX_SMEM) return PATH_MMA_TILED;
  return PATH_WGMMA;
}

template <int D>
int launch_tiled(const Params& p, int B, int dtype, cudaStream_t stream) {
  const size_t elem = dtype == 0 ? 4 : 2;
  size_t smem = dtype == 0 ? (size_t)(3 * 64 * (D + 1) + BQ * (BK + 1)) * 4
                           : (size_t)(5 * 64 * (D + 8)) * 2;
  smem += BK * sizeof(int);
  if (p.rel_h != nullptr) smem += (size_t)BQ * (factor_pitch(p.Hk) + factor_pitch(p.Wk)) * elem;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * p.n_qt;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_f32_kernel<D><<<(unsigned)blocks, THREADS, smem, stream>>>(p);
  } else {
    err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_bf16_kernel<D><<<(unsigned)blocks, THREADS, smem, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <int NKT, bool BIAS>
int launch_window_as(const Params& p, int B, cudaStream_t stream) {
  size_t smem = (size_t)16 * NKT * (2 * WIN_PITCH + (BIAS ? WIN_EPITCH : 0)) * 2;
  if (BIAS) smem += (size_t)(((p.S * p.Hk + 1) & ~1) + p.S * p.Wk) * 2;  // the factors' copies
  cudaError_t err = cudaFuncSetAttribute(flash_window_bf16_kernel<NKT, BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_window_bf16_kernel<NKT, BIAS><<<(unsigned)B, 32 * win_warps(NKT), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch_window(const Params& p, int B, cudaStream_t stream) {
  const bool bias = p.rel_h != nullptr;
  if (p.S <= 64) return bias ? launch_window_as<4, true>(p, B, stream) : launch_window_as<4, false>(p, B, stream);
  if (p.S <= 128) return bias ? launch_window_as<8, true>(p, B, stream) : launch_window_as<8, false>(p, B, stream);
  return bias ? launch_window_as<13, true>(p, B, stream) : launch_window_as<13, false>(p, B, stream);
}

// cuTensorMapEncodeTiled belongs to libcuda, which this library does not link:
// the entry point comes from the runtime.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault) != cudaSuccess) {
      ptr = nullptr;
    }
    return reinterpret_cast<EncodeTiledFn>(ptr);
  }();
  return fn;
}

// [B][S][64] bf16 as a 3-D map with boxes of [1][128][64], 128-byte swizzled:
// a box that runs past S is filled with zeros, never with the next
// batch-head's rows.
int make_tile_map(CUtensorMap* map, const void* ptr, int B, int S) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {64, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {128, (cuuint64_t)S * 128};
  const cuuint32_t box[3] = {64, WG_BK, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                              strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BIAS, int LOG2_WK>
int launch_wgmma_as(const CUtensorMap& map_k, const CUtensorMap& map_v, const Params& p,
                    unsigned blocks, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_bf16_kernel<BIAS, LOG2_WK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_wgmma_bf16_kernel<BIAS, LOG2_WK><<<blocks, WG_THREADS, smem, stream>>>(map_k, map_v, p);
  return (int)cudaGetLastError();
}

int launch_wgmma(Params p, int B, cudaStream_t stream, bool fold) {
  const bool bias = p.rel_h != nullptr;
  // the w terms stay in registers when Wk is 32 or 64
  const int log2_wk = !bias ? 0 : p.Wk == 32 ? 5 : p.Wk == 64 ? 6 : 0;
  p.n_qt = (p.S + WG_BQ - 1) / WG_BQ;
  const size_t smem = fold ? (size_t)1024 + WG_FOLD_OFFSET + WG_FOLD_BYTES
                           : wgmma_smem(bias && log2_wk == 0, p.Hk, p.Wk);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * p.n_qt;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  CUtensorMap map_k, map_v;
  int err = make_tile_map(&map_k, p.k, B, p.S);
  if (err == 0) err = make_tile_map(&map_v, p.v, B, p.S);
  if (err != 0) return err;
  const unsigned n = (unsigned)blocks;
  if (!bias) return launch_wgmma_as<0, 0>(map_k, map_v, p, n, smem, stream);
  if (fold) return launch_wgmma_as<3, 0>(map_k, map_v, p, n, smem, stream);
  switch (log2_wk) {
    case 5:
      return launch_wgmma_as<1, 5>(map_k, map_v, p, n, smem, stream);
    case 6:
      return launch_wgmma_as<1, 6>(map_k, map_v, p, n, smem, stream);
    default:
      return launch_wgmma_as<2, 0>(map_k, map_v, p, n, smem, stream);
  }
}

int run(const void* q, const void* k, const void* v, const void* rel_h, const void* rel_w,
        void* out, int B, int S, int D, int Hk, int Wk, float scale, int dtype, bool transposed,
        void* stream, int* path, bool fold = false) {
  if (path != nullptr) *path = PATH_NONE;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (D < 32 || D > 128 || D % 16 != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0) return 0;
  const bool has_bias = rel_h != nullptr && rel_w != nullptr;
  // the key table packs j / Wk and j % Wk into 16 bits each
  if (has_bias && (Hk <= 0 || Wk <= 0 || Hk > 32767 || Wk > 32767 || (long long)Hk * Wk != S)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.rel_h = has_bias ? rel_h : nullptr;
  p.rel_w = has_bias ? rel_w : nullptr;
  p.out = out;
  p.S = S;
  p.Hk = has_bias ? Hk : 1;
  p.Wk = has_bias ? Wk : 1;
  p.n_qt = (S + BQ - 1) / BQ;
  if (transposed) {  // [B, Hk, S], [B, Wk, S]
    p.h_sq = 1;
    p.h_sh = S;
    p.w_sq = 1;
    p.w_sh = S;
  } else {  // [B, S, Hk], [B, S, Wk]
    p.h_sq = p.Hk;
    p.h_sh = 1;
    p.w_sq = p.Wk;
    p.w_sh = 1;
  }
  p.q_fast = transposed ? 1 : 0;
  p.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (fold) {  // asked for by name, for the shapes it is made for
    if (dtype != 1 || D != 64 || !has_bias || Wk != 64 || Hk > 64) return (int)cudaErrorInvalidValue;
    if (path != nullptr) *path = PATH_WGMMA_FOLDED;
    return launch_wgmma(p, B, st, true);
  }
  const int chosen = choose_path(dtype, S, D, has_bias, p.Hk, p.Wk);
  if (path != nullptr) *path = chosen;
  switch (chosen) {
    case PATH_MMA_WINDOW:
      return launch_window(p, B, st);
    case PATH_WGMMA:
      return launch_wgmma(p, B, st, false);
    default:
      break;
  }
  switch (D) {
    case 32:
      return launch_tiled<32>(p, B, dtype, st);
    case 48:
      return launch_tiled<48>(p, B, dtype, st);
    case 64:
      return launch_tiled<64>(p, B, dtype, st);
    case 80:
      return launch_tiled<80>(p, B, dtype, st);
    case 96:
      return launch_tiled<96>(p, B, dtype, st);
    case 112:
      return launch_tiled<112>(p, B, dtype, st);
    case 128:
      return launch_tiled<128>(p, B, dtype, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: [B, S, D] contiguous, D a multiple of 16 from 32 to 128; rel_h [B, S, Hk] and
// rel_w [B, S, Wk] contiguous with Hk * Wk == S, or both null for no bias;
// everything in one dtype: 0 float32, 1 bfloat16 (pointers 16-byte aligned).
// Returns the cudaError of the launch (0 on success) and writes the kernel
// the shape was dispatched to (a Path) to *path.
extern "C" int d2t_flash_attn_fwd(const void* q, const void* k, const void* v, const void* rel_h,
                                  const void* rel_w, void* out, int B, int S, int D, int Hk,
                                  int Wk, float scale, int dtype, void* stream, int* path) {
  return run(q, k, v, rel_h, rel_w, out, B, S, D, Hk, Wk, scale, dtype, false, stream, path);
}

// The same function with the factors transposed: rel_ht [B, Hk, S] and
// rel_wt [B, Wk, S].
extern "C" int d2t_flash_attn_fwd_t(const void* q, const void* k, const void* v,
                                    const void* rel_ht, const void* rel_wt, void* out, int B,
                                    int S, int D, int Hk, int Wk, float scale, int dtype,
                                    void* stream, int* path) {
  return run(q, k, v, rel_ht, rel_wt, out, B, S, D, Hk, Wk, scale, dtype, true, stream, path);
}

// d2t_flash_attn_fwd through the wgmma kernel with the bias folded into the
// first product, for bfloat16, D = 64, Wk = 64 and Hk <= 64 only (anything else
// is refused): the other way to the same function, kept so that one run can
// time both at the ViTDet-B global shape. No shape is dispatched to it.
extern "C" int d2t_flash_attn_fwd_folded(const void* q, const void* k, const void* v,
                                         const void* rel_h, const void* rel_w, void* out, int B,
                                         int S, int D, int Hk, int Wk, float scale, int dtype,
                                         void* stream, int* path) {
  return run(q, k, v, rel_h, rel_w, out, B, S, D, Hk, Wk, scale, dtype, false, stream, path, true);
}
