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
// reach device memory: one block owns 64 queries of one batch-head, walks the
// keys in tiles of 64 and keeps the running maximum, the running sum and the
// output accumulator in float32 (online softmax). As in the TPU kernel, q is
// multiplied by `scale` in q's dtype, score and bias add in float32, the
// probabilities are cast to v's dtype before the second product when that
// runs on tensor cores, and the division by the sum comes last.
//
// What the TPU kernel did for Mosaic's sake is not carried over: its 0/1
// selection matmuls rebuild the bias tile because Mosaic cannot reshape or
// lane-slice in registers; here the block stages its 64 rows of both factors
// in shared memory once and the bias of key j is two indexed loads,
// rel_h[i][j / Wk] + rel_w[i][j % Wk], with j / Wk and j % Wk tabulated once
// per key tile. The two entry points differ only in the strides they hand to
// that staging loop: the transposed layout makes its global loads contiguous
// along the queries. S need not divide a tile: tail keys score -inf, tail
// queries are computed and not stored.
//
// What bounds it on the card: for the ViTDet-B global blocks ([96, 4096, 64],
// 4 * S^2 * D = 412 GFLOP a launch against 0.3 GB moved) the tensor cores;
// for the windowed blocks ([2400, 196, 64], 24 GFLOP against 0.27 GB) the
// memory. bfloat16 runs both products on the tensor cores with
// mma.sync.m16n8k16 (f32 accumulation): each of the block's 4 warps owns 16
// queries, keeps q as A fragments in registers for the whole key loop, and
// reuses the score accumulators as the A fragments of the second product, so
// the probabilities never leave registers; k and v fragments come through
// ldmatrix (v transposed), and the next key tile is copied with cp.async
// into a second stage under the current tile's arithmetic. With the bias the
// limit inside the SM is shared-memory bandwidth, so for an even Wk a
// thread fetches the bias of its two adjacent keys as one h value and one
// 32-bit w pair from rows pitched to distinct banks. float32 inputs (the
// comparison runs) take a plain SIMT path with 4x8 register tiles. wgmma,
// TMA, warp specialisation and a schedule that does not waste the tiles past
// S (196 = 3 x 64 + 4) are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no -fmad=false: nothing here depends on op-by-op
//        rounding).

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

// Stage rows q0..q0+63 of one factor ([.., n] per query) into dst[64][pitch].
template <typename T>
__device__ void load_factor(T* dst, int pitch, const T* src, int q0, int S, int n, long long sq,
                            long long sh, int q_fast) {
  const int total = BQ * n;
  for (int idx = threadIdx.x; idx < total; idx += THREADS) {
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
    load_factor<bf16>(rh_s, pitch_h, RH, q0, S, p.Hk, p.h_sq, p.h_sh, p.q_fast);
    load_factor<bf16>(rw_s, pitch_w, RW, q0, S, p.Wk, p.w_sq, p.w_sh, p.q_fast);
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
    load_factor<float>(rh_s, pitch_h, RH, q0, S, p.Hk, p.h_sq, p.h_sh, p.q_fast);
    load_factor<float>(rw_s, pitch_w, RW, q0, S, p.Wk, p.w_sq, p.w_sh, p.q_fast);
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

// -------------------------------------------------------------------- launch

constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on sm_90

template <int D>
int launch(const Params& p, int B, int dtype, cudaStream_t stream) {
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

int run(const void* q, const void* k, const void* v, const void* rel_h, const void* rel_w,
        void* out, int B, int S, int D, int Hk, int Wk, float scale, int dtype, bool transposed,
        void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
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
  switch (D) {
    case 32:
      return launch<32>(p, B, dtype, st);
    case 64:
      return launch<64>(p, B, dtype, st);
    case 128:
      return launch<128>(p, B, dtype, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: [B, S, D] contiguous, D in {32, 64, 128}; rel_h [B, S, Hk] and
// rel_w [B, S, Wk] contiguous with Hk * Wk == S, or both null for no bias;
// everything in one dtype: 0 float32, 1 bfloat16 (pointers 16-byte aligned).
// Returns the cudaError of the launch (0 on success).
extern "C" int d2t_flash_attn_fwd(const void* q, const void* k, const void* v, const void* rel_h,
                                  const void* rel_w, void* out, int B, int S, int D, int Hk,
                                  int Wk, float scale, int dtype, void* stream) {
  return run(q, k, v, rel_h, rel_w, out, B, S, D, Hk, Wk, scale, dtype, false, stream);
}

// The same function with the factors transposed: rel_ht [B, Hk, S] and
// rel_wt [B, Wk, S].
extern "C" int d2t_flash_attn_fwd_t(const void* q, const void* k, const void* v,
                                    const void* rel_ht, const void* rel_wt, void* out, int B,
                                    int S, int D, int Hk, int Wk, float scale, int dtype,
                                    void* stream) {
  return run(q, k, v, rel_ht, rel_wt, out, B, S, D, Hk, Wk, scale, dtype, true, stream);
}
