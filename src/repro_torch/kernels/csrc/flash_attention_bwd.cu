// flash_attention_bwd for Hopper (sm_90a): the gradient of the causal GQA
// attention forward in flash_attention.cu, recomputing each tile's
// probabilities from the forward's log-sum-exp, so no (S, S) scores are
// ever stored.
//
//   q, dq (B, S, H, d); k, v, dk, dv (B, S, Hkv, d); o, do (B, S, H, d);
//   lse (B, H, S) float32: the natural log-sum-exp of each row's scaled
//   scores, as the forward writes it. float32 or bfloat16 in and out; every
//   product sums in float32; scale 1/sqrt(d); query head h reads KV head
//   h / G, G = H / Hkv.
//
// Replaces the gradient of the TPU kernel src/repro/kernels/flash_attention.py:63,
// whose JAX twin is the custom VJP of flash_attention_jnp
// (src/repro/models/layers.py:216, backward rule _flash_bwd_rule at :235):
// for each kv chunk it recomputes s = q k^T * scale (masked), p = exp(s - lse),
// then dv += p^T do with p in float32, dp = do v^T, ds = p (dp - delta) scale
// with delta = rowsum(do * o), dq += ds k and dk += ds^T q with ds cast to the
// input's type. This file does the same arithmetic, but for dv in bfloat16,
// where P is rounded to bfloat16 for the tensor cores (2^-9 of each term;
// the card holds dv to the plain version within 1e-2 of its norm).
//
// Bound on an H100 SXM. The gradient needs four products of d terms for each
// visible (query, key) pair (dv, dp, dq, dk), twice the forward's two:
//   operations 8 * B * H * d * S(S+1)/2
//   bytes      itemsize * B * S * d * (4H + 4Hkv) + 4 * B * H * S
//              (q, o, do, dq; k, v, dk, dv; lse once each)
// At qwen3-0.6b's training shape B=4, S=2048 (H=16, Hkv=8, d=128): 1.375e11
// operations, 0.139 ms at 989 TFLOP/s in bfloat16 (2.05 ms at 67 TFLOP/s
// in float32), against 0.03 ms for the bytes: bound by operations. The
// recompute of S (in both kernels) and of dp (in the dq kernel) are three
// more products a pair, overhead above that bound.
//
// Design: FlashAttention-2's backward without atomics, so the gradients are
// the same from run to run. Rows are the forward's: the G query heads of a
// KV head are folded into the rows, row R = position * G + head (the heads
// of a position are adjacent in memory), so one K/V tile serves all G heads
// and dk, dv sum over them inside one block. Three kernels on the caller's
// stream:
//   (a) delta = rowsum(do * o) in float32, a warp a row, into the caller's
//       scratch (B, H, S);
//   (b) dk/dv: one block per (64-key tile, KV head, batch row); it loops
//       over the 64-row q tiles at or after its first key, recomputes
//       P^T = exp(scale K Q^T - lse) and dP^T = V dO^T, and accumulates
//       dV += P^T dO and dK += dS^T Q in registers;
//   (c) dq: one block per (64-row q tile, KV head, batch row); it loops over
//       the key tiles up to its last position, recomputes P and dP, and
//       accumulates dQ += dS K in registers.
// Keys and rows past S are staged as zeros and masked, so any S >= 1 works.
// Two routes share this scheme:
//   * bfloat16, the training path: every product on the tensor cores by
//     mma.sync m16n8k16 (bf16 in, float32 sums), 4 warps a block, each
//     owning 16 rows of the block's tile; P and dS go from the float32
//     accumulators to the next product's A operand in registers (see the
//     bfloat16 section). Shared memory 70,144 B a block. Tiles are loaded
//     synchronously and the diagonal's masked products are computed:
//     wgmma, TMA and a pipelined ring are later work;
//   * float32: the CUDA cores (float32 FMAs), because float32 is held to
//     1e-4, which the tensor cores' TF32 cannot meet: 256 threads as
//     16 x 16, tiles staged in shared memory as float32 (rows padded to 132
//     floats), a thread holding a 4 x 4 block of a score tile and 4 rows x
//     8 columns of its accumulators; dk/dv 170,496 B, dq 153,088 B of
//     shared memory, one block of 256 threads an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int D = 128;          // head width
constexpr int BR = 64;          // rows (position x head) a q tile
constexpr int BK = 64;          // keys a kv tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int QS = D + 4;       // row stride (floats) of a staged (64, 128) tile
constexpr int PS = 64 + 4;      // row stride of a staged (64, 64) tile
constexpr size_t TILE = (size_t)64 * QS;
constexpr size_t SMEM_DKDV = sizeof(float) * (4 * TILE + 2 * (size_t)64 * PS + 2 * 64);
constexpr size_t SMEM_DQ = sizeof(float) * (4 * TILE + (size_t)64 * PS + 2 * 64);

__device__ __forceinline__ float4 load4f(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4f(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4f(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Stages 64 rows of 128 values into dst (row stride QS) as float32: row i is
// global row R = r0 + i of the (position, head) rows of one KV head when
// heads > 1 (q, do), or position r0 + i when heads == 1 (k, v); rows past
// n_rows are zeros. base points at (b, position 0, first head of the group);
// a position is pos_stride elements.
__device__ __forceinline__ void stage_rows(float* dst, const float* base, int r0, int n_rows,
                                           int g_shift, size_t pos_stride) {
  const int G = 1 << g_shift;
#pragma unroll 4
  for (int c = threadIdx.x; c < 64 * D / 4; c += THREADS) {
    const int i = c / (D / 4), col = (c % (D / 4)) * 4;
    const int R = r0 + i;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (R < n_rows) x = load4f(base + (size_t)(R >> g_shift) * pos_stride + (R & (G - 1)) * D + col);
    store4f(dst + i * QS + col, x);
  }
}

// lse and delta of 64 rows starting at global row r0 (0 past n_rows)
__device__ __forceinline__ void stage_row_stats(float* lse_s, float* delta_s, const float* lse,
                                                const float* delta, int b, int kvh, int H, int S,
                                                int r0, int n_rows, int g_shift) {
  const int i = threadIdx.x;
  if (i < 64) {
    const int R = r0 + i;
    float l = 0.f, dl = 0.f;
    if (R < n_rows) {
      const int G = 1 << g_shift;
      const size_t idx = ((size_t)b * H + kvh * G + (R & (G - 1))) * S + (R >> g_shift);
      l = lse[idx];
      dl = delta[idx];
    }
    lse_s[i] = l;
    delta_s[i] = dl;
  }
}

// (a) delta[b, h, s] = sum_c do[b, s, h, c] * o[b, s, h, c] in float32: a warp a row
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int B, int S, int H) {
  const size_t row = (size_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= (size_t)B * S * H) return;
  const float4 a = load4f(o + row * D + lane * 4);
  const float4 g = load4f(dout + row * D + lane * 4);
  float x = dot4(a, g, 0.f);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  if (lane == 0) {                    // row = (b * S + s) * H + h
    const int h = (int)(row % H);
    const size_t bs = row / H;
    const int s = (int)(bs % S);
    const size_t b = bs / S;
    delta[(b * H + h) * S + s] = x;
  }
}

// ----------------------------------------------------------- float32 route --

// (b) dk, dv of one 64-key tile of one KV head: loops over the q tiles
// whose rows reach its keys
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                      int S, int H, int Hkv, int g_shift, float scale) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // (64 keys, QS)
  float* vs = ks + TILE;
  float* qs = vs + TILE;                         // (64 rows, QS)
  float* dos = qs + TILE;
  float* pts = dos + TILE;                       // P^T (64 keys, PS)
  float* dsts = pts + 64 * PS;                   // dS^T (64 keys, PS)
  float* lse_s = dsts + 64 * PS;
  float* delta_s = lse_s + 64;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = 1 << g_shift;
  const int k0 = kt * BK;
  const int n_rows = S * G;
  const size_t q_row = (size_t)H * D, kv_row = (size_t)Hkv * D;
  const float* qb = q + (size_t)b * S * q_row + (size_t)kvh * G * D;
  const float* dob = dout + (size_t)b * S * q_row + (size_t)kvh * G * D;
  const float* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
  const float* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;

  stage_rows(ks, kb, k0, S, 0, kv_row);
  stage_rows(vs, vb, k0, S, 0, kv_row);

  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  // rows at positions >= k0 see some key of the tile: the first such tile
  const int t_first = (k0 * G) / BR;
  const int n_tiles = (n_rows + BR - 1) / BR;
  for (int t = t_first; t < n_tiles; ++t) {
    const int r0 = t * BR;
    __syncthreads();                             // the last tile is read out
    stage_rows(qs, qb, r0, n_rows, g_shift, q_row);
    stage_rows(dos, dob, r0, n_rows, g_shift, q_row);
    stage_row_stats(lse_s, delta_s, lse, delta, b, kvh, H, S, r0, n_rows, g_shift);
    __syncthreads();

    // S^T (key j, row i) and dP^T for j = ty + 16 a, i = tx + 16 c
    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 4) {
      float4 kf[4], vf[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        kf[a] = load4f(ks + (ty + 16 * a) * QS + kk);
        vf[a] = load4f(vs + (ty + 16 * a) * QS + kk);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 qf = load4f(qs + (tx + 16 * c) * QS + kk);
        const float4 gf = load4f(dos + (tx + 16 * c) * QS + kk);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          s[a][c] = dot4(kf[a], qf, s[a][c]);
          dp[a][c] = dot4(vf[a], gf, dp[a][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = tx + 16 * c, R = r0 + i;
      const int pos = R >> g_shift;
      const bool row_ok = R < n_rows;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = ty + 16 * a, key = k0 + j;
        float p = 0.f;
        if (row_ok && key < S && key <= pos) p = expf(s[a][c] * scale - lse_s[i]);
        const float ds = p * (dp[a][c] - delta_s[i]) * scale;
        pts[j * PS + i] = p;
        dsts[j * PS + i] = ds;
      }
    }
    __syncthreads();

    // dV (key j, col) += sum_i P^T[j][i] dO[i][col]; dK += dS^T[j][i] Q[i][col]
    // for j = ty + 16 a and col = 4 tx .. 4 tx + 3, 64 + 4 tx .. 64 + 4 tx + 3
#pragma unroll 2
    for (int i = 0; i < BR; i += 4) {
      float4 pf[4], df[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pf[a] = load4f(pts + (ty + 16 * a) * PS + i);
        df[a] = load4f(dsts + (ty + 16 * a) * PS + i);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float4 g0 = load4f(dos + (i + ii) * QS + 4 * tx);
        const float4 g1 = load4f(dos + (i + ii) * QS + 64 + 4 * tx);
        const float4 q0v = load4f(qs + (i + ii) * QS + 4 * tx);
        const float4 q1v = load4f(qs + (i + ii) * QS + 64 + 4 * tx);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float p = ii == 0 ? pf[a].x : ii == 1 ? pf[a].y : ii == 2 ? pf[a].z : pf[a].w;
          const float d = ii == 0 ? df[a].x : ii == 1 ? df[a].y : ii == 2 ? df[a].z : df[a].w;
          dv_acc[a][0] = fmaf(p, g0.x, dv_acc[a][0]);
          dv_acc[a][1] = fmaf(p, g0.y, dv_acc[a][1]);
          dv_acc[a][2] = fmaf(p, g0.z, dv_acc[a][2]);
          dv_acc[a][3] = fmaf(p, g0.w, dv_acc[a][3]);
          dv_acc[a][4] = fmaf(p, g1.x, dv_acc[a][4]);
          dv_acc[a][5] = fmaf(p, g1.y, dv_acc[a][5]);
          dv_acc[a][6] = fmaf(p, g1.z, dv_acc[a][6]);
          dv_acc[a][7] = fmaf(p, g1.w, dv_acc[a][7]);
          dk_acc[a][0] = fmaf(d, q0v.x, dk_acc[a][0]);
          dk_acc[a][1] = fmaf(d, q0v.y, dk_acc[a][1]);
          dk_acc[a][2] = fmaf(d, q0v.z, dk_acc[a][2]);
          dk_acc[a][3] = fmaf(d, q0v.w, dk_acc[a][3]);
          dk_acc[a][4] = fmaf(d, q1v.x, dk_acc[a][4]);
          dk_acc[a][5] = fmaf(d, q1v.y, dk_acc[a][5]);
          dk_acc[a][6] = fmaf(d, q1v.z, dk_acc[a][6]);
          dk_acc[a][7] = fmaf(d, q1v.w, dk_acc[a][7]);
        }
      }
    }
  }

  float* dkb = dk + (size_t)b * S * kv_row + (size_t)kvh * D;
  float* dvb = dv + (size_t)b * S * kv_row + (size_t)kvh * D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key < S) {
      const size_t off = (size_t)key * kv_row;
      store4f(dkb + off + 4 * tx, make_float4(dk_acc[a][0], dk_acc[a][1], dk_acc[a][2], dk_acc[a][3]));
      store4f(dkb + off + 64 + 4 * tx,
              make_float4(dk_acc[a][4], dk_acc[a][5], dk_acc[a][6], dk_acc[a][7]));
      store4f(dvb + off + 4 * tx, make_float4(dv_acc[a][0], dv_acc[a][1], dv_acc[a][2], dv_acc[a][3]));
      store4f(dvb + off + 64 + 4 * tx,
              make_float4(dv_acc[a][4], dv_acc[a][5], dv_acc[a][6], dv_acc[a][7]));
    }
  }
}

// (c) dq of one 64-row q tile of one KV head: loops over the key tiles up
// to its last position
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq, int S, int H, int Hkv,
                    int g_shift, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // (64 rows, QS)
  float* dos = qs + TILE;
  float* ks = dos + TILE;                        // (64 keys, QS)
  float* vs = ks + TILE;
  float* dss = vs + TILE;                        // dS (64 rows, PS)
  float* lse_s = dss + 64 * PS;
  float* delta_s = lse_s + 64;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int t = gridDim.x - 1 - blockIdx.x;      // the longest rows first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = 1 << g_shift;
  const int n_rows = S * G;
  const int r0 = t * BR;
  const size_t q_row = (size_t)H * D, kv_row = (size_t)Hkv * D;
  const float* qb = q + (size_t)b * S * q_row + (size_t)kvh * G * D;
  const float* dob = dout + (size_t)b * S * q_row + (size_t)kvh * G * D;
  const float* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
  const float* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;

  stage_rows(qs, qb, r0, n_rows, g_shift, q_row);
  stage_rows(dos, dob, r0, n_rows, g_shift, q_row);
  stage_row_stats(lse_s, delta_s, lse, delta, b, kvh, H, S, r0, n_rows, g_shift);

  float dq_acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) dq_acc[a][c] = 0.f;

  const int last_pos = min(r0 + BR - 1, n_rows - 1) >> g_shift;
  const int n_kt = last_pos / BK + 1;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                             // the last tile is read out
    stage_rows(ks, kb, k0, S, 0, kv_row);
    stage_rows(vs, vb, k0, S, 0, kv_row);
    __syncthreads();

    // S (row i, key j) and dP for i = ty + 16 a, j = tx + 16 c
    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 4) {
      float4 qf[4], gf[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qf[a] = load4f(qs + (ty + 16 * a) * QS + kk);
        gf[a] = load4f(dos + (ty + 16 * a) * QS + kk);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 kf = load4f(ks + (tx + 16 * c) * QS + kk);
        const float4 vf = load4f(vs + (tx + 16 * c) * QS + kk);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          s[a][c] = dot4(qf[a], kf, s[a][c]);
          dp[a][c] = dot4(gf[a], vf, dp[a][c]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a, R = r0 + i;
      const int pos = R >> g_shift;
      const bool row_ok = R < n_rows;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c, key = k0 + j;
        float p = 0.f;
        if (row_ok && key < S && key <= pos) p = expf(s[a][c] * scale - lse_s[i]);
        dss[i * PS + j] = p * (dp[a][c] - delta_s[i]) * scale;
      }
    }
    __syncthreads();

    // dQ (row i, col) += sum_j dS[i][j] K[j][col] for i = ty + 16 a
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 df[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) df[a] = load4f(dss + (ty + 16 * a) * PS + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 k0v = load4f(ks + (j + jj) * QS + 4 * tx);
        const float4 k1v = load4f(ks + (j + jj) * QS + 64 + 4 * tx);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float d = jj == 0 ? df[a].x : jj == 1 ? df[a].y : jj == 2 ? df[a].z : df[a].w;
          dq_acc[a][0] = fmaf(d, k0v.x, dq_acc[a][0]);
          dq_acc[a][1] = fmaf(d, k0v.y, dq_acc[a][1]);
          dq_acc[a][2] = fmaf(d, k0v.z, dq_acc[a][2]);
          dq_acc[a][3] = fmaf(d, k0v.w, dq_acc[a][3]);
          dq_acc[a][4] = fmaf(d, k1v.x, dq_acc[a][4]);
          dq_acc[a][5] = fmaf(d, k1v.y, dq_acc[a][5]);
          dq_acc[a][6] = fmaf(d, k1v.z, dq_acc[a][6]);
          dq_acc[a][7] = fmaf(d, k1v.w, dq_acc[a][7]);
        }
      }
    }
  }

  float* dqb = dq + (size_t)b * S * q_row + (size_t)kvh * G * D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int R = r0 + ty + 16 * a;
    if (R < n_rows) {
      float* dst = dqb + (size_t)(R >> g_shift) * q_row + (R & (G - 1)) * D;
      store4f(dst + 4 * tx, make_float4(dq_acc[a][0], dq_acc[a][1], dq_acc[a][2], dq_acc[a][3]));
      store4f(dst + 64 + 4 * tx,
              make_float4(dq_acc[a][4], dq_acc[a][5], dq_acc[a][6], dq_acc[a][7]));
    }
  }
}

// ---------------------------------------------------------- bfloat16 route --
//
// The same two kernels with every product on the tensor cores: mma.sync
// m16n8k16 (bf16 in, float32 sums), 4 warps a block, each warp owning 16
// rows of the block's tile (keys in dk/dv, query rows in dq). Tiles are
// staged in shared memory as bf16 with rows padded to 136 values (272
// bytes), so the 8 row addresses of each ldmatrix fall in distinct banks.
// A operands come by ldmatrix (K, V, Q, dO rows) or from the float32
// accumulators of the previous product, packed to bf16 pairs (P^T, dS^T,
// dS: the C fragment of m16n8 is the A fragment of m16n8k16); B operands by
// ldmatrix from row-major tiles, transposed (.trans) where the product runs
// over the tile's rows. dv takes P rounded to bfloat16 (the reference keeps
// p in float32 there); dq and dk take dS in bfloat16, as the reference does.

constexpr int MMA_THREADS = 128;   // 4 warps
constexpr int HS = D + 8;          // row stride (bf16 values) of a staged tile
constexpr int MMA_TILE = 64 * HS;  // bf16 values of a staged (64, 128) tile
constexpr size_t SMEM_MMA = sizeof(__nv_bfloat16) * 4 * (size_t)MMA_TILE + sizeof(float) * 2 * 64;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (16 x 8, float32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// shared-memory byte address of element (row, col) of a staged tile
__device__ __forceinline__ uint32_t at(uint32_t tile, int row, int col) {
  return tile + (uint32_t)(row * HS + col) * 2u;
}
// A fragment (rows row0..row0+15, k0..k0+15) of a row-major tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t tile, int row0, int k0,
                                       int lane) {
  ldsm_x4(a, at(tile, row0 + (lane & 15), k0 + (lane >> 4) * 8));
}
// B fragments of two n-tiles (n0..n0+15) for k0..k0+15, the tile holding B
// transposed ([n][k], rows n): b[0], b[1] for n0..n0+7, b[2], b[3] for n0+8..
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], uint32_t tile, int n0, int k0,
                                        int lane) {
  ldsm_x4(b, at(tile, n0 + (lane >> 4) * 8 + (lane & 7), k0 + ((lane >> 3) & 1) * 8));
}
// the same where the tile holds B as is ([k][n], rows k)
__device__ __forceinline__ void load_b(uint32_t (&b)[4], uint32_t tile, int k0, int n0,
                                       int lane) {
  ldsm_x4_t(b, at(tile, k0 + ((lane >> 3) & 1) * 8 + (lane & 7), n0 + (lane >> 4) * 8));
}

// Stages 64 rows of 128 bf16 into a tile (row stride HS): row i is global
// row R = r0 + i (position R >> g_shift, head R & (G - 1) of the KV head's
// group); rows past n_rows are zeros.
__device__ __forceinline__ void stage_rows_bf16(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                                int r0, int n_rows, int g_shift,
                                                size_t pos_stride) {
  const int G = 1 << g_shift;
#pragma unroll
  for (int c = threadIdx.x; c < 64 * D / 8; c += MMA_THREADS) {
    const int i = c / (D / 8), col = (c % (D / 8)) * 8;
    const int R = r0 + i;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (R < n_rows)
      x = *reinterpret_cast<const uint4*>(base + (size_t)(R >> g_shift) * pos_stride +
                                          (R & (G - 1)) * D + col);
    *reinterpret_cast<uint4*>(dst + i * HS + col) = x;
  }
}

// (b) dk, dv of one 64-key tile: warp w owns keys 16 w .. 16 w + 15; each
// 64-row q tile runs in two halves of 32 rows: S^T and dP^T (16 keys x 32
// rows) by 8 k-steps over the head dim, then dV += P^T dO and dK += dS^T Q
// by 2 k-steps over the rows
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int S, int H, int Hkv, int g_shift,
                          float scale) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* vs = ks + MMA_TILE;
  __nv_bfloat16* qs = vs + MMA_TILE;
  __nv_bfloat16* dos = qs + MMA_TILE;
  float* lse_s = reinterpret_cast<float*>(dos + MMA_TILE);
  float* delta_s = lse_s + 64;
  const uint32_t ks_a = (uint32_t)__cvta_generic_to_shared(ks);
  const uint32_t vs_a = (uint32_t)__cvta_generic_to_shared(vs);
  const uint32_t qs_a = (uint32_t)__cvta_generic_to_shared(qs);
  const uint32_t dos_a = (uint32_t)__cvta_generic_to_shared(dos);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = 1 << g_shift;
  const int k0 = kt * BK;
  const int n_rows = S * G;
  const size_t q_row = (size_t)H * D, kv_row = (size_t)Hkv * D;
  const __nv_bfloat16* qb = q + (size_t)b * S * q_row + (size_t)kvh * G * D;
  const __nv_bfloat16* dob = dout + (size_t)b * S * q_row + (size_t)kvh * G * D;

  stage_rows_bf16(ks, k + (size_t)b * S * kv_row + (size_t)kvh * D, k0, S, 0, kv_row);
  stage_rows_bf16(vs, v + (size_t)b * S * kv_row + (size_t)kvh * D, k0, S, 0, kv_row);

  float dk_acc[16][4], dv_acc[16][4];   // 16 keys x 128 dims: n-tiles of 8 dims
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[n][c] = dv_acc[n][c] = 0.f;

  const int key_lo = k0 + 16 * warp + g, key_hi = key_lo + 8;   // this lane's keys
  const int t_first = (k0 * G) / BR;
  const int n_tiles = (n_rows + BR - 1) / BR;
  for (int t = t_first; t < n_tiles; ++t) {
    const int r0 = t * BR;
    __syncthreads();                             // the last tile is read out
    stage_rows_bf16(qs, qb, r0, n_rows, g_shift, q_row);
    stage_rows_bf16(dos, dob, r0, n_rows, g_shift, q_row);
    stage_row_stats(lse_s, delta_s, lse, delta, b, kvh, H, S, r0, n_rows, g_shift);
    __syncthreads();

#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int i0 = 32 * half;                  // the half's first row in the tile
      float s[4][4], dp[4][4];                   // 16 keys x 32 rows: n-tiles of 8 rows
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_a(ka, ks_a, 16 * warp, 16 * kk, lane);
        load_a(va, vs_a, 16 * warp, 16 * kk, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t qb4[4], gb4[4];
          load_bt(qb4, qs_a, i0 + 16 * np, 16 * kk, lane);
          load_bt(gb4, dos_a, i0 + 16 * np, 16 * kk, lane);
          mma_bf16(s[2 * np], ka, qb4[0], qb4[1]);
          mma_bf16(s[2 * np + 1], ka, qb4[2], qb4[3]);
          mma_bf16(dp[2 * np], va, gb4[0], gb4[1]);
          mma_bf16(dp[2 * np + 1], va, gb4[2], gb4[3]);
        }
      }
      // P^T and dS^T in place; element c of n-tile n: key key_lo (c < 2) or
      // key_hi, row i0 + 8 n + 2 t4 + (c & 1) of the tile
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = i0 + 8 * n + 2 * t4 + (c & 1), R = r0 + i;
          const int key = c < 2 ? key_lo : key_hi;
          float p = 0.f;
          if (R < n_rows && key < S && key <= (R >> g_shift))
            p = expf(s[n][c] * scale - lse_s[i]);
          s[n][c] = p;
          dp[n][c] = p * (dp[n][c] - delta_s[i]) * scale;
        }
      }
      uint32_t pa[2][4], da[2][4];               // A fragments over 2 k-steps of 16 rows
#pragma unroll
      for (int ks2 = 0; ks2 < 2; ++ks2) {
        pa[ks2][0] = pack_bf16(s[2 * ks2][0], s[2 * ks2][1]);
        pa[ks2][1] = pack_bf16(s[2 * ks2][2], s[2 * ks2][3]);
        pa[ks2][2] = pack_bf16(s[2 * ks2 + 1][0], s[2 * ks2 + 1][1]);
        pa[ks2][3] = pack_bf16(s[2 * ks2 + 1][2], s[2 * ks2 + 1][3]);
        da[ks2][0] = pack_bf16(dp[2 * ks2][0], dp[2 * ks2][1]);
        da[ks2][1] = pack_bf16(dp[2 * ks2][2], dp[2 * ks2][3]);
        da[ks2][2] = pack_bf16(dp[2 * ks2 + 1][0], dp[2 * ks2 + 1][1]);
        da[ks2][3] = pack_bf16(dp[2 * ks2 + 1][2], dp[2 * ks2 + 1][3]);
      }
#pragma unroll
      for (int ks2 = 0; ks2 < 2; ++ks2) {
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          uint32_t gb4[4], qb4[4];
          load_b(gb4, dos_a, i0 + 16 * ks2, 16 * np, lane);
          load_b(qb4, qs_a, i0 + 16 * ks2, 16 * np, lane);
          mma_bf16(dv_acc[2 * np], pa[ks2], gb4[0], gb4[1]);
          mma_bf16(dv_acc[2 * np + 1], pa[ks2], gb4[2], gb4[3]);
          mma_bf16(dk_acc[2 * np], da[ks2], qb4[0], qb4[1]);
          mma_bf16(dk_acc[2 * np + 1], da[ks2], qb4[2], qb4[3]);
        }
      }
    }
  }

  const size_t base = (size_t)b * S * kv_row + (size_t)kvh * D;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int col = 8 * n + 2 * t4;
    if (key_lo < S) {
      *reinterpret_cast<uint32_t*>(dk + base + (size_t)key_lo * kv_row + col) =
          pack_bf16(dk_acc[n][0], dk_acc[n][1]);
      *reinterpret_cast<uint32_t*>(dv + base + (size_t)key_lo * kv_row + col) =
          pack_bf16(dv_acc[n][0], dv_acc[n][1]);
    }
    if (key_hi < S) {
      *reinterpret_cast<uint32_t*>(dk + base + (size_t)key_hi * kv_row + col) =
          pack_bf16(dk_acc[n][2], dk_acc[n][3]);
      *reinterpret_cast<uint32_t*>(dv + base + (size_t)key_hi * kv_row + col) =
          pack_bf16(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

// (c) dq of one 64-row q tile: warp w owns rows 16 w .. 16 w + 15; per key
// tile S and dP (16 rows x 64 keys) by 8 k-steps over the head dim, then
// dQ += dS K by 4 k-steps over the keys
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int S,
                        int H, int Hkv, int g_shift, float scale) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* dos = qs + MMA_TILE;
  __nv_bfloat16* ks = dos + MMA_TILE;
  __nv_bfloat16* vs = ks + MMA_TILE;
  float* lse_s = reinterpret_cast<float*>(vs + MMA_TILE);
  float* delta_s = lse_s + 64;
  const uint32_t qs_a = (uint32_t)__cvta_generic_to_shared(qs);
  const uint32_t dos_a = (uint32_t)__cvta_generic_to_shared(dos);
  const uint32_t ks_a = (uint32_t)__cvta_generic_to_shared(ks);
  const uint32_t vs_a = (uint32_t)__cvta_generic_to_shared(vs);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int t = gridDim.x - 1 - blockIdx.x;      // the longest rows first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = 1 << g_shift;
  const int n_rows = S * G;
  const int r0 = t * BR;
  const size_t q_row = (size_t)H * D, kv_row = (size_t)Hkv * D;
  const __nv_bfloat16* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
  const __nv_bfloat16* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;

  stage_rows_bf16(qs, q + (size_t)b * S * q_row + (size_t)kvh * G * D, r0, n_rows, g_shift,
                  q_row);
  stage_rows_bf16(dos, dout + (size_t)b * S * q_row + (size_t)kvh * G * D, r0, n_rows, g_shift,
                  q_row);
  stage_row_stats(lse_s, delta_s, lse, delta, b, kvh, H, S, r0, n_rows, g_shift);

  float dq_acc[16][4];                           // 16 rows x 128 dims
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq_acc[n][c] = 0.f;

  const int i_lo = 16 * warp + g, i_hi = i_lo + 8;   // this lane's rows in the tile
  const int pos_lo = (r0 + i_lo) >> g_shift, pos_hi = (r0 + i_hi) >> g_shift;
  const bool ok_lo = r0 + i_lo < n_rows, ok_hi = r0 + i_hi < n_rows;
  const int last_pos = min(r0 + BR - 1, n_rows - 1) >> g_shift;
  const int n_kt = last_pos / BK + 1;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                             // the last tile is read out
    stage_rows_bf16(ks, kb, k0, S, 0, kv_row);
    stage_rows_bf16(vs, vb, k0, S, 0, kv_row);
    __syncthreads();

    float s[8][4], dp[8][4];                     // 16 rows x 64 keys: n-tiles of 8 keys
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], ga[4];
      load_a(qa, qs_a, 16 * warp, 16 * kk, lane);
      load_a(ga, dos_a, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb4[4], vb4[4];
        load_bt(kb4, ks_a, 16 * np, 16 * kk, lane);
        load_bt(vb4, vs_a, 16 * np, 16 * kk, lane);
        mma_bf16(s[2 * np], qa, kb4[0], kb4[1]);
        mma_bf16(s[2 * np + 1], qa, kb4[2], kb4[3]);
        mma_bf16(dp[2 * np], ga, vb4[0], vb4[1]);
        mma_bf16(dp[2 * np + 1], ga, vb4[2], vb4[3]);
      }
    }
    // dS in place: element c of n-tile n is row i_lo (c < 2) or i_hi, key
    // k0 + 8 n + 2 t4 + (c & 1)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + 8 * n + 2 * t4 + (c & 1);
        const bool lo = c < 2;
        const int i = lo ? i_lo : i_hi;
        float p = 0.f;
        if ((lo ? ok_lo : ok_hi) && key < S && key <= (lo ? pos_lo : pos_hi))
          p = expf(s[n][c] * scale - lse_s[i]);
        dp[n][c] = p * (dp[n][c] - delta_s[i]) * scale;
      }
    }
#pragma unroll
    for (int ks2 = 0; ks2 < BK / 16; ++ks2) {
      uint32_t da[4];
      da[0] = pack_bf16(dp[2 * ks2][0], dp[2 * ks2][1]);
      da[1] = pack_bf16(dp[2 * ks2][2], dp[2 * ks2][3]);
      da[2] = pack_bf16(dp[2 * ks2 + 1][0], dp[2 * ks2 + 1][1]);
      da[3] = pack_bf16(dp[2 * ks2 + 1][2], dp[2 * ks2 + 1][3]);
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        uint32_t kb4[4];
        load_b(kb4, ks_a, 16 * ks2, 16 * np, lane);
        mma_bf16(dq_acc[2 * np], da, kb4[0], kb4[1]);
        mma_bf16(dq_acc[2 * np + 1], da, kb4[2], kb4[3]);
      }
    }
  }

  __nv_bfloat16* dqb = dq + (size_t)b * S * q_row + (size_t)kvh * G * D;
  const size_t off_lo = (size_t)pos_lo * q_row + ((r0 + i_lo) & (G - 1)) * D;
  const size_t off_hi = (size_t)pos_hi * q_row + ((r0 + i_hi) & (G - 1)) * D;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int col = 8 * n + 2 * t4;
    if (ok_lo)
      *reinterpret_cast<uint32_t*>(dqb + off_lo + col) = pack_bf16(dq_acc[n][0], dq_acc[n][1]);
    if (ok_hi)
      *reinterpret_cast<uint32_t*>(dqb + off_hi + col) = pack_bf16(dq_acc[n][2], dq_acc[n][3]);
  }
}

int log2_of(int g) {
  int shift = 0;
  while ((1 << shift) < g) ++shift;
  return shift;
}

cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S,
                   int H, int Hkv, float scale, cudaStream_t stream) {
  const int G = H / Hkv, g_shift = log2_of(G);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_DKDV);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_DQ);
  if (err != cudaSuccess) return err;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k);
  const float *vf = static_cast<const float*>(v), *gf = static_cast<const float*>(dout);
  const size_t rows = (size_t)B * S * H;
  const unsigned delta_blocks = (unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32));
  flash_bwd_delta_kernel<float><<<delta_blocks, THREADS, 0, stream>>>(
      static_cast<const float*>(o), gf, delta, B, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((S + BK - 1) / BK, Hkv, B);
  flash_bwd_dkdv_kernel<<<grid_kv, THREADS, SMEM_DKDV, stream>>>(
      qf, kf, vf, gf, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), S, H, Hkv,
      g_shift, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((unsigned)(((size_t)S * G + BR - 1) / BR), Hkv, B);
  flash_bwd_dq_kernel<<<grid_q, THREADS, SMEM_DQ, stream>>>(
      qf, kf, vf, gf, lse, delta, static_cast<float*>(dq), S, H, Hkv, g_shift, scale);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* delta, void* dq, void* dk,
                        void* dv, int B, int S, int H, int Hkv, float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int G = H / Hkv, g_shift = log2_of(G);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_MMA);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_MMA);
  if (err != cudaSuccess) return err;
  const size_t rows = (size_t)B * S * H;
  const unsigned delta_blocks = (unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32));
  flash_bwd_delta_kernel<bf16><<<delta_blocks, THREADS, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta, B, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((S + BK - 1) / BK, Hkv, B);
  flash_bwd_dkdv_mma_kernel<<<grid_kv, MMA_THREADS, SMEM_MMA, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      S, H, Hkv, g_shift, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((unsigned)(((size_t)S * G + BR - 1) / BR), Hkv, B);
  flash_bwd_dq_mma_kernel<<<grid_q, MMA_THREADS, SMEM_MMA, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), S, H, Hkv, g_shift,
      scale);
  return cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: bfloat16. delta is the caller's float32 scratch of
// B * H * S values. Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue, without launching, for a shape it does not take).
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv, int B, int S,
                                   int H, int Hkv, int d, float scale, void* stream) {
  if (d != D || B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || 128 % (H / Hkv) != 0 ||
      B > 65535 || Hkv > 65535 || (long long)S * (H / Hkv) > (1ll << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, Hkv, scale, st);
  if (dtype == 1)
    return (int)launch_bf16(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, Hkv, scale, st);
  return (int)cudaErrorInvalidValue;
}

// What a dtype's kernels hold on the card, for the logs: for kernel 0
// (dk/dv) and 1 (dq), info[0] registers and [1] local (spill) bytes a
// thread, [2] static and [3] dynamic shared memory bytes a block, [4]
// blocks resident on an SM, [5] threads a block, [6] the design (0: CUDA-core
// FMAs, 1: mma.sync). Returns a cudaError_t.
extern "C" int flash_attention_bwd_route_info(int dtype, int which, int* info) {
  if ((dtype != 0 && dtype != 1) || (which != 0 && which != 1)) return (int)cudaErrorInvalidValue;
  const void* fn;
  int smem, threads = THREADS;
  if (dtype == 1) {
    fn = which == 0 ? (const void*)flash_bwd_dkdv_mma_kernel : (const void*)flash_bwd_dq_mma_kernel;
    smem = (int)SMEM_MMA;
    threads = MMA_THREADS;
  } else if (which == 0) {
    fn = (const void*)flash_bwd_dkdv_kernel;
    smem = (int)SMEM_DKDV;
  } else {
    fn = (const void*)flash_bwd_dq_kernel;
    smem = (int)SMEM_DQ;
  }
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)attr.sharedSizeBytes;
  info[3] = smem;
  info[4] = blocks;
  info[5] = threads;
  info[6] = dtype == 1;   // 1: mma.sync on the tensor cores, 0: CUDA-core FMAs
  return 0;
}
