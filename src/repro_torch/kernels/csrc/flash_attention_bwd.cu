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
// more products a pair, overhead above that bound: 7 products where the
// bound counts 4.
//
// Design: FlashAttention-2's backward without atomics, so the gradients are
// the same from run to run (a single pass that accumulates dq by float32
// atomics would do 5 products a pair, not 7, and give that up). Rows are
// the forward's: the G query heads of a KV head are folded into the rows,
// row R = position * G + head (the heads of a position are adjacent in
// memory), so one K/V tile serves all G heads and dk, dv sum over them
// inside one block. Three kernels on the caller's stream:
//   (a) delta = rowsum(do * o) in float32, a warp a row, into the caller's
//       scratch;
//   (b) dk/dv: one block per (key tile, KV head, batch row); it loops over
//       the q tiles of 64 rows at or after its first key, recomputes
//       P^T = exp(scale K Q^T - lse) and dP^T = V dO^T, and accumulates
//       dV += P^T dO and dK += dS^T Q in registers;
//   (c) dq: one block per (q tile, KV head, batch row); it loops over the
//       64-key tiles up to its last position, recomputes P and dP, and
//       accumulates dQ += dS K in registers.
// Keys and rows past S arrive as zeros and are masked or contribute zero,
// so any S >= 1 works.
//
// bfloat16 route, the training path: wgmma + TMA, warp-specialised, the
// forward kernel's design (flash_attention.cu) with the roles it needs.
// Every product is a wgmma (bf16 in, float32 sums) in one of the forward's
// two forms, m64n64k16 with both operands by shared-memory descriptor, or
// m64n128k16 with A from registers and B read N-major (transposed by the
// instruction); the helpers are hopper.cuh's:
//   * 3 warpgroups of 128 threads a block. Warpgroup 0 is the producer: it
//     gives up registers (setmaxnreg) and one thread issues every load by
//     TMA into a 2-stage ring of shared memory with "full" mbarriers the
//     consumers wait on and "empty" ones they arrive on. Warpgroups 1 and 2
//     are the consumers, 64 keys (dk/dv) or 64 rows (dq) each;
//   * tiles are bf16 rows of 64 dims (128 bytes) with the 128-byte swizzle,
//     so one staged tile is read both K-major (as B of S^T = K Q^T, S = Q
//     K^T, dP = dO V^T) and N-major (as B of dV += P^T dO, dK += dS^T Q,
//     dQ += dS K): no tile is stored twice. A box of 64 dims x G heads x
//     (rows / G) positions of the 4-D map (B, S, H, d) is a tile's rows in
//     order; past 64 heads a 64-row tile is one position's run of heads;
//   * (a) also reorders: for each (batch row, KV head) it writes (lse *
//     log2 e, delta) of each row R in block-row order, padded with zeros to
//     a multiple of 128 rows, so a 64-row tile's statistics are 512
//     contiguous bytes, one bulk copy beside its tiles;
//   * dk/dv: a block holds 128 keys (K and V loaded once, 64 KB) and
//     streams 64-row Q and dO tiles with their statistics (32.5 KB a
//     stage). Its consumers own dK and dV of 64 keys x 128 dims in float32
//     registers (128 a thread), plus S^T and dP^T (64): they take
//     setmaxnreg 240 and the producer 24 (256 x 240 + 128 x 24 = 64,512
//     registers, the 168 a thread that 384 threads get). ptxas gives the
//     consumers those 240 only because the bounded wait traps through a
//     call (hopper.cuh): with a trap instruction inline it kept them to
//     168, serialized their wgmmas and spilled. For each tile
//     S^T and dP^T are issued together; P^T = exp2(s scale log2 e - lse
//     log2 e) runs while dP^T is in flight; dS^T = P^T (dP^T - delta)
//     scale; both go from the accumulators to the A operand in registers
//     as bf16 pairs (the C fragments of m64nN are its A fragments);
//   * dq: a block holds the forward's 128 rows (BQ = 128 / G positions x
//     G heads), Q and dO loaded once (64 KB); K and V of each 64-key tile
//     stream through the ring (32 KB a stage); each consumer keeps its
//     rows' lse and delta in registers; dQ += dS K accumulates 64 x 128 in
//     float32 registers (setmaxnreg 232, the producer 40);
//   * the scale stays inside dS before its bf16 rounding, as in the
//     reference, so dk needs no scaling at the end;
//   * the compare-and-mask runs only on tiles that cross a group's
//     diagonal; a group skips the products of tiles whose rows all lie
//     before its first key (dk/dv) or whose keys all lie after its last
//     row (dq), and only releases their stage;
//   * the outputs leave through the group's own rows of a tile read out
//     by then (K and V for dk/dv, Q for dq) as bf16, in 16-byte stores;
//   * cuTensorMapEncodeTiled comes through cudaGetDriverEntryPointByVersion
//     (no -lcuda), and a barrier wait that lasts seconds traps, so a fault
//     ends the launch with an error instead of a hang.
// Shared memory: dk/dv 64 KB + 2 stages x (32 KB + 512 B) = 129 KB, dq
// 64 KB + 2 x 32 KB = 128 KB (plus barriers and alignment slack); one block
// of 384 threads an SM.
//
// float32 route, the checks only: the CUDA cores (float32 FMAs), because
// float32 is held to 1e-4, which the tensor cores' TF32 cannot meet: 256
// threads as 16 x 16, 64-key and 64-row tiles staged in shared memory as
// float32 (rows padded to 132 floats), a thread holding a 4 x 4 block of a
// score tile and 4 rows x 8 columns of its accumulators; dk/dv 170,496 B,
// dq 153,088 B of shared memory, one block of 256 threads an SM; delta in
// (B, H, S) order.

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"   // descriptors, mbarriers, TMA, wgmma, the tensor-map encoder

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

// the sum over the 32 lanes of a warp, every lane holding it
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
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

// (a) float32: delta[b, h, s] = sum_c do[b, s, h, c] * o[b, s, h, c], a warp a row
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                       float* __restrict__ delta, int B, int S, int H) {
  const size_t row = (size_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= (size_t)B * S * H) return;
  const float x = warp_sum(dot4(load4f(o + row * D + lane * 4),
                                load4f(dout + row * D + lane * 4), 0.f));
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

constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK = -1e30f;
constexpr int WG_THREADS = 128;                    // a warpgroup
constexpr int WS_THREADS = 3 * WG_THREADS;         // producer + 2 consumer warpgroups
constexpr int WS_STAGES = 2;                       // the ring
constexpr int STAT_ROWS = 128;                     // the statistics' rows are padded to this
constexpr int STATS_BYTES = BR * 8;                // (lse log2 e, delta) of a 64-row tile
constexpr int TILE_HALF = 64 * 128;                // 64 dims of 64 rows (keys or q rows): 8 KB

// dq: the forward's 128 rows a block; from a 1024-byte aligned base: Q and
// dO (each dims 0..63, then 64..127), then each stage's K and V (two halves
// each), then the barriers
constexpr int DQ_ROWS = 128;
constexpr int DQ_HALF = DQ_ROWS * 128;             // 64 dims of the 128 rows: 16 KB
constexpr int DQ_Q = 0;
constexpr int DQ_DO = 2 * DQ_HALF;
constexpr int DQ_KV = 4 * DQ_HALF;
constexpr int DQ_STAGE = 4 * TILE_HALF;
constexpr int DQ_BAR = DQ_KV + WS_STAGES * DQ_STAGE;
constexpr int DQ_SMEM = DQ_BAR + 8 * (1 + 3 * WS_STAGES) + 1024;   // + alignment slack

// dk/dv: 128 keys a block; K and V (two halves each), then each stage's Q
// and dO (two halves each), then each stage's statistics, then the barriers
constexpr int KD_KEYS = 128;
constexpr int KD_HALF = KD_KEYS * 128;             // 64 dims of the 128 keys: 16 KB
constexpr int KD_K = 0;
constexpr int KD_V = 2 * KD_HALF;
constexpr int KD_QD = 4 * KD_HALF;
constexpr int KD_STAGE = 4 * TILE_HALF;
constexpr int KD_STATS = KD_QD + WS_STAGES * KD_STAGE;
constexpr int KD_BAR = KD_STATS + WS_STAGES * STATS_BYTES;
constexpr int KD_SMEM = KD_BAR + 8 * (1 + 2 * WS_STAGES) + 1024;   // + alignment slack

// two floats as a bf16 pair, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a) bfloat16: for each (batch row b, KV head) the rows R = position * G +
// head in order, NR of them (S * G padded to STAT_ROWS): (lse * log2 e,
// rowsum(do * o)) in float32, zeros past S * G; a warp a row
__global__ void __launch_bounds__(THREADS)
flash_bwd_stats_kernel(const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                       float2* __restrict__ stats, int S, int H, int Hkv, int g_shift, int NR,
                       size_t n_rows) {
  const size_t row = (size_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int R = (int)(row % NR);
  const size_t bk = row / NR;
  const int kvh = (int)(bk % Hkv);
  const size_t b = bk / Hkv;
  float2 st = make_float2(0.f, 0.f);
  if (R < (S << g_shift)) {
    const int pos = R >> g_shift, h = (kvh << g_shift) + (R & ((1 << g_shift) - 1));
    const size_t src = ((b * S + pos) * H + h) * D + lane * 4;
    st.y = warp_sum(dot4(load4f(o + src), load4f(dout + src), 0.f));
    if (lane == 0) st.x = lse[(b * H + h) * S + pos] * LOG2E;
  }
  if (lane == 0) stats[row] = st;
}

// d (64 x 64) = A B^T over the 128 dims for one tile, issued and committed:
// A's 64 rows and B's 64 rows K-major, each tile's two 64-dim halves a_half
// and b_half bytes apart; 8 steps of 16 dims, 32 bytes apart in a half
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a, uint32_t a_half, uint32_t b,
                                         uint32_t b_half) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16_ss(d, gmma_desc(a + (kk >> 2) * a_half + (kk & 3) * 32, 16, 1024),
                       gmma_desc(b + (kk >> 2) * b_half + (kk & 3) * 32, 16, 1024), kk > 0);
  wgmma_commit();
}

// d (64 x 128) += A B for one tile, issued and committed: A (64 x 64) from
// registers, B a 64-row tile read N-major (the sum runs over its rows), its
// 64-dim halves TILE_HALF apart, 8-row groups 1 KB apart; 4 steps of 16 rows
__device__ __forceinline__ void issue_rs(float (&d)[64], const uint32_t (&a)[BK / 16][4],
                                         uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_m64n128k16_rs(d, a[kk], gmma_desc(b + kk * 16 * 128, TILE_HALF, 1024));
  wgmma_commit();
}

// the A operand of a 64 x 64 accumulator as bf16 pairs: the A fragment for
// columns 16 kk .. 16 kk + 15 is the C fragments of column groups 2 kk and
// 2 kk + 1
__device__ __forceinline__ void pack_a(uint32_t (&a)[BK / 16][4], const float (&c)[32]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    a[kk][0] = pack_bf16(c[8 * kk], c[8 * kk + 1]);
    a[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// The bf16 outputs of a warp's 16 rows of a 64 x 128 float32 accumulator
// into its rows of a 128-byte-swizzled tile at smem (its two 64-dim halves
// half bytes apart); row0 is the lane's first row in the tile.
__device__ __forceinline__ void stage_out(unsigned char* smem, int half, int row0,
                                          const float (&acc)[64], int t4) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int off = (n >> 3) * half + (((n & 7) ^ (row0 & 7)) << 4) + 4 * t4;
    *reinterpret_cast<uint32_t*>(smem + off + row0 * 128) = pack_bf16(acc[4 * n], acc[4 * n + 1]);
    *reinterpret_cast<uint32_t*>(smem + off + (row0 + 8) * 128) =
        pack_bf16(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// (b) dk, dv of 128 keys of one KV head: 3 warpgroups; warpgroup 0 loads K
// and V once, then each 64-row q tile's Q, dO and statistics from the first
// tile holding position k0 to the last into a 2-stage ring; warpgroups 1
// and 2 own keys k0 .. k0 + 63 and k0 + 64 .. k0 + 127. For each tile a
// consumer runs S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both by
// descriptor), then dV += P^T dO and dK += dS^T Q (wgmma m64n128k16, P^T
// and dS^T from registers, dO and Q N-major). The accumulator's rows are
// the group's keys, its columns the tile's rows.
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const float2* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int S, int Hkv, int g_shift, int NR,
                            float scale, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char ws_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(ws_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // swizzle atoms are 1024-byte aligned
  unsigned char* smem = ws_raw + (base - raw);
  const uint32_t bar_kv = base + KD_BAR;             // K and V landed
  const uint32_t bar_f = bar_kv + 8;                 // full: Q, dO, statistics of stage s
  const uint32_t bar_e = bar_f + 8 * WS_STAGES;      // empty: both consumers done with s

  // the warpgroup by a shuffle from lane 0, so the compiler sees the role
  // branches as warp-uniform
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / WG_THREADS, 0);
  const int G = 1 << g_shift;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * KD_KEYS;
  const int t_first = (k0 << g_shift) / BR;          // the first tile holding position k0
  const int n_iter = ((S << g_shift) + BR - 1) / BR - t_first;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < WS_STAGES; ++s) {
      mbar_init(bar_f + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 2 * WG_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(bar_kv, 4 * KD_HALF);           // keys past S arrive as zeros
      tma_load_4d(base + KD_K, &tm_k, bar_kv, 0, kvh, k0, b);
      tma_load_4d(base + KD_K + KD_HALF, &tm_k, bar_kv, 64, kvh, k0, b);
      tma_load_4d(base + KD_V, &tm_v, bar_kv, 0, kvh, k0, b);
      tma_load_4d(base + KD_V + KD_HALF, &tm_v, bar_kv, 64, kvh, k0, b);
      const float2* st = stats + ((size_t)b * Hkv + kvh) * NR;
      for (int i = 0; i < n_iter; ++i) {
        const int s = i % WS_STAGES;
        if (i >= WS_STAGES) mbar_wait(bar_e + 8 * s, ((i / WS_STAGES) - 1) & 1);
        // a box of 64 dims x min(G, 64) heads x max(64 / G, 1) positions
        // is the tile's 64 rows in order; rows past S arrive as zeros
        const int r0 = (t_first + i) * BR;
        const int head = kvh * G + (r0 & (G - 1)), pos = r0 >> g_shift;
        const uint32_t qd = base + KD_QD + s * KD_STAGE, full = bar_f + 8 * s;
        mbar_expect_tx(full, 4 * TILE_HALF + STATS_BYTES);
        tma_load_4d(qd, &tm_q, full, 0, head, pos, b);
        tma_load_4d(qd + TILE_HALF, &tm_q, full, 64, head, pos, b);
        tma_load_4d(qd + 2 * TILE_HALF, &tm_do, full, 0, head, pos, b);
        tma_load_4d(qd + 3 * TILE_HALF, &tm_do, full, 64, head, pos, b);
        bulk_load(base + KD_STATS + s * STATS_BYTES, st + r0, STATS_BYTES, full);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  const int c = wg - 1;                              // keys kw0 .. kw0 + 63
  const int warp = (tid / 32) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw0 = k0 + 64 * c;
  const int row0 = 64 * c + 16 * warp + g;           // this lane's keys: k0 + row0, + 8
  const int key_lo = k0 + row0, key_hi = key_lo + 8;
  const uint32_t k_rows = base + KD_K + c * 64 * 128, v_rows = base + KD_V + c * 64 * 128;

  float dk_acc[64], dv_acc[64], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
  uint32_t pa[BK / 16][4], da[BK / 16][4];
  mbar_wait(bar_kv, 0);

  for (int i = 0; i < n_iter; ++i) {
    const int s = i % WS_STAGES;
    mbar_wait(bar_f + 8 * s, (uint32_t)((i / WS_STAGES) & 1));
    const int r0 = (t_first + i) * BR;
    const int p_lo = r0 >> g_shift, p_hi = min((r0 + BR - 1) >> g_shift, S - 1);
    if (p_hi >= kw0) {                               // some row sees a key of this group
      const uint32_t qd = base + KD_QD + s * KD_STAGE;
      // K's and V's addresses made opaque here, so their 16 descriptors are
      // formed at each tile rather than held in registers across tiles
      uint32_t ka = k_rows, va = v_rows;
      asm volatile("" : "+r"(ka), "+r"(va));
      // (lse log2 e, delta) of the tile's rows 2 m and 2 m + 1: float4 m
      const float4* st = reinterpret_cast<const float4*>(smem + KD_STATS + s * STATS_BYTES);
      fence_regs(sc);
      issue_ss(sc, ka, KD_HALF, qd, TILE_HALF);                     // S^T = K Q^T
      fence_regs(dp);
      issue_ss(dp, va, KD_HALF, qd + 2 * TILE_HALF, TILE_HALF);     // dP^T = V dO^T
      wgmma_wait<1>();                                              // S^T in, dP^T runs on
      fence_regs(sc);
      if (p_lo < kw0 + 63) {                         // the tile crosses the diagonal
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const int pos0 = (r0 + 8 * j + 2 * t4) >> g_shift;
          const int pos1 = (r0 + 8 * j + 2 * t4 + 1) >> g_shift;
          if (key_lo > pos0) sc[4 * j] = MASK;
          if (key_lo > pos1) sc[4 * j + 1] = MASK;
          if (key_hi > pos0) sc[4 * j + 2] = MASK;
          if (key_hi > pos1) sc[4 * j + 3] = MASK;
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {             // P^T = exp(s scale - lse)
        const float4 x = st[4 * j + t4];
        sc[4 * j] = exp2f(fmaf(sc[4 * j], scale_log2, -x.x));
        sc[4 * j + 1] = exp2f(fmaf(sc[4 * j + 1], scale_log2, -x.z));
        sc[4 * j + 2] = exp2f(fmaf(sc[4 * j + 2], scale_log2, -x.x));
        sc[4 * j + 3] = exp2f(fmaf(sc[4 * j + 3], scale_log2, -x.z));
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {             // dS^T = P^T (dP^T - delta) scale
        const float4 x = st[4 * j + t4];
        dp[4 * j] = sc[4 * j] * (dp[4 * j] - x.y) * scale;
        dp[4 * j + 1] = sc[4 * j + 1] * (dp[4 * j + 1] - x.w) * scale;
        dp[4 * j + 2] = sc[4 * j + 2] * (dp[4 * j + 2] - x.y) * scale;
        dp[4 * j + 3] = sc[4 * j + 3] * (dp[4 * j + 3] - x.w) * scale;
      }
      pack_a(pa, sc);
      pack_a(da, dp);
      fence_regs(dv_acc);
      issue_rs(dv_acc, pa, qd + 2 * TILE_HALF);      // dV += P^T dO
      fence_regs(dk_acc);
      issue_rs(dk_acc, da, qd);                      // dK += dS^T Q
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    mbar_arrive(bar_e + 8 * s);
  }

  // out: dK and dV in bf16 through this warp's own 16 rows of the K and V
  // tiles (read out by now), then 16-byte stores
  stage_out(smem + KD_K, KD_HALF, row0, dk_acc, t4);
  stage_out(smem + KD_V, KD_HALF, row0, dv_acc, t4);
  __syncwarp();
  const size_t kv_row = (size_t)Hkv * D;
  const size_t out0 = (size_t)b * S * kv_row + (size_t)kvh * D;
#pragma unroll
  for (int i = 0; i < 16 * 16 / 32; ++i) {
    const int cidx = i * 32 + lane;
    const int r = 64 * c + 16 * warp + cidx / 16, ch = cidx % 16;
    const int key = k0 + r;
    if (key < S) {
      const int off = (ch >> 3) * KD_HALF + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
      const size_t dst = out0 + (size_t)key * kv_row + ch * 8;
      *reinterpret_cast<uint4*>(dk + dst) = *reinterpret_cast<const uint4*>(smem + KD_K + off);
      *reinterpret_cast<uint4*>(dv + dst) = *reinterpret_cast<const uint4*>(smem + KD_V + off);
    }
  }
}

// (c) dq of 128 rows (BQ = 128 / G positions x G heads) of one KV head: 3
// warpgroups; warpgroup 0 loads Q and dO once, then K and V of each 64-key
// tile up to the block's last position into a 2-stage ring; warpgroups 1
// and 2 own rows 0..63 and 64..127. For each tile a consumer runs S = Q K^T
// and dP = dO V^T (wgmma m64n64k16, both by descriptor), then dQ += dS K
// (wgmma m64n128k16, dS from registers, K N-major).
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float2* __restrict__ stats, __nv_bfloat16* __restrict__ dq,
                          int S, int H, int Hkv, int g_shift, int NR, float scale,
                          float scale_log2) {
  extern __shared__ __align__(1024) unsigned char ws_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(ws_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // swizzle atoms are 1024-byte aligned
  unsigned char* smem = ws_raw + (base - raw);
  const uint32_t bar_q = base + DQ_BAR;              // Q and dO landed
  const uint32_t bar_k = bar_q + 8;                  // full: K of stage s landed
  const uint32_t bar_v = bar_k + 8 * WS_STAGES;      // full: V of stage s landed
  const uint32_t bar_e = bar_v + 8 * WS_STAGES;      // empty: both consumers done with s

  // the warpgroup by a shuffle from lane 0, so the compiler sees the role
  // branches as warp-uniform
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / WG_THREADS, 0);
  const int G = 1 << g_shift;
  const int BQ = DQ_ROWS >> g_shift;
  const int qt = gridDim.x - 1 - blockIdx.x;         // the longest rows first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int q_last = min(q0 + BQ, S) - 1;
  const int n_tiles = q_last / BK + 1;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < WS_STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 2 * WG_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      // Q, dO: a box of 64 dims x G heads x BQ positions is the 128 rows in
      // order r = position * G + head, 128 bytes a row
      mbar_expect_tx(bar_q, 4 * DQ_HALF);
      tma_load_4d(base + DQ_Q, &tm_q, bar_q, 0, kvh * G, q0, b);
      tma_load_4d(base + DQ_Q + DQ_HALF, &tm_q, bar_q, 64, kvh * G, q0, b);
      tma_load_4d(base + DQ_DO, &tm_do, bar_q, 0, kvh * G, q0, b);
      tma_load_4d(base + DQ_DO + DQ_HALF, &tm_do, bar_q, 64, kvh * G, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % WS_STAGES;
        if (t >= WS_STAGES) mbar_wait(bar_e + 8 * s, ((t / WS_STAGES) - 1) & 1);
        const uint32_t kv = base + DQ_KV + s * DQ_STAGE;
        mbar_expect_tx(bar_k + 8 * s, 2 * TILE_HALF);   // keys past S arrive as zeros
        tma_load_4d(kv, &tm_k, bar_k + 8 * s, 0, kvh, t * BK, b);
        tma_load_4d(kv + TILE_HALF, &tm_k, bar_k + 8 * s, 64, kvh, t * BK, b);
        mbar_expect_tx(bar_v + 8 * s, 2 * TILE_HALF);
        tma_load_4d(kv + 2 * TILE_HALF, &tm_v, bar_v + 8 * s, 0, kvh, t * BK, b);
        tma_load_4d(kv + 3 * TILE_HALF, &tm_v, bar_v + 8 * s, 64, kvh, t * BK, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int c = wg - 1;                              // rows 64 c .. 64 c + 63
  const int warp = (tid / 32) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = 64 * c + 16 * warp + g;           // this lane's rows: row0, row0 + 8
  const int pos0 = q0 + (row0 >> g_shift), pos1 = q0 + ((row0 + 8) >> g_shift);
  const int wg_first = q0 + ((64 * c) >> g_shift);
  const int wg_last = q0 + ((64 * c + 63) >> g_shift);
  const uint32_t q_rows = base + DQ_Q + c * 64 * 128, do_rows = base + DQ_DO + c * 64 * 128;
  // this lane's rows' (lse log2 e, delta): the block's rows are rows
  // qt * 128 .. of its (b, KV head) in the statistics' order
  const float2* st = stats + ((size_t)b * Hkv + kvh) * NR + (size_t)qt * DQ_ROWS;
  const float2 st0 = st[row0], st1 = st[row0 + 8];

  float acc[64], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
  uint32_t da[BK / 16][4];
  // tiles holding a key at or before this group's last position (none if
  // its rows all lie past S); the rest are masked for every row of the group
  const int n_own = wg_first < S ? min(n_tiles, (wg_last / BK) + 1) : 0;
  auto stage_at = [&](int t) { return base + DQ_KV + (t % WS_STAGES) * DQ_STAGE; };
  auto phase_of = [&](int t) { return (uint32_t)((t / WS_STAGES) & 1); };
  mbar_wait(bar_q, 0);

  for (int t = 0; t < n_own; ++t) {
    const uint32_t kv = stage_at(t);
    mbar_wait(bar_k + 8 * (t % WS_STAGES), phase_of(t));
    fence_regs(sc);
    issue_ss(sc, q_rows, DQ_HALF, kv, TILE_HALF);                 // S = Q K^T
    mbar_wait(bar_v + 8 * (t % WS_STAGES), phase_of(t));
    fence_regs(dp);
    issue_ss(dp, do_rows, DQ_HALF, kv + 2 * TILE_HALF, TILE_HALF); // dP = dO V^T
    wgmma_wait<1>();                                              // S in, dP runs on
    fence_regs(sc);
    if (t * BK + BK - 1 > wg_first) {                // the tile crosses the diagonal
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int key = t * BK + 8 * j + 2 * t4;
        if (key > pos0) sc[4 * j] = MASK;
        if (key + 1 > pos0) sc[4 * j + 1] = MASK;
        if (key > pos1) sc[4 * j + 2] = MASK;
        if (key + 1 > pos1) sc[4 * j + 3] = MASK;
      }
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {               // P = exp(s scale - lse)
      sc[4 * j] = exp2f(fmaf(sc[4 * j], scale_log2, -st0.x));
      sc[4 * j + 1] = exp2f(fmaf(sc[4 * j + 1], scale_log2, -st0.x));
      sc[4 * j + 2] = exp2f(fmaf(sc[4 * j + 2], scale_log2, -st1.x));
      sc[4 * j + 3] = exp2f(fmaf(sc[4 * j + 3], scale_log2, -st1.x));
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {               // dS = P (dP - delta) scale
      dp[4 * j] = sc[4 * j] * (dp[4 * j] - st0.y) * scale;
      dp[4 * j + 1] = sc[4 * j + 1] * (dp[4 * j + 1] - st0.y) * scale;
      dp[4 * j + 2] = sc[4 * j + 2] * (dp[4 * j + 2] - st1.y) * scale;
      dp[4 * j + 3] = sc[4 * j + 3] * (dp[4 * j + 3] - st1.y) * scale;
    }
    pack_a(da, dp);
    fence_regs(acc);
    issue_rs(acc, da, kv);                           // dQ += dS K
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(bar_e + 8 * (t % WS_STAGES));
  }
  for (int t = n_own; t < n_tiles; ++t) {            // masked for this group: release only
    mbar_wait(bar_k + 8 * (t % WS_STAGES), phase_of(t));
    mbar_wait(bar_v + 8 * (t % WS_STAGES), phase_of(t));
    mbar_arrive(bar_e + 8 * (t % WS_STAGES));
  }

  // out: dQ in bf16 through this warp's own 16 rows of the Q tile (read out
  // by now), then 16-byte stores
  stage_out(smem + DQ_Q, DQ_HALF, row0, acc, t4);
  __syncwarp();
  const size_t q_row = (size_t)H * D;
  __nv_bfloat16* dqb = dq + (size_t)b * S * q_row + (size_t)kvh * G * D;
#pragma unroll
  for (int i = 0; i < 16 * 16 / 32; ++i) {
    const int cidx = i * 32 + lane;
    const int r = 64 * c + 16 * warp + cidx / 16, ch = cidx % 16;
    const int pos = q0 + (r >> g_shift);
    if (pos < S)
      *reinterpret_cast<uint4*>(dqb + (size_t)pos * q_row + (r & (G - 1)) * D + ch * 8) =
          *reinterpret_cast<const uint4*>(smem + DQ_Q + (ch >> 3) * DQ_HALF + r * 128 +
                                          (((ch & 7) ^ (r & 7)) << 4));
  }
}

int log2_of(int g) {
  int shift = 0;
  while ((1 << shift) < g) ++shift;
  return shift;
}

// rows of a (batch row, KV head) in the bf16 statistics: S * G padded to STAT_ROWS
int stat_rows(int S, int g_shift) {
  return (((S << g_shift) + STAT_ROWS - 1) / STAT_ROWS) * STAT_ROWS;
}

// Lets the four kernels take their dynamic shared memory. The sizes are
// constants, so this runs once a device in a process (on every call past
// device 63); two threads that race both set the same values.
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  const struct { const void* fn; int bytes; } kernels[] = {
      {(const void*)flash_bwd_dkdv_kernel, (int)SMEM_DKDV},
      {(const void*)flash_bwd_dq_kernel, (int)SMEM_DQ},
      {(const void*)flash_bwd_dkdv_wgmma_kernel, KD_SMEM},
      {(const void*)flash_bwd_dq_wgmma_kernel, DQ_SMEM}};
  for (const auto& kn : kernels) {
    err = cudaFuncSetAttribute(kn.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kn.bytes);
    if (err != cudaSuccess) return err;
  }
  done.fetch_or(bit, std::memory_order_relaxed);
  return cudaSuccess;
}

cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S,
                   int H, int Hkv, float scale, cudaStream_t stream) {
  const int G = H / Hkv, g_shift = log2_of(G);
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return err;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k);
  const float *vf = static_cast<const float*>(v), *gf = static_cast<const float*>(dout);
  const size_t rows = (size_t)B * S * H;
  const unsigned delta_blocks = (unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32));
  flash_bwd_delta_kernel<<<delta_blocks, THREADS, 0, stream>>>(
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
                        const void* dout, const float* lse, float* scratch, void* dq, void* dk,
                        void* dv, int B, int S, int H, int Hkv, float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int G = H / Hkv, g_shift = log2_of(G);
  const int NR = stat_rows(S, g_shift);
  // dq reads 128-row boxes (the forward's); dk/dv 64-row tiles, one
  // position's run of 64 heads where G > 64; K and V in 64- and 128-key boxes
  const int kd_heads = G < BR ? G : BR, kd_positions = G < BR ? BR >> g_shift : 1;
  CUtensorMap q_dq, do_dq, k_dq, v_dq, q_kd, do_kd, k_kd, v_kd;
  if (!encode_map(encode, &q_dq, q, B, S, H, G, DQ_ROWS >> g_shift) ||
      !encode_map(encode, &do_dq, dout, B, S, H, G, DQ_ROWS >> g_shift) ||
      !encode_map(encode, &k_dq, k, B, S, Hkv, 1, BK) ||
      !encode_map(encode, &v_dq, v, B, S, Hkv, 1, BK) ||
      !encode_map(encode, &q_kd, q, B, S, H, kd_heads, kd_positions) ||
      !encode_map(encode, &do_kd, dout, B, S, H, kd_heads, kd_positions) ||
      !encode_map(encode, &k_kd, k, B, S, Hkv, 1, KD_KEYS) ||
      !encode_map(encode, &v_kd, v, B, S, Hkv, 1, KD_KEYS))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return err;
  float2* stats = reinterpret_cast<float2*>(scratch);
  const size_t n_rows = (size_t)B * Hkv * NR;        // a multiple of the 8 warps a block
  flash_bwd_stats_kernel<<<(unsigned)(n_rows / (THREADS / 32)), THREADS, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, stats, S, H, Hkv,
      g_shift, NR, n_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * LOG2E;
  flash_bwd_dkdv_wgmma_kernel<<<dim3((S + KD_KEYS - 1) / KD_KEYS, Hkv, B), WS_THREADS, KD_SMEM,
                                stream>>>(q_kd, do_kd, k_kd, v_kd, stats, static_cast<bf16*>(dk),
                                          static_cast<bf16*>(dv), S, Hkv, g_shift, NR, scale,
                                          scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma_kernel<<<dim3(NR / DQ_ROWS, Hkv, B), WS_THREADS, DQ_SMEM, stream>>>(
      q_dq, do_dq, k_dq, v_dq, stats, static_cast<bf16*>(dq), S, H, Hkv, g_shift, NR, scale,
      scale_log2);
  return cudaGetLastError();
}

// float32 values of scratch the kernels need at this shape, for either
// dtype: 2 * B * Hkv * (S * G padded to STAT_ROWS), at least B * H * S
long long scratch_values(int B, int S, int H, int Hkv) {
  return 2ll * B * Hkv * stat_rows(S, log2_of(H / Hkv));
}

}  // namespace

// dtype 0: float32, 1: bfloat16. scratch is the caller's float32 scratch of
// scratch_len values, at least 2 * B * Hkv * (S * H / Hkv padded to 128)
// (float32: delta in (B, H, S) order; bfloat16: (lse log2 e, delta) pairs in
// block-row order). Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue, without launching, for a shape it does not take
// or a scratch too small).
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const float* lse,
                                   float* scratch, long long scratch_len, void* dq, void* dk,
                                   void* dv, int B, int S, int H, int Hkv, int d, float scale,
                                   void* stream) {
  if (d != D || B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || 128 % (H / Hkv) != 0 ||
      B > 65535 || Hkv > 65535 || (long long)S * (H / Hkv) > (1ll << 30) ||
      scratch_len < scratch_values(B, S, H, Hkv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, S, H, Hkv, scale, st);
  if (dtype == 1)
    return (int)launch_bf16(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, S, H, Hkv, scale,
                            st);
  return (int)cudaErrorInvalidValue;
}

// What a dtype's kernels hold on the card, for the logs: for kernel 0
// (dk/dv) and 1 (dq), info[0] registers and [1] local (spill) bytes a
// thread, [2] static and [3] dynamic shared memory bytes a block, [4]
// blocks resident on an SM, [5] threads a block, [6] the design (0: CUDA-core
// FMAs, 2: wgmma + TMA). Returns a cudaError_t.
extern "C" int flash_attention_bwd_route_info(int dtype, int which, int* info) {
  if ((dtype != 0 && dtype != 1) || (which != 0 && which != 1)) return (int)cudaErrorInvalidValue;
  const void* fn;
  int smem, threads = THREADS;
  if (dtype == 1) {
    fn = which == 0 ? (const void*)flash_bwd_dkdv_wgmma_kernel
                    : (const void*)flash_bwd_dq_wgmma_kernel;
    smem = which == 0 ? KD_SMEM : DQ_SMEM;
    threads = WS_THREADS;
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
  info[6] = dtype == 1 ? 2 : 0;   // 2: wgmma + TMA on the tensor cores, 0: CUDA-core FMAs
  return 0;
}
