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
// operations, 0.139 ms at 989 TFLOP/s in bfloat16; in float32 2.05 ms at
// 67 TFLOP/s on the CUDA cores and 0.833 ms in 3xTF32 on the tensor cores
// (three TF32 products at 495 TFLOP/s); against 0.060 ms (bfloat16) or
// 0.120 ms (float32) for the bytes: bound by operations. The recompute of
// S (in both kernels) and of dp (in the dq kernel) are three more products
// a pair, overhead above that bound: 7 products where the bound counts 4.
//
// Design: FlashAttention-2's backward without atomics, so the gradients are
// the same from run to run (a single pass that accumulates dq by float32
// atomics would do 5 products a pair, not 7, and give that up). Rows are
// the forward's: the G query heads of a KV head are folded into the rows,
// row R = position * Gp + head, Gp the power of two at or above G (the
// heads of a position are adjacent in memory), so one K/V tile serves all
// G heads and dk, dv sum over them inside one block. G may be any group
// size up to 128, as _flash_bwd_rule's is. Where G is a power of two (1,
// 2, 4, 8: qwen3-0.6b, granite-3-2b, the MoE configs) Gp = G and every row
// holds a query head. Otherwise (G = 7, deepseek-coder-33b's 56 over 8:
// Gp = 8) a position's rows G .. Gp - 1 are idle, and, unlike the
// forward's, an idle row of dk/dv would not just go unstored: dV += P^T dO
// and dK += dS^T Q sum over every row of a tile, and 0 * NaN is NaN in the
// tensor cores, so zeroing an idle row's P and dS is not enough. So an
// idle row never holds another group's head: Q and dO are read through a
// 5-D view (B, S, Hkv, G, d) whose box is Gp heads tall, and TMA fills the
// Gp - G heads past the group's end with zeros. With zero Q and dO and a
// neutral (0, 0) statistic (the statistics kernel reads no o, dout or lse
// there: for the last group that head would lie past H), an idle row's
// S, dP and dS are 0 and it adds exactly nothing to dK and dV; dq computes
// it and never stores it (every dQ store asks head < G), and the float32
// route's non-finite flags see only zeros there. Those guards and the 5-D
// loads are a template parameter (PAD): a power-of-two G runs an instance
// without them, the code it ran before any G was padded. An idle row's
// products (1/8 of them at G = 7) are overhead above the bound, like the
// masked pairs on the diagonal tiles. Three kernels on the caller's stream:
//   (a) the statistics: each row's (lse, delta = rowsum(do * o)) in
//       float32, a warp a row, into the caller's scratch in block-row order
//       (for each batch row and KV head, rows R in order, padded with
//       zeros to a multiple of 128), so a tile's statistics are contiguous;
//   (b) dk/dv: one block per (key block, KV head, batch row); it loops over
//       the q tiles (64 rows; float32 32) at or after its first key,
//       recomputes P^T = exp(scale K Q^T - lse) and dP^T = V dO^T, and
//       accumulates dV += P^T dO and dK += dS^T Q in registers;
//   (c) dq: one block per (q tile, KV head, batch row); it loops over the
//       key tiles (64 keys; float32 32) up to its last position, recomputes
//       P and dP, and accumulates dQ += dS K in registers.
// Keys and rows past S arrive as zeros and are masked or contribute zero,
// so any S >= 1 works.
//
// bfloat16 route, the training path: wgmma + TMA, warp-specialised, the
// forward kernel's design (flash_attention.cu) with the roles it needs,
// and like it a template on the head width D, 64 (granite-3-2b's) or 128
// (qwen3-0.6b's): a tile is D / 64 boxes of 64 dims. Every product is a
// wgmma (bf16 in, float32 sums) in one of the forward's two forms,
// m64n64k16 with both operands by shared-memory descriptor (D / 16 steps a
// tile), or m64nDk16 with A from registers and B read N-major (transposed
// by the instruction); the helpers are hopper.cuh's:
//   * 3 warpgroups of 128 threads a block. Warpgroup 0 is the producer: it
//     gives up registers (setmaxnreg) and one thread issues every load by
//     TMA into a 2-stage ring of shared memory with "full" mbarriers the
//     consumers wait on and "empty" ones they arrive on. Warpgroups 1 and 2
//     are the consumers, 64 keys (dk/dv) or 64 rows (dq) each;
//   * tiles are bf16 rows of 64 dims (128 bytes) with the 128-byte swizzle,
//     so one staged tile is read both K-major (as B of S^T = K Q^T, S = Q
//     K^T, dP = dO V^T) and N-major (as B of dV += P^T dO, dK += dS^T Q,
//     dQ += dS K): no tile is stored twice. A box of 64 dims x Gp heads x
//     (rows / Gp) positions of the 4-D map (B, S, H, d) (PAD: of the 5-D
//     map (B, S, Hkv, G, d)) is a tile's rows in order; past 64 heads a
//     64-row tile is one position's run of heads;
//   * (a) also reorders: for each (batch row, KV head) it writes (lse *
//     log2 e, delta) of each row R in block-row order, padded with zeros to
//     a multiple of 128 rows, so a 64-row tile's statistics are 512
//     contiguous bytes, one bulk copy beside its tiles;
//   * dk/dv: a block holds 128 keys (K and V loaded once, 64 KB at
//     d=128) and streams 64-row Q and dO tiles with their statistics
//     (32.5 KB a stage). Its consumers own dK and dV of 64 keys x D dims
//     in float32 registers (D a thread), plus S^T and dP^T (64): they take
//     setmaxnreg 240 and the producer 24 (256 x 240 + 128 x 24 = 64,512
//     registers, the 168 a thread that 384 threads get). ptxas gives the
//     consumers those 240 only because the bounded wait traps through a
//     call (hopper.cuh): with a trap instruction inline it kept them to
//     168, serialized their wgmmas and spilled. For each tile
//     S^T and dP^T are issued together; P^T = exp2(s scale log2 e - lse
//     log2 e) runs while dP^T is in flight; dS^T = P^T (dP^T - delta)
//     scale; both go from the accumulators to the A operand in registers
//     as bf16 pairs (the C fragments of m64nN are its A fragments);
//   * dq: a block holds the forward's 128 rows (BQ = 128 / Gp positions x
//     Gp heads), Q and dO loaded once (64 KB at d=128); K and V of each
//     64-key tile stream through the ring (32 KB a stage); each consumer
//     keeps its rows' lse and delta in registers; dQ += dS K accumulates
//     64 x D in float32 registers (setmaxnreg 232, the producer 40);
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
// Shared memory at d=128: dk/dv 64 KB + 2 stages x (32 KB + 512 B) = 129
// KB, dq 64 KB + 2 x 32 KB = 128 KB (plus barriers and alignment slack);
// at d=64 half of each tile, 65 KB and 64 KB. One block of 384 threads an
// SM (the registers).
//
// float32 route, the training path's float32 checks: 3xTF32 on the tensor
// cores. float32 is held to (1e-4, 1e-4, 2e-5) (rtol, atol, error norm);
// one TF32 product keeps about 2^-11 of each operand and misses that, so
// every product runs as three: each operand split v = hi + lo, both rounded
// as cvt.rna.tf32.f32 rounds, lo*hi + hi*lo + hi*hi summed into float32,
// the small terms first (tf32.cuh). lse, delta, P and dS stay float32. The
// design aims at the 3xTF32 bound (0.833 ms at 4 x 2048) with mma.sync, not
// wgmma, because wgmma's operands do not fit: it takes tf32 only K-major
// and B only from shared memory, so a dq tile of 32 keys needs K, V (for S
// and dP) and K^T (for dS K) as hi, hi_c and lo tiles, 9 x 16 KB = 144 KB,
// beside Q and dO as A operands, whose hi parts in registers take 128 of a
// consumer thread's registers beside dQ's 64 (as hi and lo tiles in shared
// memory, 128 KB for 64 rows): over the 227 KB a block may take, or the
// 255 registers a thread. dk/dv needs the same four ways round. With
// mma.sync both operands come from registers, so one hi and lo tile of a
// raw operand serves either orientation:
//   * 8 warps of 16 rows (dq) or 16 keys (dk/dv). Thread 0 issues every
//     load by TMA (float32 boxes of 32 values, 128 bytes, the 128-byte
//     swizzle): the block's own rows (Q and dO, dq) or keys (K and V,
//     dk/dv) once, then the streamed tiles of 32 keys or 32 rows, the next
//     while the block works on this one. The block splits each streamed
//     tile into hi and lo tiles at the raw offsets (tf32.cuh split_tiles);
//     a fragment is read from them with 4-byte loads at swizzled offsets,
//     which meet 32 distinct banks read either way round, so no operand is
//     stored twice. The block's own operand, the A of S = Q K^T, dP, S^T
//     and dP^T, is split in registers as its fragment is loaded;
//   * P's and dS's A fragments are their accumulators as they stand: a
//     lane holds columns 2t, 2t + 1 of each 8 where the fragment wants t,
//     t + 4, so the B fragment of dS K, P^T dO and dS^T Q reads rows 2t and
//     2t + 1 and the sum runs over each 8 in that order;
//   * dk/dv's warps come in pairs on 16 keys: the first computes S^T, P^T
//     and dV, the second dP^T, dS^T (taking P^T from the first through 2 KB
//     of shared memory) and dK, so each holds one 16 x 128 accumulator; a
//     warp holding both spilled. A block takes 64 keys;
//   * the tensor cores truncate as they accumulate, an error that grows
//     with the chain of accumulations (past the float32 gate for the
//     32,896 rows a key sees at H=128, Hkv=1, S=257). So each
//     accumulator's sum moves into the output in float32 after at most 16
//     tiles (TF_CHAIN) and starts again from 0, the lane adding to what it
//     wrote, in a fixed order: two calls stay bit-equal;
//   * non-finite inputs follow float32 (tf32.cuh): a tile's split pass
//     reports any inf or NaN to the block, which then reads the cross
//     pass's hi as 0 there. A block checks its own operand and statistics
//     once; where they and the tile are finite, P and dS are too, and every
//     A operand is split without the non-finite selects (split_finite:
//     8.49 -> 7.76 ms at 4 x 2048 on an H100 SXM);
//   * shared memory: dq: Q and dO 128 KB + raw K and V 32 KB + split tile
//     64 KB = 224 KB; dk/dv: K and V 64 KB + raw Q and dO 32 KB + split tile
//     64 KB + P^T 8 KB = 168 KB; one block of 256 threads an SM;
//   * each launcher first makes the device's primary context current on its
//     thread (hopper.cuh): cuTensorMapEncodeTiled fails on a thread with
//     none, and autograd runs the backward on a thread of its own.

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"   // descriptors, mbarriers, TMA, wgmma, the tensor-map encoders
#include "tf32.cuh"     // the 3xTF32 split and products, the float32 tiles

namespace {

constexpr int TF_D = 128;       // head width of the float32 route
constexpr int BR = 64;          // rows (position x head) a q tile of the bfloat16 route
constexpr int BK = 64;          // keys a kv tile of the bfloat16 route
constexpr int THREADS = 256;    // the statistics kernel: 8 warps, a warp a row
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK = -1e30f;
constexpr int STAT_ROWS = 128;                     // the statistics' rows are padded to this

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

// a box of a 5-D tensor map into shared memory, completing on bar (PAD's
// Q and dO: the view (B, S, Hkv, G, d), innermost first)
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(c4), "r"(bar)
      : "memory");
}

// (a) for each (batch row b, KV head) the rows R = position * Gp + head in
// order, NR of them (S * Gp padded to STAT_ROWS): (lse * lse_mul,
// rowsum(do * o)) in float32, zeros past S * Gp; a warp a row of D values,
// 4 a lane (at D = 64 lanes 16..31 add zeros). lse_mul is log2 e for the
// bfloat16 route (exp2), 1 for float32 (exp). PAD: an idle row (head G ..
// Gp - 1 of a position) reads nothing and holds zeros too.
template <typename T, int D, bool PAD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_stats_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       const float* __restrict__ lse, float2* __restrict__ stats, int S, int H,
                       int Hkv, int g_shift, int NR, size_t n_rows, float lse_mul) {
  const size_t row = (size_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int R = (int)(row % NR);
  const size_t bk = row / NR;
  const int kvh = (int)(bk % Hkv);
  const size_t b = bk / Hkv;
  float2 st = make_float2(0.f, 0.f);
  if constexpr (PAD) {
    const int G = H / Hkv, head = R & ((1 << g_shift) - 1);
    if (R < (S << g_shift) && head < G) {        // the row warp-uniform: one warp a row
      const int pos = R >> g_shift, h = kvh * G + head;
      const size_t src = ((b * S + pos) * H + h) * D + lane * 4;
      st.y = warp_sum(lane * 4 < D ? dot4(load4f(o + src), load4f(dout + src), 0.f) : 0.f);
      if (lane == 0) st.x = lse[(b * H + h) * S + pos] * lse_mul;
    }
  } else if (R < (S << g_shift)) {
    const int pos = R >> g_shift, h = (kvh << g_shift) + (R & ((1 << g_shift) - 1));
    const size_t src = ((b * S + pos) * H + h) * D + lane * 4;
    st.y = warp_sum(lane * 4 < D ? dot4(load4f(o + src), load4f(dout + src), 0.f) : 0.f);
    if (lane == 0) st.x = lse[(b * H + h) * S + pos] * lse_mul;
  }
  if (lane == 0) stats[row] = st;
}

// ----------------------------------------------------------- float32 route --

constexpr int TF_THREADS = 256;                    // 8 warps of 16 rows (dq) or keys (dk/dv)
constexpr int TF_TILE = 32;                        // keys (dq) or rows (dk/dv) a streamed tile
constexpr int TF_PART = TF_TILE * 512;             // a raw float32 tile of 32 rows: 16 KB
constexpr int TF_STATS = TF_TILE * 8;              // (lse, delta) of 32 rows
// tiles an accumulator chain runs before its sum moves into the output in
// float32: the tensor cores truncate each accumulation, and that error
// grows with the chain, so no chain spans more than 16 tiles (512 rows or
// keys)
constexpr int TF_CHAIN = 16;
// dq: from a 1024-byte aligned base: the raw Q and dO of the block's 128
// rows, the raw K and V of one 32-key tile, the split tile (K hi, K lo, V
// hi, V lo), the barriers
constexpr int QF_ROWS = 128;
constexpr int QF_Q = 0;
constexpr int QF_DO = QF_ROWS * 512;
constexpr int QF_RAW = 2 * QF_ROWS * 512;
constexpr int QF_SPLIT = QF_RAW + 2 * TF_PART;
constexpr int QF_BAR = QF_SPLIT + 4 * TF_PART;
constexpr int QF_SMEM = QF_BAR + 16 + 1024;        // + alignment slack
// dk/dv: the raw K and V of the block's 64 keys, the raw Q and dO of one
// 32-row tile, the split tile (Q hi, Q lo, dO hi, dO lo), the P^T that each
// pair of warps passes between its two, the raw statistics of the tile, the
// statistics in use, the barriers
constexpr int KF_KEYS = 64;
constexpr int KF_K = 0;
constexpr int KF_V = KF_KEYS * 512;
constexpr int KF_RAW = 2 * KF_KEYS * 512;
constexpr int KF_SPLIT = KF_RAW + 2 * TF_PART;
constexpr int KF_XCH = KF_SPLIT + 4 * TF_PART;     // 4 pairs x 16 values x 32 lanes
constexpr int KF_RAW_STATS = KF_XCH + 4 * 16 * 32 * 4;
constexpr int KF_STATS = KF_RAW_STATS + TF_STATS;
constexpr int KF_BAR = KF_STATS + TF_STATS;
constexpr int KF_SMEM = KF_BAR + 16 + 1024;        // + alignment slack

// Moves a lane's share of one row of a 16-row x 128 accumulator (its
// columns 8 n + 2 t, + 1: values e, e + 1 of each acc[n]) into the output
// row dst (null where the row is not stored) in float32 and zeroes it: the
// first move writes, later ones add to what the lane wrote. The 16 loads
// are issued before any add, so a move waits on memory once.
__device__ __forceinline__ void flush_row(float (&acc)[TF_D / 8][4], int e, float* dst, bool first) {
  if (dst != nullptr) {
    float2 x[TF_D / 8];
#pragma unroll
    for (int n = 0; n < TF_D / 8; ++n)
      x[n] = first ? make_float2(0.f, 0.f) : *reinterpret_cast<const float2*>(dst + 8 * n);
#pragma unroll
    for (int n = 0; n < TF_D / 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(x[n].x + acc[n][e],
                                                            x[n].y + acc[n][e + 1]);
  }
#pragma unroll
  for (int n = 0; n < TF_D / 8; ++n) acc[n][e] = acc[n][e + 1] = 0.f;
}

// Both rows of a lane's share (acc values 0, 1: row g; 2, 3: row g + 8).
__device__ __forceinline__ void flush_rows(float (&acc)[TF_D / 8][4], float* dst0, float* dst1,
                                           bool first) {
  flush_row(acc, 0, dst0, first);
  flush_row(acc, 2, dst1, first);
}

// The products of one 32-key tile for a warp's 16 rows of dq: S = Q K^T
// and dP = dO V^T (A: Q and dO split here, B: K's and V's split tiles),
// P = exp(s scale - lse) (0 past the row's position), dS = P (dP - delta)
// scale, then dQ += dS K. dS's A fragment is its accumulator as it stands,
// keys 2t, 2t + 1 of each 8 where the fragment wants columns t, t + 4; so
// the dS K sum runs over the keys in that order and K's B fragment reads
// keys 2t and 2t + 1.
template <bool NF>
__device__ __forceinline__ void dq_tile(const unsigned char* qs, const unsigned char* dos,
                                        const unsigned char* kv, float (&acc)[TF_D / 8][4], int r0,
                                        int g, int t4, int key0, bool diag, int pos0, int pos1,
                                        float2 st0, float2 st1, float scale) {
  const unsigned char* khi = kv;
  const unsigned char* klo = kv + TF_PART;
  const unsigned char* vhi = kv + 2 * TF_PART;
  const unsigned char* vlo = kv + 3 * TF_PART;
  float sc[TF_TILE / 8][4], dp[TF_TILE / 8][4];
#pragma unroll
  for (int j = 0; j < TF_TILE / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < TF_D / 8; ++kk) {
    const int c = 8 * kk + t4;
    const Split a[4] = {split_as<NF>(ld_f32(qs + sw_off(QF_ROWS, r0, c))),
                        split_as<NF>(ld_f32(qs + sw_off(QF_ROWS, r0 + 8, c))),
                        split_as<NF>(ld_f32(qs + sw_off(QF_ROWS, r0, c + 4))),
                        split_as<NF>(ld_f32(qs + sw_off(QF_ROWS, r0 + 8, c + 4)))};
    const Split e[4] = {split_as<NF>(ld_f32(dos + sw_off(QF_ROWS, r0, c))),
                        split_as<NF>(ld_f32(dos + sw_off(QF_ROWS, r0 + 8, c))),
                        split_as<NF>(ld_f32(dos + sw_off(QF_ROWS, r0, c + 4))),
                        split_as<NF>(ld_f32(dos + sw_off(QF_ROWS, r0 + 8, c + 4)))};
#pragma unroll
    for (int j = 0; j < TF_TILE / 8; ++j) {
      const uint32_t o0 = sw_off(TF_TILE, 8 * j + g, c), o1 = sw_off(TF_TILE, 8 * j + g, c + 4);
      mma3<NF>(sc[j], a, ld_u32(khi + o0), ld_u32(khi + o1), ld_u32(klo + o0), ld_u32(klo + o1));
      mma3<NF>(dp[j], e, ld_u32(vhi + o0), ld_u32(vhi + o1), ld_u32(vlo + o0), ld_u32(vlo + o1));
    }
  }
#pragma unroll
  for (int j = 0; j < TF_TILE / 8; ++j) {
    const int key = key0 + 8 * j + 2 * t4;
    const float p0 = !diag || key <= pos0 ? expf(sc[j][0] * scale - st0.x) : 0.f;
    const float p1 = !diag || key + 1 <= pos0 ? expf(sc[j][1] * scale - st0.x) : 0.f;
    const float p2 = !diag || key <= pos1 ? expf(sc[j][2] * scale - st1.x) : 0.f;
    const float p3 = !diag || key + 1 <= pos1 ? expf(sc[j][3] * scale - st1.x) : 0.f;
    dp[j][0] = p0 * (dp[j][0] - st0.y) * scale;
    dp[j][1] = p1 * (dp[j][1] - st0.y) * scale;
    dp[j][2] = p2 * (dp[j][2] - st1.y) * scale;
    dp[j][3] = p3 * (dp[j][3] - st1.y) * scale;
  }
#pragma unroll
  for (int i = 0; i < TF_TILE / 8; ++i) {
    const Split d[4] = {split_as<NF>(dp[i][0]), split_as<NF>(dp[i][2]), split_as<NF>(dp[i][1]), split_as<NF>(dp[i][3])};
    const int key = 8 * i + 2 * t4;
#pragma unroll
    for (int n = 0; n < TF_D / 8; ++n) {
      const uint32_t o0 = sw_off(TF_TILE, key, 8 * n + g), o1 = sw_off(TF_TILE, key + 1, 8 * n + g);
      mma3<NF>(acc[n], d, ld_u32(khi + o0), ld_u32(khi + o1), ld_u32(klo + o0), ld_u32(klo + o1));
    }
  }
}

// (c) dq of 128 rows (BQ = 128 / Gp positions x Gp heads) of one KV head,
// 8 warps of 16 rows: thread 0 loads Q and dO once, then the raw K and V
// of each 32-key tile up to the block's last position, the next while the
// block works on this one; the block splits each into the split tile, then
// each warp with a visible key in the tile runs dq_tile. PAD: Q and dO
// through the 5-D map, idle rows zeros and never stored.
template <bool PAD>
__global__ void __launch_bounds__(TF_THREADS, 1)
flash_bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const float2* __restrict__ stats,
                        float* __restrict__ dq, int S, int H, int Hkv, int g_shift, int NR,
                        float scale) {
  extern __shared__ __align__(1024) unsigned char f32_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(f32_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // swizzle atoms are 1024-byte aligned
  unsigned char* smem = f32_raw + (base - raw);
  const uint32_t bar_q = base + QF_BAR;              // Q and dO landed
  const uint32_t bar_kv = bar_q + 8;                 // K and V of the tile landed

  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // PAD: G = H / Hkv below Gp = 1 << g_shift, rows G .. Gp - 1 of a position idle
  const int G = PAD ? H / (int)gridDim.y : 1 << g_shift;
  const int BQ = QF_ROWS >> g_shift;
  const int qt = gridDim.x - 1 - blockIdx.x;         // the longest rows first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int q_last = min(q0 + BQ, S) - 1;
  const int n_tiles = q_last / TF_TILE + 1;

  auto load_kv = [&](int t) {                        // keys past S arrive as zeros
    mbar_expect_tx(bar_kv, 2 * TF_PART);
    for (int a = 0; a < 4; ++a) {
      tma_load_4d(base + QF_RAW + a * TF_TILE * 128, &tm_k, bar_kv, 32 * a, kvh, t * TF_TILE, b);
      tma_load_4d(base + QF_RAW + TF_PART + a * TF_TILE * 128, &tm_v, bar_kv, 32 * a, kvh,
                  t * TF_TILE, b);
    }
  };
  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // Q, dO: a box of 32 values x Gp heads x BQ positions is the 128 rows in
    // order r = position * Gp + head, 128 bytes a row
    mbar_expect_tx(bar_q, 2 * QF_ROWS * 512);
    for (int a = 0; a < 4; ++a) {
      if constexpr (PAD) {                           // heads past the group's G arrive as zeros
        tma_load_5d(base + QF_Q + a * QF_ROWS * 128, &tm_q, bar_q, 32 * a, 0, kvh, q0, b);
        tma_load_5d(base + QF_DO + a * QF_ROWS * 128, &tm_do, bar_q, 32 * a, 0, kvh, q0, b);
      } else {
        tma_load_4d(base + QF_Q + a * QF_ROWS * 128, &tm_q, bar_q, 32 * a, kvh * G, q0, b);
        tma_load_4d(base + QF_DO + a * QF_ROWS * 128, &tm_do, bar_q, 32 * a, kvh * G, q0, b);
      }
    }
    load_kv(0);
  }
  __syncthreads();

  const int r0 = 16 * warp + g;                      // this lane's rows: r0, r0 + 8
  const int pos0 = q0 + (r0 >> g_shift), pos1 = q0 + ((r0 + 8) >> g_shift);
  const int w_first = q0 + ((16 * warp) >> g_shift);
  const int w_last = q0 + ((16 * warp + 15) >> g_shift);
  // this lane's rows' (lse, delta): the block's rows are rows qt * 128 ..
  // of its (b, KV head) in the statistics' order
  const float2* st = stats + ((size_t)b * Hkv + kvh) * NR + (size_t)qt * QF_ROWS;
  const float2 st0 = st[r0], st1 = st[r0 + 8];
  const size_t q_row = (size_t)H * TF_D;
  float* dqb = dq + (size_t)b * S * q_row + (size_t)kvh * G * TF_D + 2 * t4;
  float *dst0, *dst1;
  if constexpr (PAD) {                               // idle rows (head >= G) are never stored
    const int head0 = r0 & ((1 << g_shift) - 1), head1 = (r0 + 8) & ((1 << g_shift) - 1);
    dst0 = pos0 < S && head0 < G ? dqb + (size_t)pos0 * q_row + head0 * TF_D : nullptr;
    dst1 = pos1 < S && head1 < G ? dqb + (size_t)pos1 * q_row + head1 * TF_D : nullptr;
  } else {
    dst0 = pos0 < S ? dqb + (size_t)pos0 * q_row + (r0 & (G - 1)) * TF_D : nullptr;
    dst1 = pos1 < S ? dqb + (size_t)pos1 * q_row + ((r0 + 8) & (G - 1)) * TF_D : nullptr;
  }
  float acc[TF_D / 8][4];
#pragma unroll
  for (int n = 0; n < TF_D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  int chain = 0, moved = 0;                          // tiles in acc; moves made
  mbar_wait(bar_q, 0);
  // any inf or NaN in the block's Q, dO or its rows' statistics: its tiles
  // then take the split with the non-finite rule. The selects cost issue
  // slots in every product, so finite blocks go without; P and dS, split
  // as A operands, are finite where all of these are
  const bool qd_bad = __syncthreads_or(any_nonfinite(smem + QF_Q, 2 * QF_ROWS * 512) ||
                                       !isfinite(st0.x + st0.y + st1.x + st1.y)) != 0;

  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(bar_kv, (uint32_t)(t & 1));
    __syncthreads();                                 // the last tile's split is read out
    bool bad = split_tiles(smem + QF_RAW, smem + QF_SPLIT, TF_PART, 2);
    fence_proxy_async();                             // the raw tile is read: TMA may refill it
    bad = __syncthreads_or(bad) != 0;
    if (tid == 0 && t + 1 < n_tiles) load_kv(t + 1);
    const int key0 = t * TF_TILE;
    if (key0 <= w_last) {                            // some row of the warp sees a key here
      const bool diag = key0 + TF_TILE - 1 > w_first;
      if (bad || qd_bad)
        dq_tile<true>(smem + QF_Q, smem + QF_DO, smem + QF_SPLIT, acc, r0, g, t4, key0, diag,
                      pos0, pos1, st0, st1, scale);
      else
        dq_tile<false>(smem + QF_Q, smem + QF_DO, smem + QF_SPLIT, acc, r0, g, t4, key0, diag,
                       pos0, pos1, st0, st1, scale);
      if (++chain == TF_CHAIN) {
        flush_rows(acc, dst0, dst1, moved++ == 0);
        chain = 0;
      }
    }
  }
  if (chain > 0 || moved == 0) flush_rows(acc, dst0, dst1, moved == 0);
}

// The dk/dv kernel's warps come in pairs, both on the same 16 keys of a
// 32-row tile: the first computes S^T = K Q^T (A: K split here, B: Q's
// split tile), P^T = exp(s scale - lse) (0 where the row lies before the
// key or past the last row) and dV += P^T dO; the second dP^T = V dO^T,
// then, with P^T from the first through shared memory, dS^T = P^T (dP^T -
// delta) scale and dK += dS^T Q. Each holds one 16 x 128 accumulator (64
// registers a thread) and runs two products of the four. The A fragments
// of P^T and dS^T are their accumulators as they stand (rows 2t, 2t + 1 of
// each 8), so dO's and Q's B fragments read rows 2t and 2t + 1.

// C (16 keys x 32 rows) = A B^T over the 128 dims: A the raw rows kr0,
// kr0 + 8 of a 64-key tile, split here; B a split tile of 32 rows.
template <bool NF>
__device__ __forceinline__ void keys_by_rows(float (&c)[TF_TILE / 8][4], const unsigned char* a,
                                             const unsigned char* bhi, const unsigned char* blo,
                                             int kr0, int g, int t4) {
#pragma unroll
  for (int j = 0; j < TF_TILE / 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < TF_D / 8; ++kk) {
    const int col = 8 * kk + t4;
    const Split f[4] = {split_as<NF>(ld_f32(a + sw_off(KF_KEYS, kr0, col))),
                        split_as<NF>(ld_f32(a + sw_off(KF_KEYS, kr0 + 8, col))),
                        split_as<NF>(ld_f32(a + sw_off(KF_KEYS, kr0, col + 4))),
                        split_as<NF>(ld_f32(a + sw_off(KF_KEYS, kr0 + 8, col + 4)))};
#pragma unroll
    for (int j = 0; j < TF_TILE / 8; ++j) {
      const uint32_t o0 = sw_off(TF_TILE, 8 * j + g, col), o1 = sw_off(TF_TILE, 8 * j + g, col + 4);
      mma3<NF>(c[j], f, ld_u32(bhi + o0), ld_u32(bhi + o1), ld_u32(blo + o0), ld_u32(blo + o1));
    }
  }
}

// acc (16 keys x 128) += C B: C (16 keys x 32 rows) as its accumulator
// stands, B a split tile of 32 rows read at rows 2t, 2t + 1.
template <bool NF>
__device__ __forceinline__ void add_rows_product(float (&acc)[TF_D / 8][4],
                                                 const float (&c)[TF_TILE / 8][4],
                                                 const unsigned char* bhi,
                                                 const unsigned char* blo, int g, int t4) {
#pragma unroll
  for (int i = 0; i < TF_TILE / 8; ++i) {
    const Split f[4] = {split_as<NF>(c[i][0]), split_as<NF>(c[i][2]), split_as<NF>(c[i][1]), split_as<NF>(c[i][3])};
    const int row = 8 * i + 2 * t4;
#pragma unroll
    for (int n = 0; n < TF_D / 8; ++n) {
      const uint32_t o0 = sw_off(TF_TILE, row, 8 * n + g), o1 = sw_off(TF_TILE, row + 1, 8 * n + g);
      mma3<NF>(acc[n], f, ld_u32(bhi + o0), ld_u32(bhi + o1), ld_u32(blo + o0), ld_u32(blo + o1));
    }
  }
}

// One 32-row tile for one warp of a pair (role 0: dV, role 1: dK); xch is
// the pair's P^T, a lane's 16 values 32 lanes apart.
template <bool NF>
__device__ __forceinline__ void dkdv_tile(int role, int pair, const unsigned char* smem,
                                          const float2* st, float (&acc)[TF_D / 8][4], int kr0,
                                          int g, int t4, int key_lo, int key_hi, int r0,
                                          int n_rows, int g_shift, bool diag, float scale) {
  const unsigned char* qs = smem + KF_SPLIT;         // Q hi, Q lo, dO hi, dO lo
  float* xch = reinterpret_cast<float*>(const_cast<unsigned char*>(smem) + KF_XCH) +
               pair * 16 * 32 + (threadIdx.x & 31);
  float c[TF_TILE / 8][4];
  if (role == 0) {
    keys_by_rows<NF>(c, smem + KF_K, qs, qs + TF_PART, kr0, g, t4);          // S^T
#pragma unroll
    for (int j = 0; j < TF_TILE / 8; ++j) {
      const int ra = 8 * j + 2 * t4;                 // this lane's rows of the tile: ra, ra + 1
      const float la = st[ra].x, lb = st[ra + 1].x;
      const int pa = (r0 + ra) >> g_shift, pb = (r0 + ra + 1) >> g_shift;
      const bool oka = !diag || r0 + ra < n_rows, okb = !diag || r0 + ra + 1 < n_rows;
      c[j][0] = oka && (!diag || key_lo <= pa) ? expf(c[j][0] * scale - la) : 0.f;
      c[j][1] = okb && (!diag || key_lo <= pb) ? expf(c[j][1] * scale - lb) : 0.f;
      c[j][2] = oka && (!diag || key_hi <= pa) ? expf(c[j][2] * scale - la) : 0.f;
      c[j][3] = okb && (!diag || key_hi <= pb) ? expf(c[j][3] * scale - lb) : 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) xch[(4 * j + e) * 32] = c[j][e];
    }
    named_sync(1 + pair, 64);                        // P^T is there for the pair's dK warp
    add_rows_product<NF>(acc, c, qs + 2 * TF_PART, qs + 3 * TF_PART, g, t4);   // dV += P^T dO
  } else {
    keys_by_rows<NF>(c, smem + KF_V, qs + 2 * TF_PART, qs + 3 * TF_PART, kr0, g, t4);  // dP^T
    named_sync(1 + pair, 64);
#pragma unroll
    for (int j = 0; j < TF_TILE / 8; ++j) {
      const int ra = 8 * j + 2 * t4;
      const float da = st[ra].y, db = st[ra + 1].y;
      c[j][0] = xch[(4 * j) * 32] * (c[j][0] - da) * scale;
      c[j][1] = xch[(4 * j + 1) * 32] * (c[j][1] - db) * scale;
      c[j][2] = xch[(4 * j + 2) * 32] * (c[j][2] - da) * scale;
      c[j][3] = xch[(4 * j + 3) * 32] * (c[j][3] - db) * scale;
    }
    add_rows_product<NF>(acc, c, qs, qs + TF_PART, g, t4);                      // dK += dS^T Q
  }
}

// (b) dk, dv of 64 keys of one KV head, 8 warps: pair p (warps p and p + 4)
// owns keys 16 p .. 16 p + 15, warp p their dV and warp p + 4 their dK.
// Thread 0 loads K and V once, then the raw Q, dO and statistics of each
// 32-row tile from the first tile holding position k0 to the last, the
// next while the block works on this one; the block splits Q and dO into
// the split tile, then each pair with a key that a row of the tile sees
// runs dkdv_tile. PAD: Q and dO through the 5-D map, so an idle row holds
// zeros and adds nothing.
template <bool PAD>
__global__ void __launch_bounds__(TF_THREADS, 1)
flash_bwd_dkdv_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float2* __restrict__ stats, float* __restrict__ dk,
                          float* __restrict__ dv, int S, int Hkv, int g_shift, int NR,
                          float scale) {
  extern __shared__ __align__(1024) unsigned char f32_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(f32_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // swizzle atoms are 1024-byte aligned
  unsigned char* smem = f32_raw + (base - raw);
  const uint32_t bar_kv = base + KF_BAR;             // K and V landed
  const uint32_t bar_rows = bar_kv + 8;              // the tile's Q, dO, statistics landed

  // the warp's role and pair by a shuffle from lane 0, so the compiler sees
  // the branches on them as warp-uniform
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid / 32, 0), lane = tid & 31;
  const int role = warp >> 2, pair = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  [[maybe_unused]] const int G = 1 << g_shift;      // Gp; PAD reads the group's G from the map
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * KF_KEYS;
  const int n_rows = S << g_shift;
  const int t_first = (k0 << g_shift) / TF_TILE;     // the first tile holding position k0
  const int n_iter = (n_rows + TF_TILE - 1) / TF_TILE - t_first;
  const float2* st = stats + ((size_t)b * Hkv + kvh) * NR;

  // a box of 32 values x min(Gp, 32) heads x max(32 / Gp, 1) positions is
  // the tile's 32 rows in order; rows past S (PAD: and heads past the
  // group's G) arrive as zeros
  auto load_rows = [&](int i) {
    const int r0 = (t_first + i) * TF_TILE;
    if constexpr (PAD) {
      const int head = r0 & ((1 << g_shift) - 1), pos = r0 >> g_shift;
      mbar_expect_tx(bar_rows, 2 * TF_PART + TF_STATS);
      for (int a = 0; a < 4; ++a) {
        tma_load_5d(base + KF_RAW + a * TF_TILE * 128, &tm_q, bar_rows, 32 * a, head, kvh, pos,
                    b);
        tma_load_5d(base + KF_RAW + TF_PART + a * TF_TILE * 128, &tm_do, bar_rows, 32 * a,
                    head, kvh, pos, b);
      }
    } else {
      const int head = kvh * G + (r0 & (G - 1)), pos = r0 >> g_shift;
      mbar_expect_tx(bar_rows, 2 * TF_PART + TF_STATS);
      for (int a = 0; a < 4; ++a) {
        tma_load_4d(base + KF_RAW + a * TF_TILE * 128, &tm_q, bar_rows, 32 * a, head, pos, b);
        tma_load_4d(base + KF_RAW + TF_PART + a * TF_TILE * 128, &tm_do, bar_rows, 32 * a, head,
                    pos, b);
      }
    }
    bulk_load(base + KF_RAW_STATS, st + r0, TF_STATS, bar_rows);
  };
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_rows, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_kv, 2 * KF_KEYS * 512);       // keys past S arrive as zeros
    for (int a = 0; a < 4; ++a) {
      tma_load_4d(base + KF_K + a * KF_KEYS * 128, &tm_k, bar_kv, 32 * a, kvh, k0, b);
      tma_load_4d(base + KF_V + a * KF_KEYS * 128, &tm_v, bar_kv, 32 * a, kvh, k0, b);
    }
    load_rows(0);
  }
  __syncthreads();

  const int kr0 = 16 * pair + g;                     // this lane's keys: k0 + kr0, + 8
  const int key_lo = k0 + kr0, key_hi = key_lo + 8;
  const int kw_first = k0 + 16 * pair, kw_last = kw_first + 15;
  float acc[TF_D / 8][4];                               // role 0: dV, role 1: dK
#pragma unroll
  for (int n = 0; n < TF_D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float2* st_s = reinterpret_cast<const float2*>(smem + KF_STATS);
  // the lane's output rows: element offsets (-1: not stored)
  const size_t kv_row = (size_t)Hkv * TF_D;
  const size_t out0 = (size_t)b * S * kv_row + (size_t)kvh * TF_D + 2 * t4;
  float* out = role == 0 ? dv : dk;
  float* dst0 = key_lo < S ? out + out0 + (size_t)key_lo * kv_row : nullptr;
  float* dst1 = key_hi < S ? out + out0 + (size_t)key_hi * kv_row : nullptr;
  // a pair works on the tiles from the first whose last row reaches its
  // first key to the last; its sums move after each TF_CHAIN of them
  const int i_own = max(0, ((kw_first << g_shift) / TF_TILE) - t_first);
  mbar_wait(bar_kv, 0);
  // any inf or NaN in the block's K or V; a tile's own (its Q, dO and
  // statistics) joins it below (see the dq kernel)
  const bool kv_bad = __syncthreads_or(any_nonfinite(smem + KF_K, 2 * KF_KEYS * 512)) != 0;

  for (int i = 0; i < n_iter; ++i) {
    mbar_wait(bar_rows, (uint32_t)(i & 1));
    __syncthreads();                                 // the last tile's split is read out
    bool bad = split_tiles(smem + KF_RAW, smem + KF_SPLIT, TF_PART, 2);
    if (tid < TF_TILE) {
      const float2 x = reinterpret_cast<const float2*>(smem + KF_RAW_STATS)[tid];
      reinterpret_cast<float2*>(smem + KF_STATS)[tid] = x;
      bad |= !isfinite(x.x + x.y);
    }
    fence_proxy_async();                             // the raw tile is read: TMA may refill it
    bad = __syncthreads_or(bad) != 0;
    if (tid == 0 && i + 1 < n_iter) load_rows(i + 1);
    const int r0 = (t_first + i) * TF_TILE;
    const int p_lo = r0 >> g_shift, p_hi = min((r0 + TF_TILE - 1) >> g_shift, S - 1);
    if (p_hi >= kw_first) {                          // some row sees a key of this pair
      const bool diag = p_lo < kw_last || r0 + TF_TILE > n_rows;
      if (bad || kv_bad)
        dkdv_tile<true>(role, pair, smem, st_s, acc, kr0, g, t4, key_lo, key_hi, r0, n_rows,
                        g_shift, diag, scale);
      else
        dkdv_tile<false>(role, pair, smem, st_s, acc, kr0, g, t4, key_lo, key_hi, r0, n_rows,
                         g_shift, diag, scale);
      if ((i - i_own) % TF_CHAIN == TF_CHAIN - 1) flush_rows(acc, dst0, dst1, i - i_own < TF_CHAIN);
    }
  }
  const int n_own = max(n_iter - i_own, 0);          // the tiles the pair worked on
  if (n_own % TF_CHAIN != 0 || n_own == 0) flush_rows(acc, dst0, dst1, n_own < TF_CHAIN);
}


// ---------------------------------------------------------- bfloat16 route --

constexpr int WG_THREADS = 128;                    // a warpgroup
constexpr int WS_THREADS = 3 * WG_THREADS;         // producer + 2 consumer warpgroups
constexpr int WS_STAGES = 2;                       // the ring
constexpr int STATS_BYTES = BR * 8;                // (lse log2 e, delta) of a 64-row tile
constexpr int TILE_BOX = 64 * 128;                 // 64 dims of 64 rows (keys or q rows): 8 KB

// The shared memory of the bfloat16 route at head width D, in boxes of 64
// dims (128 bytes a row), D / 64 boxes a tile, from a 1024-byte aligned
// base. d=128: dk/dv 129 KB, dq 128 KB; d=64: 65 KB, 64 KB.
template <int D>
struct BwdSmem {
  static_assert(D == 64 || D == 128, "the bfloat16 route takes head widths 64 and 128");
  static constexpr int BOXES = D / 64;
  // dq: the forward's 128 rows a block; Q and dO (D / 64 boxes each), then
  // each stage's K and V (D / 64 boxes each), then the barriers
  static constexpr int DQ_ROWS = 128;
  static constexpr int DQ_BOX = DQ_ROWS * 128;     // 64 dims of the 128 rows: 16 KB
  static constexpr int DQ_Q = 0;
  static constexpr int DQ_DO = BOXES * DQ_BOX;
  static constexpr int DQ_KV = 2 * BOXES * DQ_BOX;
  static constexpr int DQ_STAGE = 2 * BOXES * TILE_BOX;
  static constexpr int DQ_BAR = DQ_KV + WS_STAGES * DQ_STAGE;
  static constexpr int DQ_SMEM = DQ_BAR + 8 * (1 + 3 * WS_STAGES) + 1024;   // + alignment slack
  // dk/dv: 128 keys a block; K and V (D / 64 boxes each), then each
  // stage's Q and dO (D / 64 boxes each), then each stage's statistics,
  // then the barriers
  static constexpr int KD_KEYS = 128;
  static constexpr int KD_BOX = KD_KEYS * 128;     // 64 dims of the 128 keys: 16 KB
  static constexpr int KD_K = 0;
  static constexpr int KD_V = BOXES * KD_BOX;
  static constexpr int KD_QD = 2 * BOXES * KD_BOX;
  static constexpr int KD_STAGE = 2 * BOXES * TILE_BOX;
  static constexpr int KD_STATS = KD_QD + WS_STAGES * KD_STAGE;
  static constexpr int KD_BAR = KD_STATS + WS_STAGES * STATS_BYTES;
  static constexpr int KD_SMEM = KD_BAR + 8 * (1 + 2 * WS_STAGES) + 1024;   // + alignment slack
};
constexpr int DQ_ROWS = BwdSmem<128>::DQ_ROWS;
constexpr int KD_KEYS = BwdSmem<128>::KD_KEYS;

// two floats as a bf16 pair, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (64 x 64) = A B^T over the D dims for one tile, issued and committed:
// A's 64 rows and B's 64 rows K-major, each tile's 64-dim boxes a_box and
// b_box bytes apart; D / 16 steps of 16 dims, 32 bytes apart in a box
template <int D>
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a, uint32_t a_box, uint32_t b,
                                         uint32_t b_box) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16_ss(d, gmma_desc(a + (kk >> 2) * a_box + (kk & 3) * 32, 16, 1024),
                       gmma_desc(b + (kk >> 2) * b_box + (kk & 3) * 32, 16, 1024), kk > 0);
  wgmma_commit();
}

// d (64 x D) += A B for one tile, issued and committed: A (64 x 64) from
// registers, B a 64-row tile read N-major (the sum runs over its rows), its
// 64-dim boxes TILE_BOX apart, 8-row groups 1 KB apart; 4 steps of 16
// rows, each an m64nDk16
template <int D>
__device__ __forceinline__ void issue_rs(float (&d)[D / 2], const uint32_t (&a)[BK / 16][4],
                                         uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t desc = gmma_desc(b + kk * 16 * 128, TILE_BOX, 1024);
    if constexpr (D == 128)
      wgmma_m64n128k16_rs(d, a[kk], desc);
    else
      wgmma_m64n64k16_rs(d, a[kk], desc);
  }
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

// The bf16 outputs of a warp's 16 rows of a 64 x D float32 accumulator
// into its rows of a 128-byte-swizzled tile at smem (its 64-dim boxes box
// bytes apart); row0 is the lane's first row in the tile.
template <int D>
__device__ __forceinline__ void stage_out(unsigned char* smem, int box, int row0,
                                          const float (&acc)[D / 2], int t4) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int off = (n >> 3) * box + (((n & 7) ^ (row0 & 7)) << 4) + 4 * t4;
    *reinterpret_cast<uint32_t*>(smem + off + row0 * 128) = pack_bf16(acc[4 * n], acc[4 * n + 1]);
    *reinterpret_cast<uint32_t*>(smem + off + (row0 + 8) * 128) =
        pack_bf16(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// (b) dk, dv of 128 keys of one KV head at head width D: 3 warpgroups;
// warpgroup 0 loads K and V once, then each 64-row q tile's Q, dO and
// statistics from the first tile holding position k0 to the last into a
// 2-stage ring; warpgroups 1 and 2 own keys k0 .. k0 + 63 and k0 + 64 ..
// k0 + 127. For each tile a consumer runs S^T = K Q^T and dP^T = V dO^T
// (D / 16 wgmma m64n64k16 each, both by descriptor), then dV += P^T dO and
// dK += dS^T Q (4 wgmma m64nDk16 each, P^T and dS^T from registers, dO and
// Q N-major). The accumulator's rows are the group's keys, its columns the
// tile's rows (S^T, dP^T) or the D dims (dK, dV). PAD: Q and dO through the
// 5-D map, so an idle row holds zeros and adds nothing.
template <int D, bool PAD>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const float2* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int S, int Hkv, int g_shift, int NR,
                            float scale, float scale_log2) {
  using L = BwdSmem<D>;
  constexpr int BOXES = L::BOXES;
  extern __shared__ __align__(1024) unsigned char ws_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(ws_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // swizzle atoms are 1024-byte aligned
  unsigned char* smem = ws_raw + (base - raw);
  const uint32_t bar_kv = base + L::KD_BAR;          // K and V landed
  const uint32_t bar_f = bar_kv + 8;                 // full: Q, dO, statistics of stage s
  const uint32_t bar_e = bar_f + 8 * WS_STAGES;      // empty: both consumers done with s

  // the warpgroup by a shuffle from lane 0, so the compiler sees the role
  // branches as warp-uniform
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / WG_THREADS, 0);
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
      mbar_expect_tx(bar_kv, 2 * BOXES * L::KD_BOX);  // keys past S arrive as zeros
      for (int x = 0; x < BOXES; ++x) {
        tma_load_4d(base + L::KD_K + x * L::KD_BOX, &tm_k, bar_kv, 64 * x, kvh, k0, b);
        tma_load_4d(base + L::KD_V + x * L::KD_BOX, &tm_v, bar_kv, 64 * x, kvh, k0, b);
      }
      const float2* st = stats + ((size_t)b * Hkv + kvh) * NR;
      for (int i = 0; i < n_iter; ++i) {
        const int s = i % WS_STAGES;
        if (i >= WS_STAGES) mbar_wait(bar_e + 8 * s, ((i / WS_STAGES) - 1) & 1);
        // a box of 64 dims x min(Gp, 64) heads x max(64 / Gp, 1) positions
        // is the tile's 64 rows in order; rows past S (PAD: and heads past
        // the group's G) arrive as zeros
        const int r0 = (t_first + i) * BR;
        const uint32_t qd = base + L::KD_QD + s * L::KD_STAGE, full = bar_f + 8 * s;
        mbar_expect_tx(full, 2 * BOXES * TILE_BOX + STATS_BYTES);
        if constexpr (PAD) {
          const int head = r0 & ((1 << g_shift) - 1), pos = r0 >> g_shift;
          for (int x = 0; x < BOXES; ++x) {
            tma_load_5d(qd + x * TILE_BOX, &tm_q, full, 64 * x, head, kvh, pos, b);
            tma_load_5d(qd + (BOXES + x) * TILE_BOX, &tm_do, full, 64 * x, head, kvh, pos, b);
          }
        } else {
          const int G = 1 << g_shift;
          const int head = kvh * G + (r0 & (G - 1)), pos = r0 >> g_shift;
          for (int x = 0; x < BOXES; ++x) {
            tma_load_4d(qd + x * TILE_BOX, &tm_q, full, 64 * x, head, pos, b);
            tma_load_4d(qd + (BOXES + x) * TILE_BOX, &tm_do, full, 64 * x, head, pos, b);
          }
        }
        bulk_load(base + L::KD_STATS + s * STATS_BYTES, st + r0, STATS_BYTES, full);
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
  const uint32_t k_rows = base + L::KD_K + c * 64 * 128, v_rows = base + L::KD_V + c * 64 * 128;

  float dk_acc[D / 2], dv_acc[D / 2], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
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
      const uint32_t qd = base + L::KD_QD + s * L::KD_STAGE;
      // K's and V's addresses made opaque here, so their descriptors are
      // formed at each tile rather than held in registers across tiles
      uint32_t ka = k_rows, va = v_rows;
      asm volatile("" : "+r"(ka), "+r"(va));
      // (lse log2 e, delta) of the tile's rows 2 m and 2 m + 1: float4 m
      const float4* st = reinterpret_cast<const float4*>(smem + L::KD_STATS + s * STATS_BYTES);
      fence_regs(sc);
      issue_ss<D>(sc, ka, L::KD_BOX, qd, TILE_BOX);                          // S^T = K Q^T
      fence_regs(dp);
      issue_ss<D>(dp, va, L::KD_BOX, qd + BOXES * TILE_BOX, TILE_BOX);       // dP^T = V dO^T
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
      issue_rs<D>(dv_acc, pa, qd + BOXES * TILE_BOX);   // dV += P^T dO
      fence_regs(dk_acc);
      issue_rs<D>(dk_acc, da, qd);                      // dK += dS^T Q
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    mbar_arrive(bar_e + 8 * s);
  }

  // out: dK and dV in bf16 through this warp's own 16 rows of the K and V
  // tiles (read out by now), then 16-byte stores, D / 8 a row
  constexpr int CHUNKS = D / 8;
  stage_out<D>(smem + L::KD_K, L::KD_BOX, row0, dk_acc, t4);
  stage_out<D>(smem + L::KD_V, L::KD_BOX, row0, dv_acc, t4);
  __syncwarp();
  const size_t kv_row = (size_t)Hkv * D;
  const size_t out0 = (size_t)b * S * kv_row + (size_t)kvh * D;
#pragma unroll
  for (int i = 0; i < 16 * CHUNKS / 32; ++i) {
    const int cidx = i * 32 + lane;
    const int r = 64 * c + 16 * warp + cidx / CHUNKS, ch = cidx % CHUNKS;
    const int key = k0 + r;
    if (key < S) {
      const int off = (ch >> 3) * L::KD_BOX + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
      const size_t dst = out0 + (size_t)key * kv_row + ch * 8;
      *reinterpret_cast<uint4*>(dk + dst) =
          *reinterpret_cast<const uint4*>(smem + L::KD_K + off);
      *reinterpret_cast<uint4*>(dv + dst) =
          *reinterpret_cast<const uint4*>(smem + L::KD_V + off);
    }
  }
}

// (c) dq of 128 rows (BQ = 128 / Gp positions x Gp heads) of one KV head
// at head width D: 3 warpgroups; warpgroup 0 loads Q and dO once, then K
// and V of each 64-key tile up to the block's last position into a 2-stage
// ring; warpgroups 1 and 2 own rows 0..63 and 64..127. For each tile a
// consumer runs S = Q K^T and dP = dO V^T (D / 16 wgmma m64n64k16 each,
// both by descriptor), then dQ += dS K (4 wgmma m64nDk16, dS from
// registers, K N-major). PAD: Q and dO through the 5-D map, idle rows
// zeros and never stored.
template <int D, bool PAD>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float2* __restrict__ stats, __nv_bfloat16* __restrict__ dq,
                          int S, int H, int Hkv, int g_shift, int NR, float scale,
                          float scale_log2) {
  using L = BwdSmem<D>;
  constexpr int BOXES = L::BOXES;
  extern __shared__ __align__(1024) unsigned char ws_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(ws_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // swizzle atoms are 1024-byte aligned
  unsigned char* smem = ws_raw + (base - raw);
  const uint32_t bar_q = base + L::DQ_BAR;           // Q and dO landed
  const uint32_t bar_k = bar_q + 8;                  // full: K of stage s landed
  const uint32_t bar_v = bar_k + 8 * WS_STAGES;      // full: V of stage s landed
  const uint32_t bar_e = bar_v + 8 * WS_STAGES;      // empty: both consumers done with s

  // the warpgroup by a shuffle from lane 0, so the compiler sees the role
  // branches as warp-uniform
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / WG_THREADS, 0);
  // PAD: G = H / Hkv below Gp = 1 << g_shift, rows G .. Gp - 1 of a position idle
  const int G = PAD ? H / (int)gridDim.y : 1 << g_shift;
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
      // Q, dO: a box of 64 dims x Gp heads x BQ positions is the 128 rows in
      // order r = position * Gp + head, 128 bytes a row
      mbar_expect_tx(bar_q, 2 * BOXES * L::DQ_BOX);
      for (int x = 0; x < BOXES; ++x) {
        if constexpr (PAD) {                         // heads past the group's G arrive as zeros
          tma_load_5d(base + L::DQ_Q + x * L::DQ_BOX, &tm_q, bar_q, 64 * x, 0, kvh, q0, b);
          tma_load_5d(base + L::DQ_DO + x * L::DQ_BOX, &tm_do, bar_q, 64 * x, 0, kvh, q0, b);
        } else {
          tma_load_4d(base + L::DQ_Q + x * L::DQ_BOX, &tm_q, bar_q, 64 * x, kvh * G, q0, b);
          tma_load_4d(base + L::DQ_DO + x * L::DQ_BOX, &tm_do, bar_q, 64 * x, kvh * G, q0, b);
        }
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % WS_STAGES;
        if (t >= WS_STAGES) mbar_wait(bar_e + 8 * s, ((t / WS_STAGES) - 1) & 1);
        const uint32_t kv = base + L::DQ_KV + s * L::DQ_STAGE;
        mbar_expect_tx(bar_k + 8 * s, BOXES * TILE_BOX);   // keys past S arrive as zeros
        for (int x = 0; x < BOXES; ++x)
          tma_load_4d(kv + x * TILE_BOX, &tm_k, bar_k + 8 * s, 64 * x, kvh, t * BK, b);
        mbar_expect_tx(bar_v + 8 * s, BOXES * TILE_BOX);
        for (int x = 0; x < BOXES; ++x)
          tma_load_4d(kv + (BOXES + x) * TILE_BOX, &tm_v, bar_v + 8 * s, 64 * x, kvh, t * BK,
                      b);
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
  const uint32_t q_rows = base + L::DQ_Q + c * 64 * 128, do_rows = base + L::DQ_DO + c * 64 * 128;
  // this lane's rows' (lse log2 e, delta): the block's rows are rows
  // qt * 128 .. of its (b, KV head) in the statistics' order
  const float2* st = stats + ((size_t)b * Hkv + kvh) * NR + (size_t)qt * DQ_ROWS;
  const float2 st0 = st[row0], st1 = st[row0 + 8];

  float acc[D / 2], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
  uint32_t da[BK / 16][4];
  // tiles holding a key at or before this group's last position (none if
  // its rows all lie past S); the rest are masked for every row of the group
  const int n_own = wg_first < S ? min(n_tiles, (wg_last / BK) + 1) : 0;
  auto stage_at = [&](int t) { return base + L::DQ_KV + (t % WS_STAGES) * L::DQ_STAGE; };
  auto phase_of = [&](int t) { return (uint32_t)((t / WS_STAGES) & 1); };
  mbar_wait(bar_q, 0);

  for (int t = 0; t < n_own; ++t) {
    const uint32_t kv = stage_at(t);
    mbar_wait(bar_k + 8 * (t % WS_STAGES), phase_of(t));
    fence_regs(sc);
    issue_ss<D>(sc, q_rows, L::DQ_BOX, kv, TILE_BOX);                        // S = Q K^T
    mbar_wait(bar_v + 8 * (t % WS_STAGES), phase_of(t));
    fence_regs(dp);
    issue_ss<D>(dp, do_rows, L::DQ_BOX, kv + BOXES * TILE_BOX, TILE_BOX);    // dP = dO V^T
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
    issue_rs<D>(acc, da, kv);                        // dQ += dS K
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
  // by now), then 16-byte stores, D / 8 a row
  constexpr int CHUNKS = D / 8;
  stage_out<D>(smem + L::DQ_Q, L::DQ_BOX, row0, acc, t4);
  __syncwarp();
  const size_t q_row = (size_t)H * D;
  __nv_bfloat16* dqb = dq + (size_t)b * S * q_row + (size_t)kvh * G * D;
  const int gmask = PAD ? (1 << g_shift) - 1 : G - 1;   // a row's head is row & gmask
#pragma unroll
  for (int i = 0; i < 16 * CHUNKS / 32; ++i) {
    const int cidx = i * 32 + lane;
    const int r = 64 * c + 16 * warp + cidx / CHUNKS, ch = cidx % CHUNKS;
    const int pos = q0 + (r >> g_shift), head = r & gmask;
    if ((!PAD || head < G) && pos < S)               // idle rows are never stored
      *reinterpret_cast<uint4*>(dqb + (size_t)pos * q_row + head * D + ch * 8) =
          *reinterpret_cast<const uint4*>(smem + L::DQ_Q + (ch >> 3) * L::DQ_BOX + r * 128 +
                                          (((ch & 7) ^ (r & 7)) << 4));
  }
}

// the shift of Gp, the power of two at or above g
int log2_of(int g) {
  int shift = 0;
  while ((1 << shift) < g) ++shift;
  return shift;
}

// rows of a (batch row, KV head) in the statistics: S * Gp padded to STAT_ROWS
int stat_rows(int S, int g_shift) {
  return (((S << g_shift) + STAT_ROWS - 1) / STAT_ROWS) * STAT_ROWS;
}

// Lets the twelve kernels (six, each with and without PAD) take their
// dynamic shared memory. The sizes are constants, so this runs once a
// device in a process (on every call past device 63); two threads that
// race both set the same values.
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  const struct { const void* fn; int bytes; } kernels[] = {
      {(const void*)flash_bwd_dkdv_f32_kernel<false>, KF_SMEM},
      {(const void*)flash_bwd_dq_f32_kernel<false>, QF_SMEM},
      {(const void*)flash_bwd_dkdv_wgmma_kernel<128, false>, BwdSmem<128>::KD_SMEM},
      {(const void*)flash_bwd_dq_wgmma_kernel<128, false>, BwdSmem<128>::DQ_SMEM},
      {(const void*)flash_bwd_dkdv_wgmma_kernel<64, false>, BwdSmem<64>::KD_SMEM},
      {(const void*)flash_bwd_dq_wgmma_kernel<64, false>, BwdSmem<64>::DQ_SMEM},
      {(const void*)flash_bwd_dkdv_f32_kernel<true>, KF_SMEM},
      {(const void*)flash_bwd_dq_f32_kernel<true>, QF_SMEM},
      {(const void*)flash_bwd_dkdv_wgmma_kernel<128, true>, BwdSmem<128>::KD_SMEM},
      {(const void*)flash_bwd_dq_wgmma_kernel<128, true>, BwdSmem<128>::DQ_SMEM},
      {(const void*)flash_bwd_dkdv_wgmma_kernel<64, true>, BwdSmem<64>::KD_SMEM},
      {(const void*)flash_bwd_dq_wgmma_kernel<64, true>, BwdSmem<64>::DQ_SMEM}};
  for (const auto& kn : kernels) {
    err = cudaFuncSetAttribute(kn.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kn.bytes);
    if (err != cudaSuccess) return err;
  }
  done.fetch_or(bit, std::memory_order_relaxed);
  return cudaSuccess;
}

// (B, S, Hkv, G, width) as a 5-D map, innermost first (PAD's Q and dO),
// read in boxes of 64 bf16 or 32 float32 values (128 bytes) x box_heads x
// 1 KV head x box_rows positions with the 128-byte swizzle: a box box_heads
// tall from a head of the group holds the group's own heads and zeros past
// its G, TMA's out-of-bounds fill, never the next group's
bool encode_group_map(PFN_cuTensorMapEncodeTiled_v12000 encode, CUtensorMap* map,
                      const void* ptr, bool f32, int B, int S, int Hkv, int G, int head_width,
                      int box_heads, int box_rows) {
  const cuuint64_t width = (cuuint64_t)head_width, bytes = f32 ? 4 : 2;
  const cuuint64_t dims[5] = {width, (cuuint64_t)G, (cuuint64_t)Hkv, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {width * bytes, (cuuint64_t)G * width * bytes,
                                 (cuuint64_t)Hkv * G * width * bytes,
                                 (cuuint64_t)S * Hkv * G * width * bytes};
  const cuuint32_t box[5] = {f32 ? 32u : 64u, (cuuint32_t)box_heads, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The statistics kernel, then dk/dv, then dq, on the caller's stream, at
// head width D, each the PAD instance where G is not a power of two. Each
// is a 3xTF32 kernel for float32 (D = TF_D only) and a wgmma one for
// bfloat16.
template <int D, bool PAD>
cudaError_t launch_as(int dtype, const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* scratch, void* dq, void* dk,
                      void* dv, int B, int S, int H, int Hkv, float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const bool f32 = dtype == 0;   // only at D = TF_D (the entry point's check)
  const cudaError_t ctx = make_context_current();
  if (ctx != cudaSuccess) return ctx;
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int G = H / Hkv, g_shift = log2_of(G), Gp = 1 << g_shift;
  const int NR = stat_rows(S, g_shift);
  // dq reads the forward's 128-row boxes; dk/dv reads row tiles of
  // kd_rows (bfloat16 64, float32 32), one position's run of heads where Gp
  // is larger; K and V arrive in the dq kernel's key tiles and the dk/dv
  // kernel's 128-key blocks
  static_assert(QF_ROWS == DQ_ROWS, "both routes' dq kernels take the forward's 128 rows");
  const int kd_rows = f32 ? TF_TILE : BR, dq_keys = f32 ? TF_TILE : BK;
  const int kd_keys = f32 ? KF_KEYS : KD_KEYS;
  const int kd_heads = Gp < kd_rows ? Gp : kd_rows;
  const int kd_positions = Gp < kd_rows ? kd_rows >> g_shift : 1;
  const auto map = [f32](PFN_cuTensorMapEncodeTiled_v12000 enc, CUtensorMap* m, const void* p,
                         int b, int s, int heads, int box_heads, int box_rows) {
    return f32 ? encode_map_f32(enc, m, p, b, s, heads, box_heads, box_rows)
               : encode_map(enc, m, p, b, s, heads, D, box_heads, box_rows);
  };
  // Q and dO: (B, S, H, d) as 4-D maps, or PAD's 5-D view of the groups
  const auto rows_map = [&](CUtensorMap* m, const void* p, int box_heads, int box_rows) {
    return PAD ? encode_group_map(encode, m, p, f32, B, S, Hkv, G, D, box_heads, box_rows)
               : map(encode, m, p, B, S, H, box_heads, box_rows);
  };
  CUtensorMap q_dq, do_dq, k_dq, v_dq, q_kd, do_kd, k_kd, v_kd;
  if (!rows_map(&q_dq, q, Gp, DQ_ROWS >> g_shift) ||
      !rows_map(&do_dq, dout, Gp, DQ_ROWS >> g_shift) ||
      !map(encode, &k_dq, k, B, S, Hkv, 1, dq_keys) ||
      !map(encode, &v_dq, v, B, S, Hkv, 1, dq_keys) ||
      !rows_map(&q_kd, q, kd_heads, kd_positions) ||
      !rows_map(&do_kd, dout, kd_heads, kd_positions) ||
      !map(encode, &k_kd, k, B, S, Hkv, 1, kd_keys) ||
      !map(encode, &v_kd, v, B, S, Hkv, 1, kd_keys))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return err;
  float2* stats = reinterpret_cast<float2*>(scratch);
  const size_t n_rows = (size_t)B * Hkv * NR;        // a multiple of the 8 warps a block
  const unsigned stat_blocks = (unsigned)(n_rows / (THREADS / 32));
  const dim3 grid_kd((S + kd_keys - 1) / kd_keys, Hkv, B), grid_dq(NR / DQ_ROWS, Hkv, B);
  if constexpr (D == TF_D) {
    if (f32) {
      flash_bwd_stats_kernel<float, TF_D, PAD><<<stat_blocks, THREADS, 0, stream>>>(
          static_cast<const float*>(o), static_cast<const float*>(dout), lse, stats, S, H, Hkv,
          g_shift, NR, n_rows, 1.f);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      flash_bwd_dkdv_f32_kernel<PAD><<<grid_kd, TF_THREADS, KF_SMEM, stream>>>(
          q_kd, do_kd, k_kd, v_kd, stats, static_cast<float*>(dk), static_cast<float*>(dv), S,
          Hkv, g_shift, NR, scale);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      flash_bwd_dq_f32_kernel<PAD><<<grid_dq, TF_THREADS, QF_SMEM, stream>>>(
          q_dq, do_dq, k_dq, v_dq, stats, static_cast<float*>(dq), S, H, Hkv, g_shift, NR,
          scale);
      return cudaGetLastError();
    }
  }
  flash_bwd_stats_kernel<bf16, D, PAD><<<stat_blocks, THREADS, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, stats, S, H, Hkv,
      g_shift, NR, n_rows, LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * LOG2E;
  flash_bwd_dkdv_wgmma_kernel<D, PAD><<<grid_kd, WS_THREADS, BwdSmem<D>::KD_SMEM, stream>>>(
      q_kd, do_kd, k_kd, v_kd, stats, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, Hkv,
      g_shift, NR, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma_kernel<D, PAD><<<grid_dq, WS_THREADS, BwdSmem<D>::DQ_SMEM, stream>>>(
      q_dq, do_dq, k_dq, v_dq, stats, static_cast<bf16*>(dq), S, H, Hkv, g_shift, NR, scale,
      scale_log2);
  return cudaGetLastError();
}

// launch_as at head width D: the instances without the idle-row guards
// where G is a power of two
template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* scratch, void* dq, void* dk,
                   void* dv, int B, int S, int H, int Hkv, float scale, cudaStream_t stream) {
  const int G = H / Hkv;
  const auto run = G == 1 << log2_of(G) ? launch_as<D, false> : launch_as<D, true>;
  return run(dtype, q, k, v, o, dout, lse, scratch, dq, dk, dv, B, S, H, Hkv, scale, stream);
}

// float32 values of scratch the kernels need at this shape, for either
// dtype: 2 * B * Hkv * (S * Gp padded to STAT_ROWS)
long long scratch_values(int B, int S, int H, int Hkv) {
  return 2ll * B * Hkv * stat_rows(S, log2_of(H / Hkv));
}

// whether a dtype's route is compiled for head width d: bfloat16 64 and
// 128, float32 TF_D
bool takes(int dtype, int d) {
  return dtype == 1 ? (d == 64 || d == 128) : dtype == 0 && d == TF_D;
}

}  // namespace

// dtype 0: float32 (d = 128), 1: bfloat16 (d = 64 or 128); any G = H /
// Hkv up to 128. scratch is the caller's float32 scratch of scratch_len
// values, at least 2 * B * Hkv * (S * Gp padded to 128), Gp the power of
// two at or above G: each row's (lse, delta) pair in block-row order
// (bfloat16: lse log2 e; an idle row's (0, 0)). Returns cudaGetLastError()
// after the launches (cudaErrorInvalidValue, without launching, for a
// dtype, width or shape it does not take, or a scratch too small).
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const float* lse,
                                   float* scratch, long long scratch_len, void* dq, void* dk,
                                   void* dv, int B, int S, int H, int Hkv, int d, float scale,
                                   void* stream) {
  if (!takes(dtype, d) || B < 1 || S < 1 || Hkv < 1 || H < Hkv || H % Hkv != 0 ||
      H / Hkv > 128 || B > 65535 || Hkv > 65535 ||
      ((long long)S << log2_of(H / Hkv)) > (1ll << 30) ||
      scratch_len < scratch_values(B, S, H, Hkv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return (int)launch<64>(dtype, q, k, v, o, dout, lse, scratch, dq, dk, dv, B, S, H, Hkv,
                           scale, st);
  return (int)launch<128>(dtype, q, k, v, o, dout, lse, scratch, dq, dk, dv, B, S, H, Hkv,
                          scale, st);
}

// What a dtype's kernels at head width d hold on the card, for the logs:
// for kernel 0 (dk/dv) and 1 (dq), info[0] registers and [1] local (spill)
// bytes a thread, [2] static and [3] dynamic shared memory bytes a block,
// [4] blocks resident on an SM, [5] threads a block, [6] the design (2:
// wgmma + TMA, 3: 3xTF32 mma.sync + TMA): of the instances a power-of-two
// G runs (a padded G's add the 5-D loads and the idle-row guards; the
// build's ptxas report lists their registers). Returns a cudaError_t
// (cudaErrorInvalidValue for a dtype and width with no kernel).
extern "C" int flash_attention_bwd_route_info(int dtype, int which, int d, int* info) {
  if (!takes(dtype, d) || (which != 0 && which != 1)) return (int)cudaErrorInvalidValue;
  const void* fn;
  int smem, threads;
  if (dtype == 1 && d == 128) {
    fn = which == 0 ? (const void*)flash_bwd_dkdv_wgmma_kernel<128, false>
                    : (const void*)flash_bwd_dq_wgmma_kernel<128, false>;
    smem = which == 0 ? BwdSmem<128>::KD_SMEM : BwdSmem<128>::DQ_SMEM;
    threads = WS_THREADS;
  } else if (dtype == 1) {
    fn = which == 0 ? (const void*)flash_bwd_dkdv_wgmma_kernel<64, false>
                    : (const void*)flash_bwd_dq_wgmma_kernel<64, false>;
    smem = which == 0 ? BwdSmem<64>::KD_SMEM : BwdSmem<64>::DQ_SMEM;
    threads = WS_THREADS;
  } else {
    fn = which == 0 ? (const void*)flash_bwd_dkdv_f32_kernel<false>
                    : (const void*)flash_bwd_dq_f32_kernel<false>;
    smem = which == 0 ? KF_SMEM : QF_SMEM;
    threads = TF_THREADS;
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
  info[6] = dtype == 1 ? 2 : 3;   // 2: wgmma + TMA, 3: 3xTF32 mma.sync + TMA
  return 0;
}
