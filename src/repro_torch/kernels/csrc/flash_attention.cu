// flash_attention for Hopper (sm_90a): causal GQA attention forward with an
// online softmax, the attention of every LM prefill layer.
//
//   q (B, S, H, d), k/v (B, S, Hkv, d) -> o (B, S, H, d), all contiguous;
//   float32 or bfloat16 in and out; products, (m, l, acc) and the softmax in
//   float32; scale 1/sqrt(d); query head h reads KV head h / G, G = H / Hkv
//   (JAX's reshape of (B, S, H, d) to (B, S, Hkv, G, d)).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:63
// (flash_attention; body _kernel at :24, pallas_call at :77), which folded
// the G query heads of a KV head into a (G*block_q, d) tile and asserted
// S % block == 0.
//
// Bound on an H100 SXM. Causal attention needs two products of d terms for
// each visible (query, key) pair, S(S+1)/2 pairs per query head:
//   operations 4 * B * H * d * S(S+1)/2
//   bytes      itemsize * B * S * d * (2H + 2Hkv)   (q, o, k, v once)
// At qwen3-0.6b's prefill of B=8, S=2048 (H=16, Hkv=8, d=128): 1.375e11
// operations, 0.139 ms at 989 TFLOP/s in bfloat16; in float32 2.052 ms at
// 67 TFLOP/s on the CUDA cores and 0.833 ms in 3xTF32 on the tensor cores
// (three TF32 products at 495 TFLOP/s), against 0.060 ms (bfloat16) or
// 0.120 ms (float32) for the bytes: bound by operations, and by more the
// longer the sequence. granite-3-2b's prefill of B=8, S=2048 (H=32, Hkv=8,
// d=64) has the same H * d, so the same 1.375e11 operations and 0.139 ms,
// against 0.050 ms for the bytes; but twice the scores, 5.4e8
// exponentials, which take ~0.13 ms at 16 ex2 a clock on 132 SMs, beside
// the products and outside the bound's count. Products on masked pairs of
// the diagonal tiles are overhead above that bound.
//
// Both routes share the block shape. One block per (q tile, KV head, batch
// row); a block's 128 rows are BQ = 128 / Gp query positions x Gp heads,
// Gp the power of two at or above G (row r = position r / Gp, head r % Gp),
// so a K/V tile read from device memory serves all G heads of its KV head.
// G may be any group size up to 128, as the Pallas kernel's is: where G is
// a power of two (1, 2, 4, 8: qwen3-0.6b, granite-3-2b, the MoE configs)
// Gp = G and every row holds a query head of the group. Otherwise (G = 7,
// deepseek-coder-33b's 56 over 8: Gp = 8, BQ = 16) a position's rows
// G .. Gp - 1 are idle: the Q box is Gp heads tall from the group's first
// head, so they hold the next group's first heads, or TMA's zeros past H
// for the last group. They are computed with this KV head's keys and never
// stored (every out and lse write asks head < G), and the float32 route
// leaves them out of its flag for non-finite Q; a row's max and sum never
// leave its own lanes, so an idle row touches no other. Those guards are a
// template parameter (PAD): a power-of-two G runs an instance without
// them, the code it ran before any G was padded. Their products
// (1/8 of them at G = 7) are overhead above the bound, like the masked
// pairs of the diagonal tiles. Blocks take q tiles from the last one down,
// so the longest causal rows start first. The kv loop stops at the tile
// that holds the block's last query position. Masked scores are -1e30,
// never -inf, and the output is acc / max(l, 1e-30), written once in the
// input's type. Rows past S are staged as zeros and never stored, so any
// S >= 1 works (no S % block condition). Where the caller passes an lse
// buffer (training: the backward in flash_attention_bwd.cu recomputes each
// tile's probabilities from it), each row's natural log-sum-exp of its
// scaled scores, m + log(max(l, 1e-30)) with m in scaled units, is written
// to lse (B, H, S) float32, once, by the lane that holds the row's full
// sum; with lse null (serving) nothing more is written. Both run on the
// caller's stream and allocate nothing. The bfloat16 route is compiled for
// d = 64 (granite-3-2b's head width) and d = 128 (qwen3-0.6b's,
// deepseek-coder-33b's and the MoE configs'), a template on d; the float32
// route for d = 128 only. The wrapper refuses other widths.
//
// bfloat16 route, the serving path: stage 2 of the tensor-core design,
// wgmma + TMA, warp-specialised (stage 1, mma.sync + cp.async with 8 warps
// of 16 rows, was its first step). Both products run on the tensor cores,
// which is what the operations bound asks for:
//   * 3 warpgroups of 128 threads. Warpgroup 0 is the producer: it gives
//     up registers (setmaxnreg 40) and one thread issues TMA tensor-map
//     loads: the block's Q once, then K and V of each 64-key tile into a
//     ring of 2 stages, each with a "full" mbarrier for K, one for V and
//     an "empty" one the consumers arrive on. Warpgroups 1 and 2 (setmaxnreg
//     232) are the consumers of rows 0..63 and 64..127; a row's max and sum
//     stay inside a quad of lanes, and the scores never touch shared memory;
//   * S = Q K^T by d / 16 wgmma m64n64k16 a tile (8 at d = 128, 4 at 64),
//     Q and K read by shared-memory descriptors; O += P V by 4 wgmma
//     m64n128k16 (d = 128) or m64n64k16 (d = 64) with P from registers and
//     V by descriptor (N-major, transposed by the instruction). Both are
//     bfloat16 products with float32 sums, exactly the reference's
//     arithmetic (ref.flash_attention_ref: float32 scores, P cast to v's
//     type, float32 sums);
//   * P stays in registers: the float32 accumulator of S, scaled and
//     exponentiated, packed to bfloat16 pairs, is the A operand of the P V
//     product (the accumulator and A fragments share m16n8's layout);
//   * the TMA boxes are 64 dims (128 bytes) wide, d / 64 of them a tile,
//     loaded with the 128-byte swizzle that the descriptors name, so wgmma
//     reads without bank conflicts; a Q box is 64 dims x Gp heads x 128 /
//     Gp positions, the block's rows in order. Keys and rows past S arrive
//     as zeros (TMA's out-of-bounds fill); the causal mask hides such keys
//     from every stored row;
//   * a consumer runs a tile as S, its softmax, then P V, waiting for each
//     product; the two consumers and the producer's loads overlap each
//     other as the hardware schedules them (issuing S of tile t ahead of
//     P V of tile t - 1, making the consumers take turns at the tensor
//     cores, or a third ring stage ran no faster);
//   * softmax in the log2 domain: exp2f(s * scale * log2 e - m'), one FMA a
//     score; the compare-and-mask runs only on tiles that cross the
//     diagonal, and a consumer skips the tiles past its last position;
//   * cuTensorMapEncodeTiled is found through
//     cudaGetDriverEntryPointByVersion (CUDA 12.5 or later), so the library
//     needs no -lcuda. A barrier wait that lasts seconds traps,
//     so a fault ends the launch with an error rather than a hang. These
//     helpers, the descriptors and the wgmma wrappers are in hopper.cuh,
//     which the backward (flash_attention_bwd.cu) shares;
//   * the output goes through the consumer's own rows of the Q tile in
//     shared memory (Q is read out by then), so it leaves in 16-byte stores,
//     once, in bfloat16.
// Shared memory: at d = 128 Q 32 KB + 2 stages x (K 16 KB + V 16 KB) = 96
// KB, at d = 64 half of that, 48 KB; one block of 384 threads an SM. At d =
// 64 a stage holds half the bytes for the same 64 keys; the ring keeps its
// 2 stages and 64-key tiles (a deeper ring or 128-key tiles is later
// work).
//
// float32 route: 3xTF32 on the tensor cores, wgmma + TMA, warp-specialised
// like the bfloat16 route. float32 is held to 2e-5 (max abs and error
// norm); one TF32 product keeps about 2^-11 of each operand and misses
// that by far, so every product runs as three: each operand split v = hi +
// lo, both rounded as cvt.rna.tf32.f32 rounds, and lo*hi + hi*lo + hi*hi
// summed into float32, the small terms first (tf32.cuh, the conv's
// arithmetic). The softmax, m, l and lse stay float32; MASK stays -1e30.
// The design aims at the 3xTF32 bound (0.833 ms at 8 x 2048):
//   * 3 warpgroups of 128 threads. Warpgroup 0 loads and splits (setmaxnreg
//     56): one thread issues the TMA loads, Q once and the raw K and V of
//     each 32-key tile into a 2-stage ring (float32 boxes of 32 values, 128
//     bytes, with the 128-byte swizzle); the group splits each tile into
//     K's hi, hi_c and lo tiles at the raw offsets and V^T's, transposed.
//     Warpgroups 1 and 2 (setmaxnreg 224) consume rows 0..63 and 64..127;
//     "full" and "empty" mbarriers for K's and V^T's split tiles let the
//     split of one overlap the products on the other;
//   * wgmma takes tf32 operands K-major only, A and B (the transpose bits
//     exist for 16-bit types). S = Q K^T fits K as stored; P V needs V^T,
//     keys contiguous, which the split pass writes. P's A fragment is S's
//     accumulator as it stands: a lane holds keys 2t, 2t + 1 of each 8
//     where the fragment wants columns t, t + 4, so V^T stores each 8 keys
//     in the order 0, 2, 4, 6, 1, 3, 5, 7 and the P V sum runs over them in
//     that order;
//   * each consumer splits its rows of Q once: hi kept in registers as A
//     fragments (64 a thread), lo written over the raw Q, which the Q lo
//     pass reads by descriptor. S = Q lo K hi_c + Q hi K lo + Q hi K hi, 16
//     wgmma m64n32k8 each; O += P lo V^T hi_c + P hi V^T lo + P hi V^T hi,
//     4 wgmma m64n128k8 each, P split from the accumulator into registers;
//   * non-finite inputs follow float32, not the split (tf32.cuh): the hi_c
//     tiles are 0 at K's and V's inf and NaN, and a consumer whose rows of
//     Q hold one runs the Q hi K lo pass a k-step at a time with those
//     entries 0 (the group learns it with one barrier reduction, and takes
//     the branch warp-uniformly: a divergent one serializes the wgmmas);
//   * shared memory: raw Q 64 KB + ring 2 x 32 KB + K's 3 x 16 KB + V^T's
//     3 x 16 KB = 224 KB of the 227 KB a block may take: the budget that
//     set 32-key tiles and Q hi in registers (Q's hi and lo tiles alone
//     would take 128 KB); one block of 384 threads an SM;
//   * the output leaves from the accumulators in 8-byte stores, lse once
//     by the lane that holds its row's full sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"   // descriptors, mbarriers, TMA, wgmma, the tensor-map encoders
#include "tf32.cuh"     // the 3xTF32 split and products, the float32 tiles

namespace {

constexpr int ROWS = 128;       // query rows per block: BQ positions x Gp heads
constexpr int BK = 64;          // keys a tile of the bfloat16 route (float32: TF_BK)
constexpr float MASK = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the shift of Gp, the power of two at or above g
int log2_of(int g) {
  int shift = 0;
  while ((1 << shift) < g) ++shift;
  return shift;
}

constexpr int WG_THREADS = 128;                    // a warpgroup

// ----------------------------------------------------------- float32 route --

constexpr int TF_D = 128;                          // head width
constexpr int TF_THREADS = 384;                    // a splitter + 2 consumer warpgroups
constexpr int TF_BK = 32;                          // keys a tile
constexpr int TF_STAGES = 2;                       // the raw K/V ring
constexpr int TF_PART = TF_BK * 512;               // 32 keys x 128 floats: 16 KB
// from a 1024-byte aligned base: the raw Q tile (128 rows; Q lo in place
// once the consumers have split it), the raw ring (each stage K then V),
// K's split tiles (hi, hi_c, lo), V^T's split tiles (hi, hi_c, lo), then
// the barriers
constexpr int TF_Q = 0;
constexpr int TF_RAW = ROWS * 512;
constexpr int TF_K = TF_RAW + TF_STAGES * 2 * TF_PART;
constexpr int TF_V = TF_K + 3 * TF_PART;
constexpr int TF_BAR = TF_V + 3 * TF_PART;
constexpr int TF_SMEM = TF_BAR + 8 * (5 + TF_STAGES) + 1024;   // + alignment slack

// The splitter's pass over one tile of V: raw V (32 keys x 128 dims, as TMA
// lands it) into V^T's hi, hi_c and lo tiles, 128 rows (dims) of 32 keys
// (128 bytes) with the 128-byte swizzle, K-major for the P V product. In a
// row, each 8 keys are stored as keys 0, 2, 4, 6, 1, 3, 5, 7: the order in
// which a lane's S accumulator holds P (columns 2t, 2t + 1 of each 8),
// taken as an A fragment (columns t, t + 4).
__device__ __forceinline__ void split_vt(const unsigned char* raw, unsigned char* vt, int pt) {
  for (int item = pt; item < 128 * 8; item += 128) {
    const int dim = item & 127, c = item >> 7;     // row dim, 16-byte chunk c
    const int key = 8 * (c >> 1) + (c & 1);        // keys key, key + 2, + 4, + 6
    const Split s0 = split(ld_f32(raw + sw_off(TF_BK, key, dim)));
    const Split s1 = split(ld_f32(raw + sw_off(TF_BK, key + 2, dim)));
    const Split s2 = split(ld_f32(raw + sw_off(TF_BK, key + 4, dim)));
    const Split s3 = split(ld_f32(raw + sw_off(TF_BK, key + 6, dim)));
    unsigned char* dst = vt + dim * 128 + ((c ^ (dim & 7)) << 4);
    *reinterpret_cast<uint4*>(dst) = make_uint4(s0.big, s1.big, s2.big, s3.big);
    *reinterpret_cast<uint4*>(dst + TF_PART) = make_uint4(s0.big_c, s1.big_c, s2.big_c, s3.big_c);
    *reinterpret_cast<uint4*>(dst + 2 * TF_PART) = make_uint4(s0.small, s1.small, s2.small,
                                                               s3.small);
  }
}

// The splitter's pass over one tile of K: raw K into K's hi, hi_c and lo
// tiles at the raw offsets (K-major as TMA lands it).
__device__ __forceinline__ void split_k(const unsigned char* raw, unsigned char* ks, int pt) {
  for (int o = pt * 16; o < TF_PART; o += 128 * 16) {
    const float4 x = *reinterpret_cast<const float4*>(raw + o);
    const Split s0 = split(x.x), s1 = split(x.y), s2 = split(x.z), s3 = split(x.w);
    *reinterpret_cast<uint4*>(ks + o) = make_uint4(s0.big, s1.big, s2.big, s3.big);
    *reinterpret_cast<uint4*>(ks + TF_PART + o) = make_uint4(s0.big_c, s1.big_c, s2.big_c,
                                                             s3.big_c);
    *reinterpret_cast<uint4*>(ks + 2 * TF_PART + o) = make_uint4(s0.small, s1.small, s2.small,
                                                                 s3.small);
  }
}

// One block per (q tile, KV head, batch row), 3 warpgroups. Warpgroup 0
// loads and splits: one thread issues the TMA loads (Q once, then raw K
// and V of each 32-key tile into a 2-stage ring), and the group splits
// each tile into K's and V^T's hi, hi_c and lo tiles. Warpgroups 1 and 2
// are the consumers of rows 0..63 and 64..127: each splits its rows of Q
// once (hi kept in registers as A fragments, lo written over the raw Q),
// then for each tile S = Q K^T in three wgmma m64n32k8 passes (Q lo K hi_c
// from shared memory; Q hi K lo, Q hi K hi with Q from registers), the
// softmax in registers, and O += P V in three wgmma m64n128k8 passes (P lo
// V hi_c, P hi V lo, P hi V hi, P from registers).
template <bool PAD>
__global__ void __launch_bounds__(TF_THREADS, 1)
flash_attention_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
                           float* __restrict__ lse, int S, int H, int g_shift, float scale) {
  extern __shared__ __align__(1024) unsigned char f32_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(f32_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // swizzle atoms are 1024-byte aligned
  unsigned char* smem = f32_raw + (base - raw);
  const uint32_t bar_q = base + TF_BAR;             // Q landed
  const uint32_t bar_kf = bar_q + 8;                // K's split tiles written
  const uint32_t bar_ke = bar_kf + 8;               // both consumers done with them
  const uint32_t bar_vf = bar_ke + 8;               // V^T's split tiles written
  const uint32_t bar_ve = bar_vf + 8;               // both consumers done with them
  const uint32_t bar_raw = bar_ve + 8;              // raw K and V of stage s landed

  // the warpgroup by a shuffle from lane 0, so the compiler sees the role
  // branches as warp-uniform
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / WG_THREADS, 0);
  // PAD: G = H / Hkv below Gp = 1 << g_shift, rows G .. Gp - 1 of a position idle
  const int G = PAD ? H / (int)gridDim.y : 1 << g_shift;
  const int BQ = ROWS >> g_shift;
  const int qt = gridDim.x - 1 - blockIdx.x;        // the longest rows first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int q_last = min(q0 + BQ, S) - 1;
  const int n_tiles = q_last / TF_BK + 1;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_kf, WG_THREADS);
    mbar_init(bar_ke, 2 * WG_THREADS);
    mbar_init(bar_vf, WG_THREADS);
    mbar_init(bar_ve, 2 * WG_THREADS);
    for (int s = 0; s < TF_STAGES; ++s) mbar_init(bar_raw + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int pt = tid;
    auto load_kv = [&](int t) {                     // keys past S arrive as zeros
      const int s = t % TF_STAGES;
      const uint32_t dst = base + TF_RAW + s * 2 * TF_PART, bar = bar_raw + 8 * s;
      mbar_expect_tx(bar, 2 * TF_PART);
      for (int a = 0; a < 4; ++a) {
        tma_load_4d(dst + a * TF_BK * 128, &tm_k, bar, 32 * a, kvh, t * TF_BK, b);
        tma_load_4d(dst + TF_PART + a * TF_BK * 128, &tm_v, bar, 32 * a, kvh, t * TF_BK, b);
      }
    };
    if (pt == 0) {
      // Q: a box of 32 values x Gp heads x BQ positions from the group's
      // first head is the 128 rows in order r = position * Gp + head, 128
      // bytes a row
      mbar_expect_tx(bar_q, ROWS * 512);
      for (int a = 0; a < 4; ++a)
        tma_load_4d(base + TF_Q + a * ROWS * 128, &tm_q, bar_q, 32 * a, kvh * G, q0, b);
      for (int t = 0; t < min(n_tiles, TF_STAGES); ++t) load_kv(t);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % TF_STAGES;
      const unsigned char* kv = smem + TF_RAW + s * 2 * TF_PART;
      mbar_wait(bar_raw + 8 * s, (uint32_t)((t / TF_STAGES) & 1));
      if (t > 0) mbar_wait(bar_ke, (uint32_t)((t - 1) & 1));
      split_k(kv, smem + TF_K, pt);
      fence_proxy_async();                          // the split tiles are for wgmma
      mbar_arrive(bar_kf);
      if (t > 0) mbar_wait(bar_ve, (uint32_t)((t - 1) & 1));
      split_vt(kv + TF_PART, smem + TF_V, pt);
      fence_proxy_async();                          // and the raw stage is read out
      mbar_arrive(bar_vf);
      named_sync(1, WG_THREADS);
      if (pt == 0 && t + TF_STAGES < n_tiles) load_kv(t + TF_STAGES);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");

  const int c = wg - 1;                             // rows 64 c .. 64 c + 63
  const int warp = (tid / 32) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 64 * c + 16 * warp + g;            // this lane's rows: r0, r0 + 8
  const int pos0 = q0 + (r0 >> g_shift), pos1 = q0 + ((r0 + 8) >> g_shift);
  const int wg_first = q0 + ((64 * c) >> g_shift);
  const int wg_last = q0 + ((64 * c + 63) >> g_shift);
  const uint32_t q_rows = base + TF_Q + c * 64 * 128;

  // Q's A fragments: hi (Split::big) in registers, lo written over the raw
  // value, which the Q lo pass reads by descriptor
  uint32_t qh[TF_D / 8][4];
  mbar_wait(bar_q, 0);
  int q_bad = 0;
#pragma unroll
  for (int kk = 0; kk < TF_D / 8; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      unsigned char* at = smem + TF_Q + sw_off(ROWS, r0 + 8 * (e & 1), 8 * kk + t4 + 4 * (e >> 1));
      const Split sp = split(*reinterpret_cast<const float*>(at));
      qh[kk][e] = sp.big;
      // an idle row (PAD) holds another group's head: not this group's flag
      q_bad |= (!PAD || ((r0 + 8 * (e & 1)) & ((1 << g_shift) - 1)) < G) &&
               sp.big != sp.big_c;
      *reinterpret_cast<uint32_t*>(at) = sp.small;
    }
  }
  fence_proxy_async();                              // Q lo is for wgmma
  // any inf or NaN in the warpgroup's Q rows (idle rows aside), taken from
  // lane 0 so the compiler sees the branch on it as warp-uniform (a
  // divergent one serializes the wgmmas)
  q_bad = __shfl_sync(0xffffffffu, (int)named_sync_or(2 + c, WG_THREADS, q_bad), 0);

  float acc[64], sc[16];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) sc[i] = 0.f;
  float m[2] = {MASK, MASK}, l[2] = {0.f, 0.f};     // l: this lane's columns only
  const uint32_t k_hi = base + TF_K, k_hic = k_hi + TF_PART, k_lo = k_hi + 2 * TF_PART;
  const uint32_t v_hi = base + TF_V, v_hic = v_hi + TF_PART, v_lo = v_hi + 2 * TF_PART;
  auto kdesc = [](uint32_t tile, int kk) {          // 32 keys, box kk / 4
    return gmma_desc(tile + (kk >> 2) * TF_BK * 128 + (kk & 3) * 32, 16, 1024);
  };

  for (int t = 0; t < n_tiles; ++t) {
    const int key0 = t * TF_BK;
    const bool own = key0 <= wg_last;               // some row of the group sees a key here
    mbar_wait(bar_kf, (uint32_t)(t & 1));
    if (own) {
      // S = Q lo K hi_c + Q hi_c K lo + Q hi K hi, the small terms first
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TF_D / 8; ++kk)
        wgmma_m64n32k8_tf32_ss(
            sc, gmma_desc(q_rows + (kk >> 2) * ROWS * 128 + (kk & 3) * 32, 16, 1024),
            kdesc(k_hic, kk), kk > 0);
      if (q_bad) {                                  // hi_c: 0 at Q's inf and NaN
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < TF_D / 8; ++kk) {
          wgmma_wait<0>();                          // a is free again
          fence_regs(sc);
          uint32_t a[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = finite_bits(qh[kk][e]) ? qh[kk][e] : 0u;
          wgmma_fence();
          wgmma_m64n32k8_tf32_rs(sc, a, kdesc(k_lo, kk));
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_regs(sc);
        wgmma_fence();
      } else {
#pragma unroll
        for (int kk = 0; kk < TF_D / 8; ++kk) wgmma_m64n32k8_tf32_rs(sc, qh[kk], kdesc(k_lo, kk));
      }
#pragma unroll
      for (int kk = 0; kk < TF_D / 8; ++kk) wgmma_m64n32k8_tf32_rs(sc, qh[kk], kdesc(k_hi, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
    }
    mbar_arrive(bar_ke);
    uint32_t ph[TF_BK / 8][4], pl[TF_BK / 8][4];    // P's A fragments, hi and lo
    if (own) {
      // scaled scores, masked past each row's position where the tile
      // crosses the group's diagonal; a row's max and sum stay in its quad
      const bool diag = key0 + TF_BK - 1 > wg_first;
      float mx0 = m[0], mx1 = m[1];
#pragma unroll
      for (int j = 0; j < TF_BK / 8; ++j) {
        const int key = key0 + 8 * j + 2 * t4;
        sc[4 * j] = !diag || key <= pos0 ? sc[4 * j] * scale : MASK;
        sc[4 * j + 1] = !diag || key + 1 <= pos0 ? sc[4 * j + 1] * scale : MASK;
        sc[4 * j + 2] = !diag || key <= pos1 ? sc[4 * j + 2] * scale : MASK;
        sc[4 * j + 3] = !diag || key + 1 <= pos1 ? sc[4 * j + 3] * scale : MASK;
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float corr0 = expf(m[0] - mx0), corr1 = expf(m[1] - mx1);
      m[0] = mx0;
      m[1] = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < TF_BK / 8; ++j) {
        const float p0 = expf(sc[4 * j] - mx0), p1 = expf(sc[4 * j + 1] - mx0);
        const float p2 = expf(sc[4 * j + 2] - mx1), p3 = expf(sc[4 * j + 3] - mx1);
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        // the A fragment: (row g, column t) = key 2t, (g + 8, t), (g, t + 4)
        // = key 2t + 1, (g + 8, t + 4)
        const Split s0 = split(p0), s1 = split(p2), s2 = split(p1), s3 = split(p3);
        ph[j][0] = s0.big; ph[j][1] = s1.big; ph[j][2] = s2.big; ph[j][3] = s3.big;
        pl[j][0] = s0.small; pl[j][1] = s1.small; pl[j][2] = s2.small; pl[j][3] = s3.small;
      }
      l[0] = l[0] * corr0 + sum0;
      l[1] = l[1] * corr1 + sum1;
#pragma unroll
      for (int n = 0; n < TF_D / 8; ++n) {
        acc[4 * n] *= corr0;
        acc[4 * n + 1] *= corr0;
        acc[4 * n + 2] *= corr1;
        acc[4 * n + 3] *= corr1;
      }
    }
    mbar_wait(bar_vf, (uint32_t)(t & 1));
    if (own) {
      // O += P lo V hi_c + P hi V lo + P hi V hi (P is finite, or NaN where
      // the row already is)
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < TF_BK / 8; ++i)
        wgmma_m64n128k8_tf32_rs(acc, pl[i], gmma_desc(v_hic + i * 32, 16, 1024));
#pragma unroll
      for (int i = 0; i < TF_BK / 8; ++i)
        wgmma_m64n128k8_tf32_rs(acc, ph[i], gmma_desc(v_lo + i * 32, 16, 1024));
#pragma unroll
      for (int i = 0; i < TF_BK / 8; ++i)
        wgmma_m64n128k8_tf32_rs(acc, ph[i], gmma_desc(v_hi + i * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    mbar_arrive(bar_ve);
  }

  const float l0 = fmaxf(quad_sum(l[0]), 1e-30f), l1 = fmaxf(quad_sum(l[1]), 1e-30f);
  const int gmask = PAD ? (1 << g_shift) - 1 : G - 1;   // a row's head is row & gmask
  const int head0 = r0 & gmask, head1 = (r0 + 8) & gmask;
  const bool live0 = !PAD || head0 < G, live1 = !PAD || head1 < G;   // else idle: never stored
  if (lse != nullptr && t4 == 0) {                  // m is in scaled units here
    const size_t lrow = ((size_t)b * H + (size_t)kvh * G) * S;
    if (live0 && pos0 < S) lse[lrow + (size_t)head0 * S + pos0] = m[0] + logf(l0);
    if (live1 && pos1 < S) lse[lrow + (size_t)head1 * S + pos1] = m[1] + logf(l1);
  }
  const size_t q_row = (size_t)H * TF_D;
  float* ob = o + (size_t)b * S * q_row + (size_t)kvh * G * TF_D + 2 * t4;
#pragma unroll
  for (int n = 0; n < TF_D / 8; ++n) {
    if (live0 && pos0 < S)
      *reinterpret_cast<float2*>(ob + (size_t)pos0 * q_row + head0 * TF_D + 8 * n) =
          make_float2(acc[4 * n] / l0, acc[4 * n + 1] / l0);
    if (live1 && pos1 < S)
      *reinterpret_cast<float2*>(ob + (size_t)pos1 * q_row + head1 * TF_D + 8 * n) =
          make_float2(acc[4 * n + 2] / l1, acc[4 * n + 3] / l1);
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int S, int H, int Hkv, float scale, cudaStream_t stream) {
  const cudaError_t ctx = make_context_current();
  if (ctx != cudaSuccess) return ctx;
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int G = H / Hkv, g_shift = log2_of(G);
  const int BQ = ROWS >> g_shift;
  CUtensorMap tq, tk, tv;
  if (!encode_map_f32(encode, &tq, q, B, S, H, 1 << g_shift, BQ) ||
      !encode_map_f32(encode, &tk, k, B, S, Hkv, 1, TF_BK) ||
      !encode_map_f32(encode, &tv, v, B, S, Hkv, 1, TF_BK))
    return cudaErrorInvalidValue;
  // a power-of-two G runs the kernel without the idle-row guards
  const auto kernel = G == 1 << g_shift ? flash_attention_f32_kernel<false>
                                         : flash_attention_f32_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         TF_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, Hkv, B);
  kernel<<<grid, TF_THREADS, TF_SMEM, stream>>>(tq, tk, tv, static_cast<float*>(o), lse, S,
                                                H, g_shift, scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------- bfloat16 route --

// two floats as a bf16 pair, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr int WS_THREADS = 3 * WG_THREADS;         // producer + 2 consumer warpgroups
constexpr int WS_STAGES = 2;                       // the K/V ring
constexpr int BOX_Q = ROWS * 128;                  // 64 dims of the 128 q rows: 16 KB
constexpr int BOX_KV = BK * 128;                   // 64 dims of 64 keys: 8 KB

// The shared memory of the bfloat16 route at head width D, in boxes of 64
// dims (128 bytes a row): from a 1024-byte aligned base Q (D / 64 boxes),
// then each stage's K (D / 64 boxes) and V (D / 64 boxes), then the
// barriers. d=128: 96 KB; d=64: 48 KB.
template <int D>
struct WsSmem {
  static_assert(D == 64 || D == 128, "the bfloat16 route takes head widths 64 and 128");
  static constexpr int BOXES = D / 64;
  static constexpr int Q = 0;
  static constexpr int KV = BOXES * BOX_Q;
  static constexpr int STAGE = 2 * BOXES * BOX_KV;
  static constexpr int BAR = KV + WS_STAGES * STAGE;
  static constexpr int BYTES = BAR + 8 * (1 + 3 * WS_STAGES) + 1024;   // + alignment slack
};

// S = Q K^T for one tile, issued and committed: D / 16 steps of 16 dims, 4
// in each 64-dim box, 32 bytes apart (Q and K K-major)
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t q_rows, uint32_t kv) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16_ss(sc, gmma_desc(q_rows + (kk >> 2) * BOX_Q + (kk & 3) * 32, 16, 1024),
                       gmma_desc(kv + (kk >> 2) * BOX_KV + (kk & 3) * 32, 16, 1024), kk > 0);
  wgmma_commit();
}

// O += P V for one tile, issued and committed: 4 steps of 16 keys, 2 KB of
// V rows apart, each an m64nDk16; V (after K's D / 64 boxes) is N-major,
// its 64-dim boxes BOX_KV apart, its 8-key groups 1 KB apart
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&pa)[BK / 16][4],
                                         uint32_t kv) {
  const uint32_t v = kv + (D / 64) * BOX_KV;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t desc = gmma_desc(v + kk * 16 * 128, BOX_KV, 1024);
    if constexpr (D == 128)
      wgmma_m64n128k16_rs(acc, pa[kk], desc);
    else
      wgmma_m64n64k16_rs(acc, pa[kk], desc);
  }
  wgmma_commit();
}

// the online softmax of a tile's scores, in place: keys past a row's
// position masked where the tile crosses the diagonal, then exp2 of
// s * scale * log2 e - m' (one FMA a score); updates the row max and sum
// and gives the factors that bring O's rows to the new max. key0 is the
// key of this lane's first column; the lane's rows are at pos0 and pos1.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int key0, bool diag, int pos0,
                                             int pos1, float scale_log2) {
  if (diag) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int key = key0 + 8 * j;
      if (key > pos0) sc[4 * j] = MASK;
      if (key + 1 > pos0) sc[4 * j + 1] = MASK;
      if (key > pos1) sc[4 * j + 2] = MASK;
      if (key + 1 > pos1) sc[4 * j + 3] = MASK;
    }
  }
  float mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  corr[0] = exp2f((m[0] - mx0) * scale_log2);
  corr[1] = exp2f((m[1] - mx1) * scale_log2);
  m[0] = mx0;
  m[1] = mx1;
  const float off0 = -mx0 * scale_log2, off1 = -mx1 * scale_log2;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    sc[4 * j] = exp2f(fmaf(sc[4 * j], scale_log2, off0));
    sc[4 * j + 1] = exp2f(fmaf(sc[4 * j + 1], scale_log2, off0));
    sc[4 * j + 2] = exp2f(fmaf(sc[4 * j + 2], scale_log2, off1));
    sc[4 * j + 3] = exp2f(fmaf(sc[4 * j + 3], scale_log2, off1));
    sum0 += sc[4 * j] + sc[4 * j + 1];
    sum1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l[0] = l[0] * corr[0] + sum0;
  l[1] = l[1] * corr[1] + sum1;
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&corr)[2]) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    acc[4 * n] *= corr[0];
    acc[4 * n + 1] *= corr[0];
    acc[4 * n + 2] *= corr[1];
    acc[4 * n + 3] *= corr[1];
  }
}

// P's A fragment for keys 16 kk .. 16 kk + 15 is the C fragments of score
// groups 2 kk and 2 kk + 1, packed to bf16 pairs
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4], const float (&sc)[32]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// One block per (q tile, KV head, batch row), 3 warpgroups, at head width
// D (64 or 128). Warpgroup 0 is the producer: one thread issues the TMA
// loads (Q once, then K and V of each tile into a 2-stage ring with
// full/empty barriers), D / 64 boxes of 64 dims each, and the group gives
// up registers. Warpgroups 1 and 2 are consumers of rows 0..63 and 64..127:
// S = Q K^T by D / 16 wgmma m64n64k16 (Q and K by descriptor), the softmax
// in registers, O += P V by 4 wgmma m64nDk16 with P from registers and V
// by descriptor (N-major). The accumulator layout of a warpgroup is
// m16n8's for each of its warps: warp w holds rows 16 w + g and 16 w + g +
// 8, columns 8 i + 2 t, 8 i + 2 t + 1 in d[4 i .. 4 i + 3].
template <int D, bool PAD>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_attention_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                  const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_v,
                                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                                  int S, int H, int g_shift, float scale, float scale_log2) {
  using L = WsSmem<D>;
  extern __shared__ __align__(1024) unsigned char ws_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(ws_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // swizzle atoms are 1024-byte aligned
  unsigned char* smem = ws_raw + (base - raw);
  const uint32_t bar_q = base + L::BAR;
  const uint32_t bar_k = bar_q + 8;                 // full: K of stage s landed
  const uint32_t bar_v = bar_k + 8 * WS_STAGES;     // full: V of stage s landed
  const uint32_t bar_e = bar_v + 8 * WS_STAGES;     // empty: both consumers done with s

  const int tid = threadIdx.x, wg = tid / WG_THREADS;
  // PAD: G = H / Hkv below Gp = 1 << g_shift, rows G .. Gp - 1 of a position idle
  const int G = PAD ? H / (int)gridDim.y : 1 << g_shift;
  const int BQ = ROWS >> g_shift;
  const int qt = gridDim.x - 1 - blockIdx.x;        // the longest rows first
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
      // Q: a box of 64 dims x Gp heads x BQ positions from the group's
      // first head is the 128 rows in order r = position * Gp + head, 128
      // bytes a row
      mbar_expect_tx(bar_q, L::BOXES * BOX_Q);
#pragma unroll
      for (int x = 0; x < L::BOXES; ++x)
        tma_load_4d(base + L::Q + x * BOX_Q, &tm_q, bar_q, 64 * x, kvh * G, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % WS_STAGES;
        if (t >= WS_STAGES) mbar_wait(bar_e + 8 * s, ((t / WS_STAGES) - 1) & 1);
        const uint32_t kv = base + L::KV + s * L::STAGE;
        mbar_expect_tx(bar_k + 8 * s, L::BOXES * BOX_KV);   // keys past S arrive as zeros
#pragma unroll
        for (int x = 0; x < L::BOXES; ++x)
          tma_load_4d(kv + x * BOX_KV, &tm_k, bar_k + 8 * s, 64 * x, kvh, t * BK, b);
        mbar_expect_tx(bar_v + 8 * s, L::BOXES * BOX_KV);
#pragma unroll
        for (int x = 0; x < L::BOXES; ++x)
          tma_load_4d(kv + (L::BOXES + x) * BOX_KV, &tm_v, bar_v + 8 * s, 64 * x, kvh, t * BK,
                      b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int c = wg - 1;                             // rows 64 c .. 64 c + 63
  const int warp = (tid / 32) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = 64 * c + 16 * warp + g;          // this lane's rows: row0, row0 + 8
  const int pos0 = q0 + (row0 >> g_shift), pos1 = q0 + ((row0 + 8) >> g_shift);
  const int wg_first = q0 + ((64 * c) >> g_shift);
  const int wg_last = q0 + ((64 * c + 63) >> g_shift);
  const uint32_t q_rows = base + L::Q + c * 64 * 128;

  float acc[D / 2], sc[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  float m[2] = {MASK, MASK}, l[2] = {0.f, 0.f}, corr[2];   // rows row0, row0 + 8
  uint32_t pa[BK / 16][4];
  // tiles holding a key at or before this group's last position; the rest
  // are masked for every row of the group
  const int n_own = min(n_tiles, (wg_last / BK) + 1);
  auto stage_at = [&](int t) { return base + L::KV + (t % WS_STAGES) * L::STAGE; };
  auto phase_of = [&](int t) { return (uint32_t)((t / WS_STAGES) & 1); };
  mbar_wait(bar_q, 0);

  for (int t = 0; t < n_own; ++t) {
    mbar_wait(bar_k + 8 * (t % WS_STAGES), phase_of(t));
    fence_regs(sc);
    issue_qk<D>(sc, q_rows, stage_at(t));
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile(sc, m, l, corr, t * BK + 2 * t4, t * BK + BK - 1 > wg_first, pos0, pos1,
                 scale_log2);
    rescale(acc, corr);
    pack_p(pa, sc);
    mbar_wait(bar_v + 8 * (t % WS_STAGES), phase_of(t));
    fence_regs(acc);
    issue_pv<D>(acc, pa, stage_at(t));
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(bar_e + 8 * (t % WS_STAGES));
  }
  for (int t = n_own; t < n_tiles; ++t) {           // masked for this group: release only
    mbar_wait(bar_k + 8 * (t % WS_STAGES), phase_of(t));
    mbar_wait(bar_v + 8 * (t % WS_STAGES), phase_of(t));
    mbar_arrive(bar_e + 8 * (t % WS_STAGES));
  }

  // out: acc / l in bf16, through this warp's own 16 rows of the Q tile
  // (each 64-dim box, in the same swizzled layout), then 16-byte stores
  const float l0 = fmaxf(quad_sum(l[0]), 1e-30f), l1 = fmaxf(quad_sum(l[1]), 1e-30f);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int gmask = PAD ? (1 << g_shift) - 1 : G - 1;   // a row's head is row & gmask
  if (lse != nullptr && t4 == 0) {   // m is in raw score units here: the natural lse
    const size_t lrow = ((size_t)b * H + (size_t)kvh * G) * S;   // is scale * m + log(l)
    const int head0 = row0 & gmask, head1 = (row0 + 8) & gmask;
    if ((!PAD || head0 < G) && pos0 < S)
      lse[lrow + (size_t)head0 * S + pos0] = fmaf(scale, m[0], logf(l0));
    if ((!PAD || head1 < G) && pos1 < S)
      lse[lrow + (size_t)head1 * S + pos1] = fmaf(scale, m[1], logf(l1));
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int box = (n >> 3) * BOX_Q, ch = n & 7;
    *reinterpret_cast<uint32_t*>(smem + box + row0 * 128 + ((ch ^ (row0 & 7)) << 4) + 4 * t4) =
        pack_bf16(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
    *reinterpret_cast<uint32_t*>(smem + box + (row0 + 8) * 128 + ((ch ^ (row0 & 7)) << 4) +
                                 4 * t4) = pack_bf16(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
  }
  __syncwarp();
  // a row's D / 8 chunks of 16 bytes, the warp's 16 rows, 32 lanes at a time
  constexpr int CHUNKS = D / 8;
  const size_t q_row = (size_t)H * D;
  __nv_bfloat16* ob = o + (size_t)b * S * q_row + (size_t)kvh * G * D;
#pragma unroll
  for (int i = 0; i < 16 * CHUNKS / 32; ++i) {
    const int cidx = i * 32 + lane;
    const int r = 64 * c + 16 * warp + cidx / CHUNKS, ch = cidx % CHUNKS;
    const int pos = q0 + (r >> g_shift), head = r & gmask;
    if ((!PAD || head < G) && pos < S)               // idle rows are never stored
      *reinterpret_cast<uint4*>(ob + (size_t)pos * q_row + head * D + ch * 8) =
          *reinterpret_cast<const uint4*>(smem + (ch >> 3) * BOX_Q + r * 128 +
                                          (((ch & 7) ^ (r & 7)) << 4));
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int S, int H, int Hkv, float scale, cudaStream_t stream) {
  const cudaError_t ctx = make_context_current();
  if (ctx != cudaSuccess) return ctx;
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int G = H / Hkv, g_shift = log2_of(G);
  const int BQ = ROWS >> g_shift;
  CUtensorMap tq, tk, tv;
  if (!encode_map(encode, &tq, q, B, S, H, D, 1 << g_shift, BQ) ||
      !encode_map(encode, &tk, k, B, S, Hkv, D, 1, BK) ||
      !encode_map(encode, &tv, v, B, S, Hkv, D, 1, BK))
    return cudaErrorInvalidValue;
  // a power-of-two G runs the kernel without the idle-row guards
  const auto kernel = G == 1 << g_shift ? flash_attention_bf16_wgmma_kernel<D, false>
                                         : flash_attention_bf16_wgmma_kernel<D, true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         WsSmem<D>::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, Hkv, B);
  kernel<<<grid, WS_THREADS, WsSmem<D>::BYTES, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, S, H, g_shift, scale, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// dtype 0: float32 (3xTF32 wgmma) at d = 128; 1: bfloat16 (wgmma) at d = 64
// or 128; both on the tensor cores; any G = H / Hkv up to 128. lse is null,
// or (B, H, S) float32 for each row's log-sum-exp. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, without
// launching, for a shape it does not take).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, float* lse, int B, int S, int H, int Hkv, int d,
                                   float scale, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || H / Hkv > ROWS || B > 65535 ||
      Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == TF_D) return (int)launch(q, k, v, o, lse, B, S, H, Hkv, scale, st);
  if (dtype == 1 && d == 128)
    return (int)launch_bf16<128>(q, k, v, o, lse, B, S, H, Hkv, scale, st);
  if (dtype == 1 && d == 64)
    return (int)launch_bf16<64>(q, k, v, o, lse, B, S, H, Hkv, scale, st);
  return (int)cudaErrorInvalidValue;
}

// What the route of a dtype and head width d is and what it holds on the
// card, for the logs: info[0] the design stage (2: wgmma + TMA, 4: 3xTF32
// wgmma + TMA), [1] registers and [2] local (spill) bytes a thread, [3]
// static and [4] dynamic shared memory bytes a block, [5] blocks resident
// on an SM, [6] threads a block: of the instance a power-of-two G runs (a
// padded G's adds only the idle-row guards). Returns a cudaError_t
// (cudaErrorInvalidValue for a dtype and width with no kernel).
extern "C" int flash_attention_route_info(int dtype, int d, int* info) {
  const void* fn;
  int threads, smem, stage;
  if (dtype == 0 && d == TF_D) {
    fn = (const void*)flash_attention_f32_kernel<false>;
    threads = TF_THREADS;
    smem = TF_SMEM;
    stage = 4;
  } else if (dtype == 1 && d == 128) {
    fn = (const void*)flash_attention_bf16_wgmma_kernel<128, false>;
    threads = WS_THREADS;
    smem = WsSmem<128>::BYTES;
    stage = 2;
  } else if (dtype == 1 && d == 64) {
    fn = (const void*)flash_attention_bf16_wgmma_kernel<64, false>;
    threads = WS_THREADS;
    smem = WsSmem<64>::BYTES;
    stage = 2;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = stage;
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  info[3] = (int)attr.sharedSizeBytes;
  info[4] = smem;
  info[5] = blocks;
  info[6] = threads;
  return 0;
}
