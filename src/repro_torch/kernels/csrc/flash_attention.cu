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
// operations, 0.139 ms at 989 TFLOP/s in bfloat16 (2.052 ms at 67 TFLOP/s
// in float32) against 0.060 ms for the bytes (bfloat16): bound by
// operations, and by more the longer the sequence. Products on masked pairs
// of the diagonal tiles are overhead above that bound.
//
// Both routes share the block shape. One block per (q tile, KV head, batch
// row); a block's 128 rows are BQ = 128 / G query positions x the G query
// heads of its KV head (row r = position r / G, head r % G), so a K/V tile
// read from device memory serves all G heads. G must divide 128, so every
// row of a block holds a query head; being a divisor of 128 it is a power of
// two. Blocks take q tiles from the last one down, so the longest causal
// rows start first. The kv loop stops at the tile that holds the block's
// last query position. Masked scores are -1e30, never -inf, and the output
// is acc / max(l, 1e-30), written once in the input's type. Rows past S are
// staged as zeros and never stored, so any S >= 1 works (no S % block
// condition). Where the caller passes an lse buffer (training: the backward
// in flash_attention_bwd.cu recomputes each tile's probabilities from it),
// each row's natural log-sum-exp of its scaled scores, m + log(max(l,
// 1e-30)) with m in scaled units, is written to lse (B, H, S) float32, once,
// by the lane that holds the row's full sum; with lse null (serving) nothing
// more is written. Both run on the caller's stream, allocate nothing, and are
// compiled for d = 128 only (qwen3-0.6b's head width); the wrapper refuses
// other widths.
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
//   * S = Q K^T by 8 wgmma m64n64k16 a tile, Q and K read by shared-memory
//     descriptors; O += P V by 4 wgmma m64n128k16 with P from registers and
//     V by descriptor (N-major, transposed by the instruction). Both are
//     bfloat16 products with float32 sums, exactly the reference's
//     arithmetic (ref.flash_attention_ref: float32 scores, P cast to v's
//     type, float32 sums);
//   * P stays in registers: the float32 accumulator of S, scaled and
//     exponentiated, packed to bfloat16 pairs, is the A operand of the P V
//     product (the accumulator and A fragments share m16n8's layout);
//   * the TMA boxes are 64 dims (128 bytes) wide, loaded with the 128-byte
//     swizzle that the descriptors name, so wgmma reads without bank
//     conflicts; a Q box is 64 dims x G heads x 128 / G positions, the
//     block's rows in order. Keys and rows past S arrive as zeros (TMA's
//     out-of-bounds fill); the causal mask hides such keys from every
//     stored row;
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
// Shared memory: Q 32 KB + 2 stages x (K 16 KB + V 16 KB) = 96 KB; one
// block of 384 threads an SM.
//
// float32 route: the CUDA-core kernel below (first written for the slice
// that brought up qwen3-0.6b), kept because float32 is held to 2e-5 (max
// abs and error norm), which the tensor cores' TF32 (about three decimal
// digits) cannot meet. It serves the float32 checks, not the bf16 serving
// path:
//   * the q tile and one K/V tile of 64 positions are staged in shared
//     memory as float32 (q and K rows padded to 132 floats so the float4
//     reads of 16 different K rows by a half-warp fall in distinct banks);
//   * 256 threads as 16 x 16: a thread holds 8 rows (ty + 16 i) x 4 score
//     columns (tx + 16 j) of a tile in registers, then 8 rows x 8 output
//     columns of acc. Each 4-deep step of Q K^T reads 12 float4 from shared
//     memory for 128 FMAs; each 4-deep step of P V reads 16 float4 for 256.
//     The row max and sum reduce over the 16 lanes of a half-warp with
//     shuffles; the scores go through shared memory to the P V product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"   // descriptors, mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

constexpr int D = 128;          // head width
constexpr int ROWS = 128;       // query rows per block: BQ positions x G heads
constexpr int BK = 64;          // kv positions per tile
constexpr float MASK = -1e30f;

// ----------------------------------------------------------- float32 route --

constexpr int THREADS = 256;    // 16 x 16
constexpr int QS = D + 4;       // row stride (floats) of the staged q and K tiles
constexpr int PS = BK + 16;     // row stride of the P tile: odd rows 16 banks over
constexpr int RM = ROWS / 16;   // rows per thread
constexpr int CN = BK / 16;     // score columns per thread
constexpr int DN = D / 16;      // output columns per thread
constexpr size_t SMEM_BYTES =
    sizeof(float) * ((size_t)ROWS * QS + (size_t)BK * QS + (size_t)BK * D + (size_t)ROWS * PS);

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int S, int H, int Hkv, int G, int BQ,
                       float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // (ROWS, QS)
  float* ks = qs + ROWS * QS;                   // (BK, QS)
  float* vs = ks + BK * QS;                     // (BK, D)
  float* ps = vs + BK * D;                      // (ROWS, PS)

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;    // the longest rows first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const size_t q_row = (size_t)H * D;           // element strides of a position
  const size_t kv_row = (size_t)Hkv * D;
  const float* qb = q + (size_t)b * S * q_row + (size_t)kvh * G * D;
  float* ob = o + (size_t)b * S * q_row + (size_t)kvh * G * D;
  const float* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
  const float* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;

  // stage the q tile: row r is position q0 + r / G, head kvh * G + r % G;
  // the G heads of a position are adjacent in memory, so a tile row of
  // consecutive r is one contiguous run per position
#pragma unroll 4
  for (int c = tid; c < ROWS * D / 4; c += THREADS) {
    const int r = c / (D / 4), col = (c % (D / 4)) * 4;
    const int pos = q0 + r / G;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < S) x = load4(qb + (size_t)pos * q_row + (r % G) * D + col);
    *reinterpret_cast<float4*>(qs + r * QS + col) = x;
  }

  int qpos[RM];
  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    qpos[i] = q0 + (ty + 16 * i) / G;
    m[i] = MASK;
    l[i] = 0.f;                                 // this thread's columns only
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;       // the block's last position
  const int n_tiles = q_last / BK + 1;          // causal: later tiles are masked
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();                            // the last tile is read out
#pragma unroll 4
    for (int c = tid; c < BK * D / 4; c += THREADS) {
      const int r = c / (D / 4), col = (c % (D / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < S) {
        const size_t off = (size_t)(k0 + r) * kv_row + col;
        kx = load4(kb + off);
        vx = load4(vb + off);
      }
      *reinterpret_cast<float4*>(ks + r * QS + col) = kx;
      *reinterpret_cast<float4*>(vs + r * D + col) = vx;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 4) {
      float4 kf[CN];
#pragma unroll
      for (int j = 0; j < CN; ++j)
        kf[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * QS + kk);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 qf = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * QS + kk);
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = dot4(qf, kf[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = MASK;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = (k0 + tx + 16 * j <= qpos[i]) ? s[i][j] * scale : MASK;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pf[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        pf[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float4 v0 = *reinterpret_cast<const float4*>(vs + (c + cc) * D + tx * 4);
        const float4 v1 = *reinterpret_cast<const float4*>(vs + (c + cc) * D + 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float p = cc == 0 ? pf[i].x : cc == 1 ? pf[i].y : cc == 2 ? pf[i].z : pf[i].w;
          acc[i][0] = fmaf(p, v0.x, acc[i][0]);
          acc[i][1] = fmaf(p, v0.y, acc[i][1]);
          acc[i][2] = fmaf(p, v0.z, acc[i][2]);
          acc[i][3] = fmaf(p, v0.w, acc[i][3]);
          acc[i][4] = fmaf(p, v1.x, acc[i][4]);
          acc[i][5] = fmaf(p, v1.y, acc[i][5]);
          acc[i][6] = fmaf(p, v1.z, acc[i][6]);
          acc[i][7] = fmaf(p, v1.w, acc[i][7]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const float denom = fmaxf(half_warp_sum(l[i]), 1e-30f);
    const int r = ty + 16 * i;
    if (qpos[i] < S) {
      if (lse != nullptr && tx == 0)            // m is in scaled units here
        lse[((size_t)b * H + kvh * G + r % G) * S + qpos[i]] = m[i] + logf(denom);
      float* dst = ob + (size_t)qpos[i] * q_row + (r % G) * D;
      store4(dst + tx * 4, make_float4(acc[i][0] / denom, acc[i][1] / denom,
                                       acc[i][2] / denom, acc[i][3] / denom));
      store4(dst + 64 + tx * 4, make_float4(acc[i][4] / denom, acc[i][5] / denom,
                                            acc[i][6] / denom, acc[i][7] / denom));
    }
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int S, int H, int Hkv, float scale, cudaStream_t stream) {
  const int G = H / Hkv;
  const int BQ = ROWS / G;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, Hkv, B);
  flash_attention_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H, Hkv, G, BQ, scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------- bfloat16 route --

constexpr float LOG2E = 1.4426950408889634f;

// two floats as a bf16 pair, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

int log2_of(int g) {
  int shift = 0;
  while ((1 << shift) < g) ++shift;
  return shift;
}

constexpr int WG_THREADS = 128;                    // a warpgroup
constexpr int WS_THREADS = 3 * WG_THREADS;         // producer + 2 consumer warpgroups
constexpr int WS_STAGES = 2;                       // the K/V ring
constexpr int HALF_Q = ROWS * 128;                 // 64 dims of the 128 q rows: 16 KB
constexpr int HALF_KV = BK * 128;                  // 64 dims of 64 keys: 8 KB
// from a 1024-byte aligned base: Q (dims 0..63, then 64..127), then each
// stage's K (two halves) and V (two halves), then the barriers
constexpr int WS_Q = 0;
constexpr int WS_KV = 2 * HALF_Q;
constexpr int WS_STAGE_BYTES = 4 * HALF_KV;
constexpr int WS_BAR = WS_KV + WS_STAGES * WS_STAGE_BYTES;
constexpr int WS_SMEM_BYTES = WS_BAR + 8 * (1 + 3 * WS_STAGES) + 1024;   // + alignment slack

// S = Q K^T for one tile, issued and committed: 8 steps of 16 dims, 4 in
// each 64-dim half, 32 bytes apart (Q and K K-major)
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t q_rows, uint32_t kv) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16_ss(sc, gmma_desc(q_rows + (kk >> 2) * HALF_Q + (kk & 3) * 32, 16, 1024),
                       gmma_desc(kv + (kk >> 2) * HALF_KV + (kk & 3) * 32, 16, 1024), kk > 0);
  wgmma_commit();
}

// O += P V for one tile, issued and committed: 4 steps of 16 keys, 2 KB of
// V rows apart; V is N-major, its two 64-dim halves HALF_KV apart, its
// 8-key groups 1 KB apart
__device__ __forceinline__ void issue_pv(float (&acc)[64], const uint32_t (&pa)[BK / 16][4],
                                         uint32_t kv) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_m64n128k16_rs(acc, pa[kk], gmma_desc(kv + 2 * HALF_KV + kk * 16 * 128, HALF_KV, 1024));
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

__device__ __forceinline__ void rescale(float (&acc)[64], const float (&corr)[2]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
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

// One block per (q tile, KV head, batch row), 3 warpgroups. Warpgroup 0 is
// the producer: one thread issues the TMA loads (Q once, then K and V of
// each tile into a 2-stage ring with full/empty barriers) and the group
// gives up registers. Warpgroups 1 and 2 are consumers of rows 0..63 and
// 64..127: S = Q K^T by 8 wgmma m64n64k16 (Q and K by descriptor), the
// softmax in registers, O += P V by 4 wgmma m64n128k16 with P from
// registers and V by descriptor (N-major). The accumulator layout of a
// warpgroup is m16n8's for each of its warps: warp w holds rows 16 w + g
// and 16 w + g + 8, columns 8 i + 2 t, 8 i + 2 t + 1 in d[4 i .. 4 i + 3].
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_attention_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                  const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_v,
                                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                                  int S, int H, int g_shift, float scale, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char ws_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(ws_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // swizzle atoms are 1024-byte aligned
  unsigned char* smem = ws_raw + (base - raw);
  const uint32_t bar_q = base + WS_BAR;
  const uint32_t bar_k = bar_q + 8;                 // full: K of stage s landed
  const uint32_t bar_v = bar_k + 8 * WS_STAGES;     // full: V of stage s landed
  const uint32_t bar_e = bar_v + 8 * WS_STAGES;     // empty: both consumers done with s

  const int tid = threadIdx.x, wg = tid / WG_THREADS;
  const int G = 1 << g_shift;
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
      // Q: a box of 64 dims x G heads x BQ positions is the 128 rows in
      // order r = position * G + head, 128 bytes a row
      mbar_expect_tx(bar_q, 2 * HALF_Q);
      tma_load_4d(base + WS_Q, &tm_q, bar_q, 0, kvh * G, q0, b);
      tma_load_4d(base + WS_Q + HALF_Q, &tm_q, bar_q, 64, kvh * G, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % WS_STAGES;
        if (t >= WS_STAGES) mbar_wait(bar_e + 8 * s, ((t / WS_STAGES) - 1) & 1);
        const uint32_t kv = base + WS_KV + s * WS_STAGE_BYTES;
        mbar_expect_tx(bar_k + 8 * s, 2 * HALF_KV);   // keys past S arrive as zeros
        tma_load_4d(kv, &tm_k, bar_k + 8 * s, 0, kvh, t * BK, b);
        tma_load_4d(kv + HALF_KV, &tm_k, bar_k + 8 * s, 64, kvh, t * BK, b);
        mbar_expect_tx(bar_v + 8 * s, 2 * HALF_KV);
        tma_load_4d(kv + 2 * HALF_KV, &tm_v, bar_v + 8 * s, 0, kvh, t * BK, b);
        tma_load_4d(kv + 3 * HALF_KV, &tm_v, bar_v + 8 * s, 64, kvh, t * BK, b);
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
  const uint32_t q_rows = base + WS_Q + c * 64 * 128;

  float acc[64], sc[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  float m[2] = {MASK, MASK}, l[2] = {0.f, 0.f}, corr[2];   // rows row0, row0 + 8
  uint32_t pa[BK / 16][4];
  // tiles holding a key at or before this group's last position; the rest
  // are masked for every row of the group
  const int n_own = min(n_tiles, (wg_last / BK) + 1);
  auto stage_at = [&](int t) { return base + WS_KV + (t % WS_STAGES) * WS_STAGE_BYTES; };
  auto phase_of = [&](int t) { return (uint32_t)((t / WS_STAGES) & 1); };
  mbar_wait(bar_q, 0);

  for (int t = 0; t < n_own; ++t) {
    mbar_wait(bar_k + 8 * (t % WS_STAGES), phase_of(t));
    fence_regs(sc);
    issue_qk(sc, q_rows, stage_at(t));
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile(sc, m, l, corr, t * BK + 2 * t4, t * BK + BK - 1 > wg_first, pos0, pos1,
                 scale_log2);
    rescale(acc, corr);
    pack_p(pa, sc);
    mbar_wait(bar_v + 8 * (t % WS_STAGES), phase_of(t));
    fence_regs(acc);
    issue_pv(acc, pa, stage_at(t));
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
  // (both 64-dim halves, in the same swizzled layout), then 16-byte stores
  const float l0 = fmaxf(quad_sum(l[0]), 1e-30f), l1 = fmaxf(quad_sum(l[1]), 1e-30f);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  if (lse != nullptr && t4 == 0) {   // m is in raw score units here: the natural lse
    const size_t lrow = ((size_t)b * H + (size_t)kvh * G) * S;   // is scale * m + log(l)
    if (pos0 < S) lse[lrow + (size_t)(row0 & (G - 1)) * S + pos0] = fmaf(scale, m[0], logf(l0));
    if (pos1 < S) lse[lrow + (size_t)((row0 + 8) & (G - 1)) * S + pos1] = fmaf(scale, m[1], logf(l1));
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int half = (n >> 3) * HALF_Q, ch = n & 7;
    *reinterpret_cast<uint32_t*>(smem + half + row0 * 128 + ((ch ^ (row0 & 7)) << 4) + 4 * t4) =
        pack_bf16(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
    *reinterpret_cast<uint32_t*>(smem + half + (row0 + 8) * 128 + ((ch ^ (row0 & 7)) << 4) +
                                 4 * t4) = pack_bf16(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
  }
  __syncwarp();
  const size_t q_row = (size_t)H * D;
  __nv_bfloat16* ob = o + (size_t)b * S * q_row + (size_t)kvh * G * D;
#pragma unroll
  for (int i = 0; i < 16 * 16 / 32; ++i) {
    const int cidx = i * 32 + lane;
    const int r = 64 * c + 16 * warp + cidx / 16, ch = cidx % 16;
    const int pos = q0 + (r >> g_shift);
    if (pos < S)
      *reinterpret_cast<uint4*>(ob + (size_t)pos * q_row + (r & (G - 1)) * D + ch * 8) =
          *reinterpret_cast<const uint4*>(smem + (ch >> 3) * HALF_Q + r * 128 +
                                          (((ch & 7) ^ (r & 7)) << 4));
  }
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int S, int H, int Hkv, float scale, cudaStream_t stream) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int G = H / Hkv, g_shift = log2_of(G);
  const int BQ = ROWS >> g_shift;
  CUtensorMap tq, tk, tv;
  if (!encode_map(encode, &tq, q, B, S, H, G, BQ) ||
      !encode_map(encode, &tk, k, B, S, Hkv, 1, BK) ||
      !encode_map(encode, &tv, v, B, S, Hkv, 1, BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bf16_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         WS_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, Hkv, B);
  flash_attention_bf16_wgmma_kernel<<<grid, WS_THREADS, WS_SMEM_BYTES, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, S, H, g_shift, scale, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// dtype 0: float32 (CUDA cores), 1: bfloat16 (tensor cores). lse is null,
// or (B, H, S) float32 for each row's log-sum-exp. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, without
// launching, for a shape it does not take).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, float* lse, int B, int S, int H, int Hkv, int d,
                                   float scale, void* stream) {
  if (d != D || B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || ROWS % (H / Hkv) != 0 ||
      B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch(q, k, v, o, lse, B, S, H, Hkv, scale, st);
  if (dtype == 1) return (int)launch_bf16(q, k, v, o, lse, B, S, H, Hkv, scale, st);
  return (int)cudaErrorInvalidValue;
}

// What a dtype's route is and what it holds on the card, for the logs:
// info[0] the design stage (0: CUDA-core products, 2: wgmma + TMA), [1]
// registers and [2] local (spill) bytes a thread, [3] static and [4]
// dynamic shared memory bytes a block, [5] blocks resident on an SM, [6]
// threads a block. Returns a cudaError_t.
extern "C" int flash_attention_route_info(int dtype, int* info) {
  const void* fn;
  int threads, smem, stage;
  if (dtype == 0) {
    fn = (const void*)flash_attention_kernel;
    threads = THREADS;
    smem = (int)SMEM_BYTES;
    stage = 0;
  } else if (dtype == 1) {
    fn = (const void*)flash_attention_bf16_wgmma_kernel;
    threads = WS_THREADS;
    smem = WS_SMEM_BYTES;
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
