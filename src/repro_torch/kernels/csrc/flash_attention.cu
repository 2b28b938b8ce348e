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
// Design (simple and right first; wgmma, TMA and a warp-specialised
// pipeline are later work). The products run on the float32 CUDA cores, so
// bfloat16 runs at the float32 rate, far from its tensor-core bound:
//   * one block per (q tile, KV head, batch row). A block's 128 rows are
//     BQ = 128 / G query positions x the G query heads of its KV head
//     (row r = position r / G, head r % G), so a K/V tile read from device
//     memory serves all G heads. Blocks take q tiles from the last one
//     down, so the longest causal rows start first;
//   * G must divide 128, so every row of a block holds a query head;
//   * the q tile and one K/V tile of 64 positions are staged in shared
//     memory as float32 (q and K rows padded to 132 floats so the float4
//     reads of 16 different K rows by a half-warp fall in distinct banks);
//     rows past S are staged as zeros and never stored, so any S >= 1
//     works (no S % block condition) and the loads need no other bounds
//     check;
//   * the kv loop stops at the tile that holds the block's last query
//     position: tiles past the causal bound are skipped. Masked entries are
//     -1e30, never -inf, so exp(-1e30 - m) is 0 where a tile masks a whole
//     row;
//   * 256 threads as 16 x 16: a thread holds 8 rows (ty + 16 i) x 4 score
//     columns (tx + 16 j) of a tile in registers, then 8 rows x 8 output
//     columns of acc. Each 4-deep step of Q K^T reads 12 float4 from shared
//     memory for 128 FMAs; each 4-deep step of P V reads 16 float4 for 256.
//     The row max and sum reduce over the 16 lanes of a half-warp with
//     shuffles; the scores go through shared memory to the P V product;
//   * the output is acc / max(l, 1e-30), written once in the input's type.
// It runs on the caller's stream, allocates nothing, and is compiled for
// d = 128 only (qwen3-0.6b's head width); the wrapper refuses other widths.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int D = 128;          // head width
constexpr int ROWS = 128;       // query rows per block: BQ positions x G heads
constexpr int BK = 64;          // kv positions per tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int QS = D + 4;       // row stride (floats) of the staged q and K tiles
constexpr int PS = BK + 16;     // row stride of the P tile: odd rows 16 banks over
constexpr int RM = ROWS / 16;   // rows per thread
constexpr int CN = BK / 16;     // score columns per thread
constexpr int DN = D / 16;      // output columns per thread
constexpr float MASK = -1e30f;
constexpr size_t SMEM_BYTES =
    sizeof(float) * ((size_t)ROWS * QS + (size_t)BK * QS + (size_t)BK * D + (size_t)ROWS * PS);

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  *reinterpret_cast<uint32_t*>(&lo) = u.x;
  *reinterpret_cast<uint32_t*>(&hi) = u.y;
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
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

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int S, int H, int Hkv, int G, int BQ, float scale) {
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
  const T* qb = q + (size_t)b * S * q_row + (size_t)kvh * G * D;
  T* ob = o + (size_t)b * S * q_row + (size_t)kvh * G * D;
  const T* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
  const T* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;

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
      T* dst = ob + (size_t)qpos[i] * q_row + (r % G) * D;
      store4(dst + tx * 4, make_float4(acc[i][0] / denom, acc[i][1] / denom,
                                       acc[i][2] / denom, acc[i][3] / denom));
      store4(dst + 64 + tx * 4, make_float4(acc[i][4] / denom, acc[i][5] / denom,
                                            acc[i][6] / denom, acc[i][7] / denom));
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int H, int Hkv, float scale, cudaStream_t stream) {
  const int G = H / Hkv;
  const int BQ = ROWS / G;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, Hkv, B);
  flash_attention_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, Hkv, G, BQ, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: bfloat16. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue, without launching, for a shape it does not take).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int H, int Hkv, int d,
                                   float scale, void* stream) {
  if (d != D || B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || ROWS % (H / Hkv) != 0 ||
      B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(q, k, v, o, B, S, H, Hkv, scale, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, scale, st);
  return (int)cudaErrorInvalidValue;
}
