// conv_tanh_maxpool for Hopper (sm_90a): the SM-CNN's wide conv1d + bias +
// tanh + global max-pool over all S+w-1 windows, fused, one launch per arm.
//
//   x (B, S, d), filters (w*d, F) in the im2col layout, bias (F,) -> (B, F)
//   float32 or bfloat16 in and out; products summed in float32.
//
// Replaces the TPU kernel src/repro/kernels/sm_cnn_conv.py:46
// (conv_tanh_maxpool; body _kernel at :27), which staged a block of 8
// samples in VMEM and ran w shifted (S+w-1, d) x (d, F) MXU products.
//
// Bound on an H100 SXM at the main path's B=256 call (S=64, d=50, w=5,
// F=100): each of the S real rows meets each of the w taps once, so
//   operations 2 * 256 * 64 * 5 * 50 * 100 = 0.819 GFLOP
//     float32 on the CUDA cores at 67 TFLOP/s           -> 12.2 us
//     float32-accurate 3xTF32: 3 passes at 495 TFLOP/s  ->  4.96 us
//     bfloat16 at 989 TFLOP/s (tensor cores)            ->  0.83 us
//   bytes (x, filters, bias in; (B, F) out) 3.48 MB float32 at 3.35 TB/s
//     -> 1.0 us
// so the kernel is bound by operations. The batched plan's B=4096 calls
// scale both by 16.
//
// float32: the tensor-core kernel (conv_tanh_maxpool_tf32x3_kernel).
//   * 3xTF32. One TF32 product keeps ~2^-11 of relative error, ~1e-4 at the
//     output over w*d = 250 terms, against a 1e-5 gate. So each operand is
//     split v = hi + lo, both rounded to TF32 as cvt.rna.tf32.f32 rounds
//     (done with two integer operations), and three mma.sync.m16n8k8 TF32
//     passes, lo*hi + hi*lo + hi*hi (the small terms first), sum into
//     float32 accumulators. The dropped lo*lo is ~2^-22 relative.
//   * Non-finite inputs follow float32, not the split: for v = inf,
//     lo = inf - inf = NaN, and inf * lo is NaN where the other operand's lo
//     is 0. So hi keeps inf and NaN for the hi*hi pass, while the two cross
//     passes take operands whose non-finite entries are 0 (hi and lo both).
//   * The GEMM view, per sample, transposed: out^T = filters^T x windows.
//     M = filters (m16 tiles: 112 at F=100), N = windows (S+w-1, n8 tiles:
//     72 at S=64), K = taps x embedding columns (d padded to 8). The B
//     operand of tap j is the sample shifted by j rows, B_j(k, t) =
//     xs[t + j][k], so no im2col exists anywhere. (Windows as M, in m16
//     tiles, pad 68 to 80 and measured slower.)
//   * Shared memory: the filter bank as it is in global memory, (w*d, F),
//     then zeros up to the last float a fragment reads (at F=100 a warp's
//     4 A-fragment loads a k step meet 2-way bank conflicts, beside its 9
//     conflict-free 16-byte B loads);
//     the raw sample, (S, d) as in x; the split tile, where a lane's
//     (hi, lo) for columns t and t+4 are one 16-byte load (row stride = 16
//     mod 32: conflict-free); a scratch for the K split's sums. 157,360 B
//     of dynamic shared memory at sm-cnn's shape: one block an SM. Each
//     row of S costs 648 B (raw 200, split 448) at d=50, so an H100
//     (232,448 B a block) takes S up to 180 at sm-cnn's d and F; the
//     wrapper refuses a longer one.
//   * A persistent grid (at most the SMs x the blocks an SM holds) whose
//     blocks walk samples b, b + grid, ...: each block copies the filter
//     bank once, a tap a copy, so tap 0's products start while taps
//     1..w-1 arrive. Each sample lands in the raw tile, is split once into
//     the split tile (the B operands of all taps and warps), and the next
//     sample's copy starts at once, so it lands while this one computes.
//     The copies are cp.async.bulk (the copy engine: one thread issues a
//     tap, 20,000 B at sm-cnn's shape, or a sample, 12,800 B, and the
//     block waits on that copy's mbarrier) when a sample and a tap are
//     whole 16-byte chunks at aligned addresses, as on the main path;
//     else 4-byte cp.async, the whole bank before the first product
//     (these shapes are off the main path). (Issuing the bank as 4- or
//     16-byte copies held every block's first product back by most of a
//     sample's time on an H100 SXM: the copies queue in the load/store
//     unit; a bulk copy a tap is one instruction.)
//     Pads are not copied: the split pass writes the sample's zero rows and
//     columns, and the block writes the zeros past the bank, since
//     uninitialised shared memory may hold NaN bits and 0 * NaN is NaN.
//     Filters are split in registers as each A fragment is loaded (a
//     fragment serves the warp's 9 window tiles).
//   * Warps: a team of 2 owns a tile of 16 filters over up to 9 window
//     tiles (36 float32 accumulators each); its warps take alternate k
//     steps and then add up their sums. 7 teams, 14 warps at sm-cnn's
//     F=100 (one warp a team, or three, measured slower on an H100 SXM).
//     Inside the loop no tile is skipped, since a branch around an mma
//     costs more than it. Measured slower or no faster on an H100 SXM:
//     two filter tiles a warp (8 or 12 warps), a producer warp that splits
//     the next sample into a second split tile, the A fragment loaded a k
//     step ahead, a split without the inf/NaN selects once the bank is
//     known finite, a split pass of 4-float items.
//   * Epilogue in float32: the max over windows of the sums (windows past
//     S+w-1 in the last tile masked to -inf: their sums are 0, and
//     tanh(0 + b) may exceed the true max), per lane, then __shfl_xor_sync
//     over the 4 lanes of a filter (xor 1, 2); tanh(max + bias) last, since
//     tanh and + bias keep order; (B, F) written once.
//
// bfloat16: the first CUDA-core kernel (conv_tanh_maxpool_kernel): one
// block per sample, the sample staged transposed in shared memory, work
// items of 17 windows x 2 filters, float32 FMAs. It runs at the float32
// rate, far from its tensor-core bound; its redesign is later work.
//
// Every max on both routes propagates NaN (max.NaN.f32), as jnp.max does:
// a NaN in any window of a sample gives NaN, not the max of the others.
// Only filter width 5, the width of every sm-cnn configuration, is
// instantiated; the entry point refuses any other.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tf32.cuh"   // tf32_rna, Split / split, mma_tf32: the 3xTF32 arithmetic

namespace {

__device__ __forceinline__ float fmax_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// ------------------------------------------------- bfloat16: CUDA cores --

constexpr int TW = 17;         // windows per item: 68 = 4 * 17 at S=64, w=5
constexpr int TF = 2;          // filters per item
constexpr int MAX_THREADS = 256;   // one block: 200 items at sm-cnn's shape
                                   // (also caps registers at 255, no spills)

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// W: the filter width. `rows` is the staged row count, groups * TW + W - 1,
// so every item's TW+W-1 rows are in range.
template <typename T, int W>
__global__ void __launch_bounds__(MAX_THREADS)
conv_tanh_maxpool_kernel(const T* __restrict__ x, const T* __restrict__ filters,
                         const T* __restrict__ bias, T* __restrict__ out,
                         int S, int d, int F, int groups, int rows) {
  constexpr int XR = TW + W - 1;
  constexpr int pad = W - 1;
  const int n_win = S + W - 1;
  extern __shared__ float smem[];
  float* xs = smem;               // (d, rows): column k, padded row r at k*rows + r
  float* part = smem + d * rows;  // (groups, F): max over each group's windows
  const T* xb = x + (size_t)blockIdx.x * S * d;

  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d;          // consecutive threads read consecutive k
    const int k = i - r * d;
    const int s = r - pad;
    xs[k * rows + r] = (s >= 0 && s < S) ? to_f32(xb[(size_t)s * d + k]) : 0.f;
  }
  __syncthreads();

  const int n_fq = (F + TF - 1) / TF;
  const size_t tap_stride = (size_t)d * F;   // filters row j*d + k
  for (int item = threadIdx.x; item < groups * n_fq; item += blockDim.x) {
    const int g = item / n_fq;
    const int f0 = (item - g * n_fq) * TF;
    const int w0 = g * TW;
    float acc[TF][TW];
#pragma unroll
    for (int i = 0; i < TF; ++i)
#pragma unroll
      for (int t = 0; t < TW; ++t) acc[i][t] = 0.f;

    const float* xk = xs + w0;
    const T* fk = filters + f0;
    for (int k = 0; k < d; ++k, xk += rows, fk += F) {
      float xr[XR];
#pragma unroll
      for (int u = 0; u < XR; ++u) xr[u] = xk[u];
      float wv[W][TF];
#pragma unroll
      for (int j = 0; j < W; ++j)
#pragma unroll
        for (int i = 0; i < TF; ++i)
          wv[j][i] = f0 + i < F ? to_f32(fk[j * tap_stride + i]) : 0.f;
#pragma unroll
      for (int j = 0; j < W; ++j)
#pragma unroll
        for (int i = 0; i < TF; ++i)
#pragma unroll
          for (int t = 0; t < TW; ++t)
            acc[i][t] = fmaf(xr[t + j], wv[j][i], acc[i][t]);
    }
#pragma unroll
    for (int i = 0; i < TF; ++i) {
      if (f0 + i < F) {
        const float b = to_f32(bias[f0 + i]);
        float m = -CUDART_INF_F;
#pragma unroll
        for (int t = 0; t < TW; ++t) {
          if (w0 + t < n_win) m = fmax_nan(m, tanhf(acc[i][t] + b));
        }
        part[g * F + f0 + i] = m;
      }
    }
  }
  __syncthreads();

  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float m = part[f];
    for (int g = 1; g < groups; ++g) m = fmax_nan(m, part[g * F + f]);
    out[(size_t)blockIdx.x * F + f] = from_f32<T>(m);
  }
}

struct CoreGeom {
  int groups, rows, threads;
  size_t smem;
};

template <int W>
CoreGeom core_geom(int S, int d, int F) {
  CoreGeom g;
  const int n_win = S + W - 1;
  g.groups = (n_win + TW - 1) / TW;
  g.rows = g.groups * TW + W - 1;
  const int items = g.groups * ((F + TF - 1) / TF);
  g.threads = (items + 31) / 32 * 32;
  if (g.threads > MAX_THREADS) g.threads = MAX_THREADS;
  g.smem = sizeof(float) * ((size_t)d * g.rows + (size_t)g.groups * F);
  return g;
}

template <typename T, int W>
cudaError_t launch_core(const void* x, const void* filters, const void* bias, void* out,
                        int B, int S, int d, int F, cudaStream_t stream) {
  const CoreGeom g = core_geom<W>(S, d, F);
  conv_tanh_maxpool_kernel<T, W><<<B, g.threads, g.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(filters),
      static_cast<const T*>(bias), static_cast<T*>(out), S, d, F, g.groups, g.rows);
  return cudaGetLastError();
}

// ------------------------------------- float32: 3xTF32 on the tensor cores --

constexpr int TC_WT = 9;           // window n8 tiles a warp holds at once: 72 windows
constexpr int TC_KS = 2;           // a team: the warps that split a filter tile's k steps
constexpr int TC_MAX_TEAMS = 7;    // teams a block: 14 warps, at most 144 registers a thread
constexpr int TC_RED = 9;          // sums a lane hands over per round (4 rounds)

// Shapes of the staged operands, in floats (computed on the host).
struct TcGeom {
  int S, d, F;
  int n_win, w_tiles;        // windows, and n8 tiles over them
  int rows, d_pad, k_steps;  // a sample's staged rows, columns, and k8 steps
  int alloc_rows;            // rows of a tile in shared memory: at least one chunk of
                             // TC_WT window tiles, so that an idle one reads in bounds
  int ss;                    // row stride of the split tile
  int f_tiles;               // m16 tiles over F
  int teams, reps;           // teams, and filter tiles a team walks
  int bulk;                  // copies by cp.async.bulk (set at launch)
  int w_floats, x_floats, s_floats, r_floats;   // bank, raw sample, split tile, scratch
};

template <int W>
TcGeom tc_geom(int S, int d, int F) {
  TcGeom g;
  g.S = S;
  g.d = d;
  g.F = F;
  g.n_win = S + W - 1;
  g.w_tiles = (g.n_win + 7) / 8;
  g.rows = g.w_tiles * 8 + W - 1;
  g.alloc_rows = (g.w_tiles > TC_WT ? g.w_tiles : TC_WT) * 8 + W - 1;
  g.d_pad = (d + 7) / 8 * 8;
  g.k_steps = g.d_pad / 8;
  g.ss = 2 * g.d_pad + (2 * g.d_pad % 32 == 0 ? 16 : 0);   // = 16 mod 32
  g.f_tiles = (F + 15) / 16;
  g.teams = g.f_tiles < TC_MAX_TEAMS ? g.f_tiles : TC_MAX_TEAMS;
  g.reps = (g.f_tiles + g.teams - 1) / g.teams;
  // the bank as in filters, then zeros up to the last float a fragment reads
  g.w_floats = (((W - 1) * d + g.d_pad - 1) * F + g.f_tiles * 16 + 3) / 4 * 4;
  g.x_floats = (S * d + 3) / 4 * 4;
  g.s_floats = g.alloc_rows * g.ss;
  g.r_floats = g.teams * (TC_KS - 1) * 32 * TC_RED;
  return g;
}

size_t tc_smem(const TcGeom& g) {
  return sizeof(float) *
         ((size_t)g.w_floats + g.x_floats + g.s_floats + g.r_floats);
}

int tc_threads(const TcGeom& g) { return 32 * TC_KS * g.teams; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 4 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// wait until this thread's cp.async copies have landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

constexpr long long WAIT_LIMIT = 1ll << 33;   // clocks (seconds) before a stuck wait traps

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// waits for the phase of the given parity to complete; a wait that lasts
// seconds traps, so a fault ends the launch with an error instead of a hang
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > WAIT_LIMIT) __trap();
  } while (!done);
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) global ->
// shared by the copy engine, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The warps of team p (p, p + teams, ...) meet at named barrier 1 + p.
__device__ __forceinline__ void team_sync(int p) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + p), "n"(32 * TC_KS) : "memory");
}

// Sample b (S*d floats, as in x) into the raw tile by 4-byte cp.async.
__device__ __forceinline__ void stage_sample(float* tile, const float* __restrict__ x,
                                             int b, const TcGeom& g) {
  const float* xb = x + (size_t)b * g.S * g.d;
  for (int i = threadIdx.x; i < g.S * g.d; i += blockDim.x) cp_async4(tile + i, xb + i);
}

// The raw sample (landed, and visible to every thread) split into the
// split tile, whose row r is sample row r - (W-1) (zeros outside [0, S) and
// past column d): for row r and columns k0..k0+7, lane t's 4 floats are
// (hi[k0+t], hi[k0+t+4], lo[k0+t], lo[k0+t+4]), so one 16-byte load gives a
// lane its B fragment (rows k0+t and k0+t+4 of B) in both parts. hi keeps
// an inf or NaN as it is and lo is 0 there. Returns, on every thread,
// whether any element is inf or NaN; also the block's barrier (the raw
// sample is free after it).
template <int W>
__device__ __forceinline__ bool split_tile(const float* __restrict__ raw,
                                           float* __restrict__ split_t, const TcGeom& g) {
  int bad = 0;
  for (int item = threadIdx.x; item < g.rows * g.k_steps; item += blockDim.x) {
    const int r = item / g.k_steps;
    const int c8 = item - r * g.k_steps;
    const int s_row = r - (W - 1);
    const bool row_ok = s_row >= 0 && s_row < g.S;
    const float* src = raw + s_row * g.d + c8 * 8;
    uint32_t hi[8], lo[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const Split s = split(row_ok && c8 * 8 + e < g.d ? src[e] : 0.f);
      bad |= s.big_c != s.big;
      hi[e] = s.big;
      lo[e] = s.small;
    }
    float4* dst = reinterpret_cast<float4*>(split_t + r * g.ss + c8 * 16);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      dst[t] = make_float4(__uint_as_float(hi[t]), __uint_as_float(hi[t + 4]),
                           __uint_as_float(lo[t]), __uint_as_float(lo[t + 4]));
  }
  return __syncthreads_or(bad) != 0;
}

// One sample's (B, F) row, as out^T = filters^T x windows: the A operand
// (m16) is 16 filters of the bank, the B operand (n8) 8 windows of the
// split tile, whose window t at tap j is row t + j. Team p (warps p and
// p + teams) owns filter tiles p, p + teams, ...; its warps take every
// TC_KS-th k step of each tap, the start rotating with the tap (35 steps
// split 18/17), and the second hands its sums to the first through shared
// memory. NONFINITE: the sample holds an inf or NaN, so its
// hi for the cross pass is 0 there. wait_taps: the block's first sample,
// whose taps may still be in flight (bulk copies); every warp's first
// filter tile waits for tap j's mbarrier before tap j's products, and for
// those of the later taps that tap j's last k step reaches into (below)
// before that step.
//
// No tile is skipped inside the loop (a branch around an mma costs more
// than the mma). The last chunk of TC_WT window tiles starts at
// w_tiles - TC_WT where there are that many (its tiles then repeat windows
// of the chunk before, which a max takes twice to no effect), so every
// tile reads staged rows; with fewer, the one chunk's tiles past the
// windows read the tile's spare rows, which reach only windows past S+W-1,
// masked before the max. The bank is (W*d, F) as in filters, so a filter
// tile's rows past F read the next bank row (their sums are not written),
// and columns d..d_pad-1 of tap j read the first rows of the same filter in
// the taps after it (tap j + 1 at d >= 7), or the zeros past the bank,
// against the sample's zero columns. Those taps have landed (the waits
// above), so a finite weight adds 0 there, and a filter with an inf or NaN
// weight is NaN in every sample anyway (each weight meets a zero pad row in
// some window, in float32 and in JAX). Were such a tap still in flight, the
// fragment would hold what an earlier kernel left in shared memory, and a
// NaN there times the zero column would make a real filter NaN.
template <int W, bool NONFINITE>
__device__ __forceinline__ void conv_sample(const float* __restrict__ ws,
                                            const float* __restrict__ s_tile,
                                            float* __restrict__ scratch,
                                            const float* __restrict__ bias,
                                            float* __restrict__ out_row,
                                            const TcGeom& g, bool wait_taps,
                                            uint32_t bar_tap) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int team = warp % g.teams, kh = warp / g.teams;
  float* red = scratch + (team * (TC_KS - 1) + (kh > 0 ? kh - 1 : 0)) * 32 * TC_RED + lane;
  for (int rep = 0; rep < g.reps; ++rep) {
    const int ft_any = team + rep * g.teams;
    const int ft = ft_any < g.f_tiles ? ft_any : g.f_tiles - 1;   // a spare repeats one
    const bool waits = wait_taps && rep == 0;
    // A fragment: filters ft*16 + g and + 8 at columns k0 + t and + 4
    const float* wf = ws + tig * g.F + ft * 16 + grp;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};   // filters g and g + 8

    for (int wc_next = 0; wc_next < g.w_tiles; wc_next += TC_WT) {
      // the chunk's first window tile: the last chunk ends at the last tile
      const int wc = min(wc_next, max(g.w_tiles - TC_WT, 0));
      float acc[TC_WT][4];
#pragma unroll
      for (int n = 0; n < TC_WT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

#pragma unroll
      for (int j = 0; j < W; ++j) {
        const bool wait_j = g.bulk && waits && wc_next == 0;
        if (wait_j) mbar_wait(bar_tap + 8 * j, 0);
        const float* wj = wf + (size_t)j * g.d * g.F;
        const float* bj = s_tile + (wc * 8 + grp + j) * g.ss + tig * 4;
        for (int t = (kh + TC_KS - j % TC_KS) % TC_KS; t < g.k_steps; t += TC_KS) {
          const int k0 = t * 8;
          // the last k step's columns d..d_pad-1 read the first rows of tap
          // j + 1 (bulk copies need d_pad - d <= d): it must have landed too
          if (j + 1 < W && wait_j && t == g.k_steps - 1) mbar_wait(bar_tap + 8 * (j + 1), 0);
          uint32_t fa[4], fac[4], fs_[4];   // (g, t), (g+8, t), (g, t+4), (g+8, t+4)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const Split s = split(wj[(k0 + (q >> 1) * 4) * g.F + (q & 1) * 8]);
            fa[q] = s.big;
            fac[q] = s.big_c;
            fs_[q] = s.small;
          }
          // window tile n: its rows g, columns t and t + 4, in both parts
#pragma unroll
          for (int n = 0; n < TC_WT; ++n) {
            const float4 r = *reinterpret_cast<const float4*>(bj + n * 8 * g.ss + t * 16);
            const uint32_t hb0 = __float_as_uint(r.x), hb1 = __float_as_uint(r.y);
            const uint32_t hc0 = !NONFINITE || finite_bits(hb0) ? hb0 : 0u;
            const uint32_t hc1 = !NONFINITE || finite_bits(hb1) ? hb1 : 0u;
            // the small terms first
            mma_tf32(acc[n], fs_, hc0, hc1);
            mma_tf32(acc[n], fac, __float_as_uint(r.z), __float_as_uint(r.w));
            mma_tf32(acc[n], fa, hb0, hb1);
          }
        }
      }

      // the team's sums: the other warps hand theirs to the first, TC_RED at
      // a time
#pragma unroll
      for (int q = 0; q < 4 * TC_WT / TC_RED; ++q) {
        if (kh > 0) {
#pragma unroll
          for (int e = 0; e < TC_RED; ++e) red[e * 32] = acc[(q * TC_RED + e) / 4][(q * TC_RED + e) % 4];
        }
        team_sync(team);
        if (kh == 0) {
#pragma unroll
          for (int h = 0; h < TC_KS - 1; ++h)
#pragma unroll
            for (int e = 0; e < TC_RED; ++e)
              acc[(q * TC_RED + e) / 4][(q * TC_RED + e) % 4] += red[(h * TC_RED + e) * 32];
        }
        team_sync(team);
      }

      // the max over the windows of the sums (windows past S+W-1 masked);
      // tanh and the bias keep order, so they are applied to the max alone
      if (kh == 0) {
#pragma unroll
        for (int n = 0; n < TC_WT; ++n) {
          const int t0 = (wc + n) * 8 + 2 * tig;   // c0, c2: window t0; c1, c3: t0 + 1
          const bool in0 = t0 < g.n_win, in1 = t0 + 1 < g.n_win;
          mx[0] = fmax_nan(mx[0], fmax_nan(in0 ? acc[n][0] : -CUDART_INF_F,
                                           in1 ? acc[n][1] : -CUDART_INF_F));
          mx[1] = fmax_nan(mx[1], fmax_nan(in0 ? acc[n][2] : -CUDART_INF_F,
                                           in1 ? acc[n][3] : -CUDART_INF_F));
        }
      }
    }

    // the max over the 4 lanes of a filter, then tanh(max + bias), written once
    if (kh == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = mx[h];
        v = fmax_nan(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmax_nan(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const int f = ft * 16 + h * 8 + grp;
        if (tig == 0 && f < g.F && ft_any < g.f_tiles) out_row[f] = tanhf(v + bias[f]);
      }
    }
  }
}

// One block a resident slot; it walks samples blockIdx.x, + gridDim.x, ...
template <int W>
__global__ void __launch_bounds__(TC_MAX_TEAMS * TC_KS * 32, 1)
conv_tanh_maxpool_tf32x3_kernel(const float* __restrict__ x,
                                const float* __restrict__ filters,
                                const float* __restrict__ bias, float* __restrict__ out,
                                int B, TcGeom g) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // (W*d, F), then zeros
  float* raw = ws + g.w_floats;                  // (S, d)
  float* split_t = raw + g.x_floats;             // (alloc_rows, ss)
  float* scratch = split_t + g.s_floats;         // (teams, TC_KS - 1, TC_RED, 32)

  __shared__ __align__(8) uint64_t bars[W + 1];   // taps 0..W-1, then the sample
  const uint32_t bar_tap = smem_addr(bars), bar_x = smem_addr(bars + W);
  const uint32_t x_bytes = g.S * g.d * 4, tap_bytes = g.d * g.F * 4;
  int b = blockIdx.x;
  if (g.bulk) {
    if (threadIdx.x == 0) {
      for (int i = 0; i <= W; ++i) mbar_init(bar_tap + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      mbar_expect_tx(bar_x, x_bytes);
      bulk_copy(raw, x + (size_t)b * g.S * g.d, x_bytes, bar_x);
      for (int j = 0; j < W; ++j) {
        mbar_expect_tx(bar_tap + 8 * j, tap_bytes);
        bulk_copy(ws + (size_t)j * g.d * g.F, filters + (size_t)j * g.d * g.F, tap_bytes,
                  bar_tap + 8 * j);
      }
    }
    __syncthreads();                      // the barriers are initialised
  } else {
    stage_sample(raw, x, b, g);
    for (int i = threadIdx.x; i < W * g.d * g.F; i += blockDim.x)
      cp_async4(ws + i, filters + i);
  }

  // the zeros past the bank, which fragments of tiles past F and columns
  // past d read (no copy writes them)
  for (int i = W * g.d * g.F + threadIdx.x; i < g.w_floats; i += blockDim.x) ws[i] = 0.f;

  for (int it = 0; b < B; ++it, b += gridDim.x) {
    // this sample has landed (with 4-byte copies: and the whole bank; with
    // bulk copies a tap may still be in flight until its first use)
    if (g.bulk) mbar_wait(bar_x, it & 1);
    else cp_async_wait_all();
    __syncthreads();
    const bool nonfinite = split_tile<W>(raw, split_t, g);
    // the raw tile is free: the next sample arrives while this one computes
    const int nb = b + gridDim.x;
    if (g.bulk) {
      if (nb < B && threadIdx.x == 0) {
        // the block's reads of the raw tile come before the copy's writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(bar_x, x_bytes);
        bulk_copy(raw, x + (size_t)nb * g.S * g.d, x_bytes, bar_x);
      }
    } else if (nb < B) {
      stage_sample(raw, x, nb, g);
    }
    float* row = out + (size_t)b * g.F;
    if (nonfinite)
      conv_sample<W, true>(ws, split_t, scratch, bias, row, g, it == 0, bar_tap);
    else
      conv_sample<W, false>(ws, split_t, scratch, bias, row, g, it == 0, bar_tap);
    __syncthreads();                      // all done with the split tile
  }
}

template <int W>
cudaError_t launch_tc(const void* x, const void* filters, const void* bias, void* out,
                      int B, int S, int d, int F, int slots, cudaStream_t stream) {
  TcGeom g = tc_geom<W>(S, d, F);
  // a sample and a tap are whole 16-byte chunks at 16-byte aligned addresses
  // (and tap j's pad columns reach no further than tap j + 1)
  g.bulk = S * d % 4 == 0 && d * F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(filters) % 16 == 0 && g.d_pad - d <= d;
  conv_tanh_maxpool_tf32x3_kernel<W><<<B < slots ? B : slots, tc_threads(g), tc_smem(g),
                                       stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(filters),
      static_cast<const float*>(bias), static_cast<float*>(out), B, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (3xTF32 tensor-core kernel), 1 = bfloat16 (CUDA-core
// kernel); width must be 5 (the one instantiated). slots: the blocks of the
// float32 kernel the card holds at once (SMs x blocks an SM holds), the
// size of its persistent grid at most (the bfloat16 kernel runs a block a
// sample). sm_cnn_conv_route_info must have been called for the dtype on the
// current device first: it lets the kernel take its shared memory. Returns a
// cudaError_t (0 on success).
int sm_cnn_conv_tanh_maxpool(int dtype, const void* x, const void* filters,
                             const void* bias, void* out, int B, int S, int d,
                             int width, int F, int slots, void* stream) {
  if (B <= 0 || S <= 0 || d <= 0 || F <= 0 || width != 5 || slots <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_tc<5>(x, filters, bias, out, B, S, d, F, slots, s);
    case 1: return (int)launch_core<__nv_bfloat16, 5>(x, filters, bias, out, B, S, d, F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// info: design stage (0 = CUDA-core FMA, 1 = 3xTF32 mma.sync + cp.async),
// registers and local (spill) bytes a thread, static and dynamic shared
// memory a block, blocks resident on an SM (0 where a block needs more
// shared memory than the card allows) and threads a block, at (S, d, F)
// with width 5; then the most shared memory a block may have and the SMs,
// on the current device. Also lets the dtype's kernel take up to that most
// (less its static memory), whatever the shape, so that no query at one
// shape refuses a launch at another. Returns a cudaError_t.
int sm_cnn_conv_route_info(int dtype, int S, int d, int F, int* info) {
  if (S <= 0 || d <= 0 || F <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const void* fn = dtype == 0 ? (const void*)conv_tanh_maxpool_tf32x3_kernel<5>
                              : (const void*)conv_tanh_maxpool_kernel<__nv_bfloat16, 5>;
  size_t smem;
  int threads;
  if (dtype == 0) {
    const TcGeom g = tc_geom<5>(S, d, F);
    smem = tc_smem(g);
    threads = tc_threads(g);
  } else {
    const CoreGeom g = core_geom<5>(S, d, F);
    smem = g.smem;
    threads = g.threads;
  }
  int dev = 0, limit = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, fn)) != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             limit - (int)attr.sharedSizeBytes);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  if (smem + attr.sharedSizeBytes <= (size_t)limit) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
    if (err != cudaSuccess) return (int)err;
  }
  info[0] = dtype == 0 ? 1 : 0;
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  info[3] = (int)attr.sharedSizeBytes;
  info[4] = (int)smem;
  info[5] = blocks;
  info[6] = threads;
  info[7] = limit;
  info[8] = sms;
  return 0;
}

}  // extern "C"
