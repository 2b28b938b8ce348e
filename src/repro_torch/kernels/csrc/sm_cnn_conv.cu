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
//     float32 at 67 TFLOP/s (no tensor cores) -> 12.2 us
//     bfloat16 at 989 TFLOP/s (tensor cores)  -> 0.83 us
//   bytes (x, filters, bias in; (B, F) out) 3.48 MB float32 at 3.35 TB/s
//     -> 1.0 us
// so the kernel is bound by operations: about 12.2 us in float32. The
// batched plan's B=4096 calls scale both by 16. The kernel also multiplies
// the zero pad rows of the edge windows (68 windows of 5 taps, not 64 rows
// of 5): 68/64 of the bound's FMAs, an overhead above it.
//
// Design (simple and right first; wgmma, TMA and a fused embed[tok] gather
// are later work). Since the bound is the multiply-adds, the design keeps
// the float32 FMA pipes fed and spends few other instructions per FMA:
//   * one block per sample, so any B works (no B % 8 condition). The
//     sample is staged once in shared memory as float32, transposed to
//     (d, rows) so that the rows one thread needs for one embedding column
//     are consecutive; the w-1 pad rows (and rows past the last window)
//     are written as zeros by a bounds check on the load, so the pad never
//     exists in device memory and the inner loop has no bounds checks;
//   * a work item is TW=17 consecutive windows x TF=2 filters, i.e. 34
//     float32 accumulators in registers. For each embedding column k the
//     item loads its TW+w-1 rows once (shared-memory broadcasts: the lanes
//     of a warp share the window group) and its w*TF filter taps, all
//     before the first FMA, then does w*TW*TF FMAs: 170 FMAs for 21 shared
//     and 10 global loads at w=5. The filters are read from global memory
//     (coalesced over the filter index) and stay in L1/L2 at 100 KB;
//   * the filter width is a template parameter with every loop unrolled;
//     only w=5, the width of every sm-cnn configuration, is instantiated,
//     and the launcher refuses any other;
//   * bias and tanh per window, a max over the item's windows into shared
//     memory, then a max over window groups writes (B, F) once in the
//     input's type.
// The FMAs run on the float32 pipes, so bfloat16 runs at the float32 rate,
// far from its tensor-core bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TW = 17;         // windows per item: 68 = 4 * 17 at S=64, w=5
constexpr int TF = 2;          // filters per item
constexpr int MAX_THREADS = 256;   // one block: 200 items at sm-cnn's shape
                                   // (also caps registers at 255, no spills)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
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
          if (w0 + t < n_win) m = fmaxf(m, tanhf(acc[i][t] + b));
        }
        part[g * F + f0 + i] = m;
      }
    }
  }
  __syncthreads();

  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float m = part[f];
    for (int g = 1; g < groups; ++g) m = fmaxf(m, part[g * F + f]);
    out[(size_t)blockIdx.x * F + f] = from_f32<T>(m);
  }
}

template <typename T, int W>
cudaError_t launch(const void* x, const void* filters, const void* bias, void* out,
                   int B, int S, int d, int F, cudaStream_t stream) {
  const int n_win = S + W - 1;
  const int groups = (n_win + TW - 1) / TW;
  const int rows = groups * TW + W - 1;
  const int items = groups * ((F + TF - 1) / TF);
  int threads = (items + 31) / 32 * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const size_t smem = sizeof(float) * ((size_t)d * rows + (size_t)groups * F);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_tanh_maxpool_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  conv_tanh_maxpool_kernel<T, W><<<B, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(filters),
      static_cast<const T*>(bias), static_cast<T*>(out), S, d, F, groups, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; width must be 5 (the one instantiated).
// Returns a cudaError_t (0 on success).
int sm_cnn_conv_tanh_maxpool(int dtype, const void* x, const void* filters,
                             const void* bias, void* out, int B, int S, int d,
                             int width, int F, void* stream) {
  if (B <= 0 || S <= 0 || d <= 0 || F <= 0 || width != 5)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float, 5>(x, filters, bias, out, B, S, d, F, s);
    case 1: return (int)launch<__nv_bfloat16, 5>(x, filters, bias, out, B, S, d, F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
