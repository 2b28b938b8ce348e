// embedding_bag for Hopper (sm_90a): fixed-arity weighted bags of table rows,
// every DLRM embedding lookup.
//
//   out[b, :] = sum over l = 0 .. L-1 of w[b, l] * table[ids[b, l], :]
//
//   table (V, d) float32 or bfloat16, ids (B, L) int32, w (B, L) float32 or
//   null (null means every weight is 1), out (B, d) in the table's type; all
//   contiguous. Each bag is summed in float32, in order l = 0 .. L-1, and
//   written once in the table's type.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag.py:45
// (embedding_bag; body _kernel at :26, pallas_call at :56), which held a
// block of bags' ids in VMEM and fetched each row with a dynamic VMEM load.
// DLRM's per-field single-hot lookups are the L = 1 case, with the field
// offsets folded into the ids by the caller (models/recsys.py).
//
// Bound on an H100 SXM: bytes. A bag does d (or 2d, weighted) float
// operations per row it reads, far below the ~20 operations per byte where
// the float32 pipes would become the limit. The bytes the function needs
// are the ids (and weights) once, each distinct row it names once, and the
// output once. At dlrm-mlperf's serve_bulk (262,144 x 26 bags of one
// bfloat16 row of 128) that is at most 27.3 MB of ids + 1.745 GB of rows +
// 1.745 GB of output = 3.517 GB, 1.050 ms at 3.35 TB/s; fewer when ids
// repeat, since a row read once serves every bag that names it.
//
// Design (simple and right first):
//   * one warp per bag, 8 bags per 256-thread block; the bag count is on
//     gridDim.x (up to 2^31 - 1 blocks), so serve_bulk's 6,815,744 bags fit;
//   * lane k holds columns 4k .. 4k+3 of the bag (and of 4k + 128 j when
//     d > 128) in float32 registers, and reads its slice of each row with
//     one vector load: 8 bytes in bfloat16, 16 in float32. A warp reads a
//     128-wide row in one 256- or 512-byte transaction. d must be a
//     multiple of 4 and the table must start on a 16-byte boundary, so
//     every slice is aligned; the wrapper refuses anything else;
//   * every lane reads the bag's id (and weight) itself: the 32 reads of
//     one address are one broadcast transaction;
//   * offsets are 64-bit: (size_t)row * d reaches 2.4e10 elements in the
//     full 187,767,808-row dlrm-mlperf table, past 2^31;
//   * ids follow the reference's jnp.take: an id in [-V, 0) names row
//     id + V, and an id outside [-V, V) makes its whole bag NaN (take fills
//     such a row with NaN, and the sum carries it). Such an id is never
//     used as an address, so the kernel never reads outside the table;
//   * with no weights nothing is multiplied, so an L = 1 bag is its row,
//     bit for bit (0 + x is x), in either type; with weights each product
//     and each sum is rounded on its own (no fused multiply-add), so the
//     plain version, which sums in the same order, agrees bit for bit.
// It runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "vec4.cuh"   // Vec4, load4, store4: a lane's 4 columns of a row

namespace {

constexpr int WARPS = 8;                // bags per block
constexpr int THREADS = 32 * WARPS;
constexpr int VEC = 4;                  // columns per lane per row slice

template <typename T>
__global__ void __launch_bounds__(THREADS)
embedding_bag_kernel(const T* __restrict__ table, long long n_rows, int d,
                     const int32_t* __restrict__ ids,
                     const float* __restrict__ weights, T* __restrict__ out,
                     long long n_bags, int bag_len) {
  const long long bag = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (bag >= n_bags) return;
  const int lane = threadIdx.x & 31;
  const int32_t* bag_ids = ids + bag * bag_len;
  const float* bag_w = weights == nullptr ? nullptr : weights + bag * bag_len;
  T* dst = out + bag * d;
  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    Vec4 acc = {0.f, 0.f, 0.f, 0.f};
    bool outside = false;
#pragma unroll 4
    for (int l = 0; l < bag_len; ++l) {
      const int32_t id = __ldg(bag_ids + l);
      const long long row = id < 0 ? id + n_rows : id;
      if (row < 0 || row >= n_rows) {
        outside = true;
        continue;
      }
      const Vec4 r = load4(table + (size_t)row * d + c);
      if (bag_w == nullptr) {
        acc.x += r.x;
        acc.y += r.y;
        acc.z += r.z;
        acc.w += r.w;
      } else {   // product and sum each rounded (no fused multiply-add)
        const float w = __ldg(bag_w + l);
        acc.x = __fadd_rn(acc.x, __fmul_rn(w, r.x));
        acc.y = __fadd_rn(acc.y, __fmul_rn(w, r.y));
        acc.z = __fadd_rn(acc.z, __fmul_rn(w, r.z));
        acc.w = __fadd_rn(acc.w, __fmul_rn(w, r.w));
      }
    }
    if (outside) {
      const float nan = __int_as_float(0x7fc00000);
      acc = {nan, nan, nan, nan};
    }
    store4(dst + c, acc);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. weights may be null (all weights 1).
// Returns a cudaError_t as int (0 on success).
extern "C" int embedding_bag_fwd(int dtype, const void* table,
                                 long long n_rows, int d, const void* ids,
                                 const void* weights, void* out,
                                 long long n_bags, int bag_len, void* stream) {
  if (n_bags <= 0 || d <= 0 || d % VEC != 0 || bag_len < 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_bags + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* id_p = static_cast<const int32_t*>(ids);
  const float* w_p = static_cast<const float*>(weights);
  if (dtype == 0) {
    embedding_bag_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(table), n_rows, d, id_p, w_p,
        static_cast<float*>(out), n_bags, bag_len);
  } else if (dtype == 1) {
    embedding_bag_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(table), n_rows, d, id_p, w_p,
        static_cast<__nv_bfloat16*>(out), n_bags, bag_len);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
