// embedding_bag_bwd for Hopper (sm_90a): the table gradient of embedding_bag,
// every DLRM training step's embedding update.
//
//   grad[r, :] = sum over the positions (b, l) whose id names row r of
//                w[b, l] * grad_out[b, :]
//
//   grad_out (B, d) float32 or bfloat16, w (B, L) float32 or null (every
//   weight 1), grad (V, d) dense in grad_out's type: a row no id names is 0.
//   Ids follow the reference's jnp.take gradient: an id in [-V, 0) names row
//   id + V, and an id outside [-V, V) adds nothing.
//
// The caller hands over the positions p = b * L + l already ordered by row:
// `keys` holds each position's row (V for an id outside the table), sorted,
// and `perm` the position itself, in a stable order, so equal rows keep the
// order of p (kernels/embedding_bag.py makes both with torch.sort, index
// preparation like the forward's field offsets). Summing and writing are
// this file's.
//
// Order of the sums (the plain version, embedding_bag_bwd_plain, follows it
// and agrees bit for bit): the sorted positions are cut into tiles of CHUNK;
// a row's positions inside one tile form a segment, summed in float32 from 0
// in order of p, each product w * g rounded on its own before the add (no
// fused multiply-add); the row's value is 0 plus its segments' sums in tile
// order, rounded once to the table's type. A row that lies inside one tile
// is its one segment's sum. No float atomics: two calls are bit-equal.
//
// There is no TPU kernel of this gradient. Its twins in the JAX package are
// the VJP of jnp.take in embedding_lookup (src/repro/models/recsys.py:44)
// and of ref.embedding_bag_ref (src/repro/kernels/ref.py:22). Unlike that
// VJP, which sums a bfloat16 table's gradient in bfloat16 (3000 ones on one
// row give 256), every sum here is float32.
//
// Bound on an H100 SXM: bytes. The function must read the ids once and
// grad_out once (every position's bag row) and write the dense (V, d)
// gradient once; its adds are d a position, far below the float32 pipes.
// At dlrm-mlperf's training batch (65,536 x 26 bags of one row, d = 128,
// bfloat16) with each field cut to 1,000,000 rows (V = 7,110,656): 6.8 MB of
// ids + 436.2 MB of grad_out + 1,820.3 MB of gradient = 2.263 GB, 0.676 ms at
// 3.35 TB/s. The dense write is 80% of it.
//
// Design (simple and right first), three kernels on the caller's stream:
//   * tiles: one warp a tile of CHUNK sorted positions (lane k holds the
//     keys, bags and weights of positions k and k + 32 in registers, handed
//     round by shuffles). It walks the tile in order, lane k summing columns
//     4k .. 4k+3 (and 4k + 128 j when d > 128) in float32 registers, UNROLL
//     rows of grad_out loaded ahead. A segment whose row neither started in
//     the tile before nor goes on in the tile after is the row's whole
//     gradient: it is rounded and written. A segment cut at the tile's start
//     or end goes to a float32 scratch slot (two a tile: first, last
//     segment). Every named row is marked in a byte map.
//   * zero: a grid-stride pass writes 0 over every row the map leaves
//     unmarked, so no row is written twice.
//   * long: a row cut across tiles is added up by the warp of the tile where
//     it starts: its end tile found 32 tiles at a time by a ballot, then its
//     scratch slots added in tile order, rounded and written.
//   Skew is why: at B = 65,536 a 3-row Criteo field names each row ~21,845
//   times. One warp per row would leave a tail of one warp reading 21,845
//   rows of 256 bytes; here the rows are read by 342 warps in parallel and
//   one warp adds 342 float32 partial rows.
//   Offsets are 64-bit ((size_t)row * d passes 2^31 in a float32 table of
//   20M rows). An id outside the table is never used as an address.
// It allocates nothing (the wrapper hands over the scratch and the byte
// map) and returns the first CUDA error, or cudaGetLastError() after the
// last launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "vec4.cuh"   // Vec4, load4, store4: a lane's 4 columns of a row

namespace {

constexpr int WARPS = 8;                // tiles (or rows) per block
constexpr int THREADS = 32 * WARPS;
constexpr int VEC = 4;                  // columns per lane per row slice
constexpr int CHUNK = 64;               // sorted positions a tile
constexpr int REGS = CHUNK / 32;        // positions each lane holds
constexpr int UNROLL = 4;               // grad_out rows loaded ahead
constexpr unsigned FULL = 0xffffffffu;
constexpr int ZERO_BLOCKS = 8192;       // the zero pass's grid (grid-stride)

static_assert(CHUNK % 32 == 0 && 32 % UNROLL == 0, "tile shape");

__device__ __forceinline__ void add4(Vec4& acc, const Vec4& x) {
  acc.x = __fadd_rn(acc.x, x.x);
  acc.y = __fadd_rn(acc.y, x.y);
  acc.z = __fadd_rn(acc.z, x.z);
  acc.w = __fadd_rn(acc.w, x.w);
}

// product and sum each rounded (no fused multiply-add)
__device__ __forceinline__ void add4(Vec4& acc, float w, const Vec4& x) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, x.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, x.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(w, x.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(w, x.w));
}

// A finished segment of row `key`: the row's gradient when the segment is
// the whole row (`cut` false), else a float32 partial in scratch slot `slot`.
template <typename T>
__device__ __forceinline__ void put_segment(int32_t key, int32_t n_rows, const Vec4& acc,
                                            bool cut, long long slot, int d, int c,
                                            bool active, int lane, T* grad, float* partial,
                                            unsigned char* named) {
  if (key >= n_rows) return;   // the positions of ids outside the table
  if (lane == 0) named[key] = 1;
  if (!active) return;
  if (cut) {
    store4(partial + slot * d + c, acc);
  } else {
    store4(grad + (size_t)key * d + c, acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bag_bwd_tiles(const T* __restrict__ grad_out, int d, const int32_t* __restrict__ keys,
              const long long* __restrict__ perm, const float* __restrict__ weights,
              long long n_pos, int bag_len, int32_t n_rows, long long n_tiles,
              T* __restrict__ grad, float* __restrict__ partial,
              unsigned char* __restrict__ named) {
  const long long tile = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;
  const int lane = threadIdx.x & 31;
  const long long lo = tile * CHUNK;
  const int n = (int)min((long long)CHUNK, n_pos - lo);
  int32_t key_r[REGS];
  long long bag_r[REGS];
  float w_r[REGS];
#pragma unroll
  for (int r = 0; r < REGS; ++r) {
    const int j = 32 * r + lane;
    key_r[r] = n_rows;
    bag_r[r] = 0;
    w_r[r] = 1.f;
    if (j < n) {
      key_r[r] = __ldg(keys + lo + j);
      const long long p = __ldg(perm + lo + j);
      bag_r[r] = p / bag_len;
      if (weights != nullptr) w_r[r] = __ldg(weights + p);
    }
  }
  const int32_t first = __shfl_sync(FULL, key_r[0], 0);
  const int32_t last = __ldg(keys + lo + n - 1);
  const bool cut_start = tile > 0 && __ldg(keys + lo - 1) == first;
  const bool cut_end = lo + n < n_pos && __ldg(keys + lo + n) == last;
  for (int c0 = 0; c0 < d; c0 += 32 * VEC) {
    const int c = c0 + lane * VEC;
    const bool active = c < d;
    Vec4 acc = {0.f, 0.f, 0.f, 0.f};
    int32_t cur = first;
    bool first_seg = true;
#pragma unroll
    for (int r = 0; r < REGS; ++r) {
      for (int k0 = 0; k0 < 32 && 32 * r + k0 < n; k0 += UNROLL) {
        int32_t ks[UNROLL];
        float ws[UNROLL];
        Vec4 xs[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          ks[u] = __shfl_sync(FULL, key_r[r], k0 + u);
          ws[u] = __shfl_sync(FULL, w_r[r], k0 + u);
          const long long b = __shfl_sync(FULL, bag_r[r], k0 + u);
          xs[u] = {0.f, 0.f, 0.f, 0.f};
          if (active && ks[u] < n_rows) xs[u] = load4(grad_out + b * d + c);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (32 * r + k0 + u >= n) break;
          if (ks[u] != cur) {   // the segment of `cur` ends inside the tile
            put_segment(cur, n_rows, acc, first_seg && cut_start, 2 * tile, d, c, active,
                        lane, grad, partial, named);
            acc = {0.f, 0.f, 0.f, 0.f};
            cur = ks[u];
            first_seg = false;
          }
          if (ks[u] < n_rows) {
            if (weights != nullptr) {
              add4(acc, ws[u], xs[u]);
            } else {
              add4(acc, xs[u]);
            }
          }
        }
      }
    }
    put_segment(cur, n_rows, acc, (first_seg && cut_start) || cut_end,
                first_seg ? 2 * tile : 2 * tile + 1, d, c, active, lane, grad, partial,
                named);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bag_bwd_zero(T* __restrict__ grad, int d, long long n_rows,
             const unsigned char* __restrict__ named) {
  const int lane = threadIdx.x & 31;
  const Vec4 zero = {0.f, 0.f, 0.f, 0.f};
  for (long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5); row < n_rows;
       row += (long long)gridDim.x * WARPS) {
    if (named[row]) continue;
    for (int c = lane * VEC; c < d; c += 32 * VEC) store4(grad + (size_t)row * d + c, zero);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bag_bwd_long(const int32_t* __restrict__ keys, long long n_tiles, int32_t n_rows, int d,
             const float* __restrict__ partial, T* __restrict__ grad) {
  const long long tile = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (tile + 1 >= n_tiles) return;   // the last tile has no tile after it
  const int lane = threadIdx.x & 31;
  const long long lo = tile * CHUNK;
  const long long hi = lo + CHUNK;
  const int32_t row = __ldg(keys + hi - 1);
  if (row >= n_rows || __ldg(keys + hi) != row) return;   // not cut at this tile's end
  const int32_t first = __ldg(keys + lo);
  if (first == row && tile > 0 && __ldg(keys + lo - 1) == row) return;   // began earlier
  // the row ends in tile `end`, the first tile after this one whose
  // successor does not start with the row
  long long end = tile + 1;
  for (;;) {
    const long long t = end + lane;
    const bool ends = t + 1 >= n_tiles || __ldg(keys + (t + 1) * CHUNK) != row;
    const unsigned m = __ballot_sync(FULL, ends);
    if (m != 0) {
      end += __ffs(m) - 1;
      break;
    }
    end += 32;
  }
  const long long slot0 = first == row ? 2 * tile : 2 * tile + 1;
  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    Vec4 acc = load4(partial + slot0 * d + c);
#pragma unroll 8
    for (long long t = tile + 1; t <= end; ++t) add4(acc, load4(partial + 2 * t * d + c));
    store4(grad + (size_t)row * d + c, acc);
  }
}

template <typename T>
int launch_all(const T* grad_out, int d, const int32_t* keys, const long long* perm,
               const float* weights, long long n_pos, int bag_len, long long n_rows,
               T* grad, float* partial, unsigned char* named, cudaStream_t s) {
  const long long n_tiles = (n_pos + CHUNK - 1) / CHUNK;
  const long long tile_blocks = (n_tiles + WARPS - 1) / WARPS;
  cudaError_t err = cudaMemsetAsync(named, 0, (size_t)n_rows, s);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    bag_bwd_tiles<T><<<(unsigned)tile_blocks, THREADS, 0, s>>>(
        grad_out, d, keys, perm, weights, n_pos, bag_len, (int32_t)n_rows, n_tiles, grad,
        partial, named);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const long long zero_blocks = (n_rows + WARPS - 1) / WARPS;
  bag_bwd_zero<T><<<(unsigned)(zero_blocks < ZERO_BLOCKS ? zero_blocks : ZERO_BLOCKS),
                    THREADS, 0, s>>>(grad, d, n_rows, named);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (n_tiles > 1) {
    bag_bwd_long<T><<<(unsigned)tile_blocks, THREADS, 0, s>>>(keys, n_tiles, (int32_t)n_rows,
                                                              d, partial, grad);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Sorted positions a tile: the wrapper sizes the scratch with it, and the
// plain version cuts segments at its multiples.
extern "C" int embedding_bag_bwd_chunk() { return CHUNK; }

// dtype: 0 float32, 1 bfloat16. keys (n_pos,) int32 sorted, perm (n_pos,)
// int64, weights (B * L,) float32 or null, grad (n_rows, d), partial
// partial_len >= 2 * ceil(n_pos / CHUNK) * d floats, named n_rows bytes.
// Returns a cudaError_t as int (0 on success).
extern "C" int embedding_bag_bwd(int dtype, const void* grad_out, int d, const void* keys,
                                 const void* perm, const void* weights, long long n_pos,
                                 int bag_len, long long n_rows, void* grad, void* partial,
                                 long long partial_len, void* named, void* stream) {
  if (d <= 0 || d % VEC != 0 || n_rows <= 0 || n_rows > INT32_MAX || n_pos < 0 ||
      (n_pos > 0 && bag_len <= 0))
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (n_pos + CHUNK - 1) / CHUNK;
  if (partial_len < 2 * n_tiles * d) return (int)cudaErrorInvalidValue;
  if ((n_tiles + WARPS - 1) / WARPS > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* k = static_cast<const int32_t*>(keys);
  const long long* p = static_cast<const long long*>(perm);
  const float* w = static_cast<const float*>(weights);
  float* part = static_cast<float*>(partial);
  unsigned char* m = static_cast<unsigned char*>(named);
  if (dtype == 0) {
    return launch_all<float>(static_cast<const float*>(grad_out), d, k, p, w, n_pos, bag_len,
                             n_rows, static_cast<float*>(grad), part, m, s);
  }
  if (dtype == 1) {
    return launch_all<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(grad_out), d, k, p, w,
                                     n_pos, bag_len, n_rows, static_cast<__nv_bfloat16*>(grad),
                                     part, m, s);
  }
  return (int)cudaErrorInvalidValue;
}
