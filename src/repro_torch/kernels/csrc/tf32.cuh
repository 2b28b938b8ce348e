// tf32.cuh: float32-accurate products on the tensor cores in 3xTF32, the
// arithmetic that the float32 routes of sm_cnn_conv.cu (the conv) and
// flash_attention.cu / flash_attention_bwd.cu (attention and its gradient)
// share. One TF32 product keeps about 2^-11 of each operand, far from a
// float32 gate; so each operand is split v = hi + lo, both rounded to TF32
// as cvt.rna.tf32.f32 rounds, and three mma.sync.m16n8k8 TF32 passes,
// lo*hi + hi*lo + hi*hi (the small terms first), sum into float32
// accumulators. The dropped lo*lo is about 2^-22 of the product.
//
// Non-finite inputs follow float32, not the split: for v = inf,
// lo = inf - inf = NaN, and inf * lo is NaN where the other operand's lo is
// 0. So hi keeps inf and NaN for the hi*hi pass (Split::big), while the two
// cross passes take operands whose non-finite entries are 0 (Split::big_c
// and Split::small).
//
// build.py hashes every *.cuh with each source, so an edit here rebuilds
// the three libraries.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Round float32 bits to TF32 as cvt.rna.tf32.f32 does for a finite value:
// to nearest, ties away from zero (add half a TF32 ulp to the magnitude,
// clear the 13 low mantissa bits). Two integer operations.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t u) {
  return (u + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ bool finite_bits(uint32_t u) {
  return (u & 0x7f800000u) != 0x7f800000u;
}

// v = big + small in TF32; big keeps an inf or NaN as it is (for hi*hi)
// while big_c and small are 0 there, so the cross passes carry neither.
struct Split {
  uint32_t big, big_c, small;
};

__device__ __forceinline__ Split split(float v) {
  Split s;
  const uint32_t u = __float_as_uint(v);
  const bool finite = finite_bits(u);
  s.big = finite ? tf32_rna(u) : u;
  const uint32_t lo = tf32_rna(__float_as_uint(v - __uint_as_float(s.big)));
  s.big_c = finite ? s.big : 0u;
  s.small = finite ? lo : 0u;
  return s;
}

// split for a value known to be finite: the same parts with no selects. Not
// for a value that may be NaN: the rounding carries a NaN's mantissa into
// its sign (0x7fffffff becomes -0)
__device__ __forceinline__ Split split_finite(float v) {
  Split s;
  s.big = tf32_rna(__float_as_uint(v));
  s.small = tf32_rna(__float_as_uint(v - __uint_as_float(s.big)));
  s.big_c = s.big;
  return s;
}

// split, or split_finite where NF says no inf or NaN can reach v
template <bool NF>
__device__ __forceinline__ Split split_as(float v) {
  return NF ? split(v) : split_finite(v);
}

// whether any of this thread's 16-byte items of bytes at p holds an inf or NaN
__device__ __forceinline__ bool any_nonfinite(const unsigned char* p, int bytes) {
  bool bad = false;
  for (int o = threadIdx.x * 16; o < bytes; o += blockDim.x * 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(p + o);
    bad |= !finite_bits(x.x) | !finite_bits(x.y) | !finite_bits(x.z) | !finite_bits(x.w);
  }
  return bad;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------- float32 tiles of attention --
//
// flash_attention.cu and flash_attention_bwd.cu feed these products from
// float32 tiles of n rows x 128 values (a head) as TMA lands them with the
// 128-byte swizzle: four boxes of 32 values (128 bytes) a row, box a at
// a * n * 128 bytes, row r of a box at r * 128, its 16-byte chunk c at
// (c ^ (r & 7)) * 16, from a 1024-byte aligned base (n a multiple of 8). A
// split pass writes each raw tile's hi and lo parts at the raw offsets (the
// swizzle permutes 16-byte chunks, which an elementwise split keeps), and a
// fragment is read from them with 4-byte loads at sw_off. Read either way,
// rows (r, r + 1, ...) at a fixed column or columns at a fixed row, a
// warp's fragment loads meet 32 distinct banks.

// byte offset of (row r, column col) in such a tile of n rows
__device__ __forceinline__ uint32_t sw_off(int n, int r, int col) {
  return (uint32_t)((col >> 5) * n * 128 + r * 128 + ((((col >> 2) & 7) ^ (r & 7)) << 4) +
                    ((col & 3) << 2));
}

__device__ __forceinline__ uint32_t ld_u32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ float ld_f32(const unsigned char* p) {
  return *reinterpret_cast<const float*>(p);
}

// The split pass over `parts` raw tiles of part_bytes each, contiguous at
// raw: part i's hi goes to dst + 2 i part_bytes and its lo part_bytes after
// that, each value at its raw offset, by the block's threads in 16-byte
// items. hi keeps an inf or NaN as it is and lo is 0 there. Returns
// whether this thread met an inf or NaN.
__device__ __forceinline__ bool split_tiles(const unsigned char* raw, unsigned char* dst,
                                            int part_bytes, int parts) {
  bool bad = false;
  for (int o = threadIdx.x * 16; o < parts * part_bytes; o += blockDim.x * 16) {
    const float4 x = *reinterpret_cast<const float4*>(raw + o);
    const Split s0 = split(x.x), s1 = split(x.y), s2 = split(x.z), s3 = split(x.w);
    bad |= (s0.big_c != s0.big) | (s1.big_c != s1.big) | (s2.big_c != s2.big) |
           (s3.big_c != s3.big);
    const int part = o / part_bytes;
    unsigned char* hi = dst + part * 2 * part_bytes + (o - part * part_bytes);
    *reinterpret_cast<uint4*>(hi) = make_uint4(s0.big, s1.big, s2.big, s3.big);
    *reinterpret_cast<uint4*>(hi + part_bytes) = make_uint4(s0.small, s1.small, s2.small,
                                                            s3.small);
  }
  return bad;
}

// c += a b in 3xTF32, small terms first: a split in registers (the m16n8k8
// A fragment), b given by its hi (bh0, bh1) and lo (bl0, bl1) parts as a
// split tile holds them. NF: b's tile may hold an inf or NaN, so its hi for
// the cross pass is 0 there (without NF, the caller knows that no inf or NaN
// reaches a or b, and takes split_finite's parts).
template <bool NF>
__device__ __forceinline__ void mma3(float (&c)[4], const Split (&a)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  const uint32_t small[4] = {a[0].small, a[1].small, a[2].small, a[3].small};
  const uint32_t big_c[4] = {a[0].big_c, a[1].big_c, a[2].big_c, a[3].big_c};
  const uint32_t big[4] = {a[0].big, a[1].big, a[2].big, a[3].big};
  const uint32_t bc0 = !NF || finite_bits(bh0) ? bh0 : 0u;
  const uint32_t bc1 = !NF || finite_bits(bh1) ? bh1 : 0u;
  mma_tf32(c, small, bc0, bc1);
  mma_tf32(c, big_c, bl0, bl1);
  mma_tf32(c, big, bh0, bh1);
}
