// Tensor-core and asynchronous-copy helpers shared by the port's kernels
// (sm_80 instructions, all present on sm_90a): 16-byte cp.async copies into
// shared memory with zero fill, ldmatrix, and the mma.sync shapes the
// kernels use. Each is one PTX instruction.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k*"): with
// g = lane / 4 and t = lane % 4, a thread's accumulator c0, c1 is row g,
// columns 2t and 2t + 1 of the 16 x 8 tile, and c2, c3 the same columns of
// row g + 8. For every input type the 16-byte column chunks of a 32-byte
// k-step are what ldmatrix hands out, so one address rule serves bf16
// (k16), int8 (k32) and f32 (8 elements):
//   A (16 rows x 32 bytes, row-major): ldmatrix_x4 with lane l addressing
//     row (l % 8) + 8 * ((l / 8) % 2), byte 16 * (l / 16);
//   B (8 columns x 32 bytes, stored as 8 rows, i.e. "col"): two n-tiles per
//     ldmatrix_x4, lane l addressing row (l % 8) + 8 * (l / 16), byte
//     16 * ((l / 8) % 2); registers 0, 1 are the first tile's b0, b1 and
//     2, 3 the second's.
//   B stored k-major (the attention's V, [key][d]): ldmatrix_x4_trans with
//     lane l addressing row (l % 8) + 8 * ((l / 8) % 2), column 8 * (l / 16).
// On f32 data the same rule hands thread (g, t) the elements t and t + 4 of
// each 8-element block of its rows (A: registers 0 and 2 for row g, 1 and 3
// for row g + 8; B: registers 0 and 1).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (0..16) from global `src` to shared `dst` and zero the rest
// of the 16 bytes; both addresses 16-byte aligned. With bytes == 0 nothing
// is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b, bf16 inputs, f32 accumulator (m16n8k16)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b, int8 inputs, exact int32 accumulator (m16n8k32)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a bf16 pair as one register: .x in the low half (the lower column)
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v.x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(v.y)) << 16);
}

// (x, y) rounded to bf16 and packed, x in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  return bits(__floats2bfloat162_rn(x, y));
}

// The f32 pair (x, y) as packed bf16 pieces hi = bf16(x), lo = bf16(x - hi)
// (x - hi is exact in f32), so hi + lo is x to about 2^-17 relative.
__device__ __forceinline__ void split2_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack_bf16(x - f.x, y - f.y);
}

// f32 bits rounded to bf16 precision (the top 16 bits), to nearest with ties
// away from zero, by integer add and mask: no conversion instruction
__device__ __forceinline__ uint32_t round_bf16_bits(uint32_t x) {
  return (x + 0x8000u) & 0xffff0000u;
}

// The f32 pair (x, y) (x in the low half) as three packed bf16 pieces with
// x == x0 + x1 + x2 exactly (each rounding takes the next 8 bits; the
// differences are exact in f32), and the same for y.
__device__ __forceinline__ void split3_bf16(uint32_t x, uint32_t y, uint32_t (&p)[3]) {
  const uint32_t x0 = round_bf16_bits(x), y0 = round_bf16_bits(y);
  const uint32_t x1r = __float_as_uint(__uint_as_float(x) - __uint_as_float(x0));
  const uint32_t y1r = __float_as_uint(__uint_as_float(y) - __uint_as_float(y0));
  const uint32_t x1 = round_bf16_bits(x1r), y1 = round_bf16_bits(y1r);
  const uint32_t x2 = __float_as_uint(__uint_as_float(x1r) - __uint_as_float(x1));
  const uint32_t y2 = __float_as_uint(__uint_as_float(y1r) - __uint_as_float(y1));
  p[0] = __byte_perm(x0, y0, 0x7632);  // the high halves: x low, y high
  p[1] = __byte_perm(x1, y1, 0x7632);
  p[2] = __byte_perm(x2, y2, 0x7632);  // x2, y2 have at most 8 bits: exact
}

}  // namespace mma
