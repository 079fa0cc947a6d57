// Int8 convolution for sm_90a that quantizes its floating-point input while
// loading it, sums in exact int32 and dequantizes in its epilogue: the
// port's kernel conv_int8.
//
// It has no Pallas counterpart. The JAX package runs every calibrated conv
// of its int8 extraction path as its input's quantize followed by XLA's
// lax.conv_general_dilated on int8 inputs with preferred_element_type=int32
// (daliid_tpu/ops/quantize.py: _quantize_sym :108-110, then
// make_quantized_interceptor :272-290), and XLA fuses the quantize into the
// convolution's producer. PyTorch has no CUDA int8 convolution, so the port
// writes both steps as one kernel:
//
//   q[b, h, w, c] = int8(clamp(rint(x[b, h, w, c] / s_in), -127, 127))
//   out[b, oh, ow, o] = cast(float(acc) * (s_in * s_w[o]) (+ bias[o]))
//   acc = sum over (r, s, c) of q[b, oh*sh - ph + r, ow*sw - pw + s, c] *
//                                 w[o, r, s, c]          (int32, exact)
//
// x is NHWC (a channels_last tensor) in bf16 or f32, or int8 already
// quantized (the checks' raw sums); out NHWC in f32, bf16 or the raw int32
// sum. No int8 copy of the input is written to device memory.
//
// The quantize gives the code of the plain version's quantize_sym and JAX's
// _quantize_sym: the f32 value of the input (bf16 to f32 is exact), the
// correctly rounded quotient by the f32 s_in, the clamp and the rounding
// half to even (__float2int_rn; clamping first is the same, the bounds being
// integers). A multiply by a reciprocal alone would not do: it can differ
// from the quotient by an ulp and flip a rounding. So quant_n screens: p =
// RN(v * RN(1/s_in)) lies within 2^-14 of the quotient's rounded value for
// |p| <= 200, and the code can change only at half-integers, so where no
// half-integer is within 2^-14 of p the code of p is the code of the
// quotient; the rest (about 1e-4 of uniform values, and every value planted
// on a half-way point) takes the true division __fdiv_rn. chip_smoke.py
// holds this against quantize_sym on every bf16 value and every f32 bit
// pattern. Taps in the padding read 0, which is quantize(0). The build has
// no --use_fast_math. The epilogue multiplies and adds with __fmul_rn /
// __fadd_rn, which nvcc cannot contract into an FMA (the plain version
// rounds twice).
//
// Exactness: |acc| <= K * 127^2; the largest K of the model zoo is
// ResNet-50's layer4 3x3 at C = 512, K = 4,608, so |acc| < 7.5e7 < 2^31 and
// the int32 sum is exact in any order. The kernel may therefore permute K,
// as long as A and B agree, and every output type equals the plain
// version's (daliid_tpu_torch/ops/conv_int8.py) bit for bit.
//
// Bound on the H100: the input once at its own size (2 bytes an element in
// bf16), the int8 weights, the scales and the output once each over 3.35
// TB/s, or 2 * M * O * K operations over the int8 tensor cores' 1,979 TOP/s,
// whichever is larger. Three routes, chosen from the geometry alone
// (plan_of; conv_int8_plan reports the choice):
//
//   groups == 1: an implicit GEMM on warpgroup MMA. M = B*Ho*Wo output
//     pixels by N = O channels by K = kh*kw*C4 in the order (r, s, c), C4 =
//     C or, for C % 8 != 0, C rounded up to 4. A block owns a BM x BN output
//     tile (BN 32, 64, 128 or 256, the smallest power of two that holds O;
//     BM 64 a consumer warpgroup) and walks K in stages of 128 bytes through
//     a ring of shared-memory stages. Its last warpgroup produces: each
//     thread fills one 16-byte chunk of every 16th row of the A stage, in
//     the 128-byte swizzle wgmma reads, and one thread brings the stage's B
//     tile by a TMA bulk copy from weights that the wrapper packed once into
//     that layout (pack_weights), zero past O and past K. Full and empty
//     mbarriers hand the stages over. Consumer warpgroups: 64 rows each,
//     wgmma.mma_async m64nBNk32 s8.s8.s32, both operands K-major from shared
//     memory, one group in flight. Epilogue: each value dequantized in the
//     registers that hold it, then exchanged by shuffles among the four
//     threads of a row into 16-byte NHWC stores. Two ways to fill A:
//     - staged (every groups == 1 convolution whose window fits, but a
//       strided 1x1): tiles of 128 pixels (64 where that window would not
//       fit) inside one image, 3 stages. For each tile of pixels the
//       producers stage the input rows its output pixels need in shared
//       memory, quantized (8-channel pieces, 8 loads in flight a thread, or
//       the C4 / 4 words of a pixel for the stems), zero-padded, and build
//       every A stage of every tile of channels from that window with 4-byte
//       shared-memory reads through a table of the K words' offsets. So each
//       input element is quantized once a tile of pixels, not once a tap and
//       once a tile of channels, and read from device memory in coalesced
//       loads, never gathered tap by tap.
//     - gathering (strided 1x1 convolutions, and those whose window would not
//       fit; C % 8 == 0): two consumer warpgroups, 4 stages; the producers
//       load the im2col rows from the float input as 8-channel pieces (one
//       16-byte load in bf16, two in f32, 8 bytes in int8; C % 8 == 0 keeps
//       a piece inside one tap), 8 loads in flight a thread, branch-free
//       (a piece in the padding loads the tensor's first bytes and is
//       masked to 0), and quantize them in registers.
//     Both are persistent: a block walks the tiles of pixels blockIdx.x, +
//     gridDim.x, ..., each through every tile of channels, and its
//     producers fill the next tile's stages while its consumers store the
//     last one. The products s_in * s_w and the biases sit in shared memory.
//   depthwise (groups == C == O, 3x3 or 5x5): a block stages the quantized
//     input window of a TH x TW output tile and 8*CG channels in shared
//     memory (8-channel pieces, element loads when C % 8 != 0); each thread
//     computes 4 neighbouring outputs of one row for 8 channels with its
//     kh*kw taps' weights in registers, one dp4a per product on a weight
//     word masked to one channel, and writes 16-byte stores.
//
// Other group counts and depthwise kernels are refused by the wrapper; the
// zoo has none.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>
#include <type_traits>

namespace {

constexpr int KS = 128;  // bytes of K in a stage: one 128-byte swizzled row per A or B row
constexpr int kMaxSmem = 232448;

// n / d for 0 <= n < 2^31 by a multiply-high and a shift ("division by
// invariant integers", the form of CUTLASS's FastDivmod; d >= 1, unset 1);
// d is fixed per launch, so the staging loops divide in two instructions
struct FastDiv {
  uint32_t mul, shr;
  __host__ void set(int d) {
    if (d <= 1) {
      mul = shr = 0;
      return;
    }
    int l = 0;
    while ((1ll << l) < d) ++l;  // ceil(log2(d))
    mul = (uint32_t)(((1ull << (31 + l)) + d - 1) / d);
    shr = l - 1;
  }
  __device__ __forceinline__ int div(int n) const {
    return mul == 0 ? n : (int)(__umulhi((uint32_t)n, mul) >> shr);
  }
};

struct Geometry {
  int B, H, W, C, O, kh, kw, sh, sw, ph, pw, Ho, Wo;
  FastDiv per_px;  // staged route: window pieces (8 channels, or a word) a pixel
  FastDiv cols;    // staged route: pixels a window row, W + 2 pw
  int C4;        // channels a tap holds in K: C, or C rounded up to 4 (staged route)
  int nks;       // stages of K: ceil(kh * kw * C4 / 128)
  int n_tiles;   // output channel tiles: ceil(O / BN)
  int m_tiles;   // tiles of output pixels
  int tiles_img; // staged route: tiles an image
  int pitch;     // staged route: bytes a window row, (W + 2 pw) * C4
  int nq;        // staged route: 4-byte words of K, kh * kw * C4 / 4
  int win_rows;  // staged route: most input rows a window holds
};

// ---------------------------------------------------------------- quantize
// s_in and r = RN(1 / s_in) (0 where RN(1 / s_in) is not a normal float:
// every value then takes the division)
struct Scale {
  float s, r;
};

// The int8 code of v, by definition: the true quotient, clamped, rounded
// half to even.
__device__ __forceinline__ int quant_exact(float v, float s) {
  return __float2int_rn(fminf(fmaxf(__fdiv_rn(v, s), -127.0f), 127.0f));
}

// 1.5 * 2^23: for |p| < 2^22, RN(p + kMagic) is kMagic + rint(p) (half to
// even), whose low byte is rint(p) as an int8 bit pattern; no conversion
// instruction (a quarter of the FP32 rate on Hopper) is needed
constexpr float kMagic = 12582912.0f;

// N codes, each equal to quant_exact, as ints whose low byte is the code.
// p = RN(v * r) is within |t| 2^-22.9 of t = v / s, and RN(t) within
// |t| 2^-24 of t, so for |p| <= 200 the two differ by less than 2^-14;
// rint(clamp(.)) changes only at half-integers, so where no half-integer
// lies within 2^-14 of p, the code of p is the code of RN(t). For |p| > 200
// both clamp to +-127. Only a value within 2^-14 of a half-integer (or
// r == 0) is undecided, and it alone takes the division. p - rint(p) is
// exact, and a non-finite v gives the same code on both paths.
template <int N>
__device__ __forceinline__ void quant_n(const float (&v)[N], Scale sc, int (&q)[N]) {
  uint32_t undecided = sc.r == 0.0f ? (1u << N) - 1 : 0u;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float p = __fmul_rn(v[e], sc.r);
    const float m = __fadd_rn(p, kMagic);
    const float d = __fsub_rn(p, __fsub_rn(m, kMagic));  // p - rint(p)
    if (fabsf(p) <= 200.0f && fabsf(d) >= 0.5f - 0x1p-14f) undecided |= 1u << e;
    q[e] = __float_as_int(fminf(fmaxf(m, kMagic - 127.0f), kMagic + 127.0f));
  }
  if (undecided) {
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (undecided >> e & 1u) q[e] = quant_exact(v[e], sc.s);
  }
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)d << 24);
}

__device__ __forceinline__ uint2 quant8(const float (&v)[8], Scale sc) {
  int q[8];
  quant_n<8>(v, sc, q);
  return make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ uint4 masked(uint4 v, uint32_t m) {
  return make_uint4(v.x & m, v.y & m, v.z & m, v.w & m);
}

// One input type: an 8-channel piece loaded raw (Raw, as bits; `zero`
// clears the bits of a piece that lies in the padding, so that a load never
// waits on a branch) and turned into two words of int8 codes; one element
// to a code (`one`).
template <typename T>
struct In;

template <>
struct In<int8_t> {
  using Raw = uint2;
  static __device__ __forceinline__ Raw load(const int8_t* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ Raw zero(Raw r, uint32_t m) {
    return make_uint2(r.x & m, r.y & m);
  }
  static __device__ __forceinline__ uint2 quant8(Raw r, Scale) { return r; }
  static __device__ __forceinline__ float value(int8_t v) { return (float)v; }
};

template <>
struct In<__nv_bfloat16> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Raw zero(Raw r, uint32_t m) { return masked(r, m); }
  static __device__ __forceinline__ uint2 quant8(Raw r, Scale sc) {
    const float v[8] = {bf16_lo(r.x), bf16_hi(r.x), bf16_lo(r.y), bf16_hi(r.y),
                        bf16_lo(r.z), bf16_hi(r.z), bf16_lo(r.w), bf16_hi(r.w)};
    return ::quant8(v, sc);
  }
  static __device__ __forceinline__ float value(__nv_bfloat16 v) { return __bfloat162float(v); }
};

template <>
struct In<float> {
  struct Raw {
    uint4 a, b;
  };
  static __device__ __forceinline__ Raw load(const float* p) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    return Raw{__ldg(q), __ldg(q + 1)};
  }
  static __device__ __forceinline__ Raw zero(Raw r, uint32_t m) {
    return Raw{masked(r.a, m), masked(r.b, m)};
  }
  static __device__ __forceinline__ uint2 quant8(Raw r, Scale sc) {
    const float v[8] = {__uint_as_float(r.a.x), __uint_as_float(r.a.y), __uint_as_float(r.a.z),
                        __uint_as_float(r.a.w), __uint_as_float(r.b.x), __uint_as_float(r.b.y),
                        __uint_as_float(r.b.z), __uint_as_float(r.b.w)};
    return ::quant8(v, sc);
  }
  static __device__ __forceinline__ float value(float v) { return v; }
};

// the codes of 4 values of an input type as one word (int8: the values)
template <typename T>
__device__ __forceinline__ uint32_t codes4(const float (&v)[4], Scale sc) {
  int q[4];
  if constexpr (std::is_same<T, int8_t>::value) {
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = (int)v[k];
  } else {
    quant_n<4>(v, sc, q);
  }
  return pack4(q[0], q[1], q[2], q[3]);
}

// the code of one element of any input type (int8 is already a code), as
// an int whose low byte is the code
template <typename T>
__device__ __forceinline__ int code(T v, Scale sc) {
  if constexpr (std::is_same<T, int8_t>::value) {
    return v;
  } else {
    const float f[1] = {In<T>::value(v)};
    int q[1];
    quant_n<1>(f, sc, q);
    return q[0];
  }
}

// ---------------------------------------------------------------- epilogue values
template <typename OutT>
__device__ __forceinline__ OutT finish(int acc, float scale, float b, bool has_bias) {
  if constexpr (std::is_same<OutT, int>::value) {
    return acc;
  } else {
    float v = __fmul_rn(__int2float_rn(acc), scale);
    if (has_bias) v = __fadd_rn(v, b);
    if constexpr (std::is_same<OutT, float>::value) {
      return v;
    } else {
      return __float2bfloat16_rn(v);
    }
  }
}

// ---------------------------------------------------------------- Hopper primitives
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the phase of parity `parity` to complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA bulk copy of `bytes` (a multiple of 16) from global to shared memory,
// completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :
      : "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the threads' shared-memory stores become visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving uses of an accumulator register across the
// asynchronous wgmma that writes it
__device__ __forceinline__ void fence_operand(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// shared-memory matrix descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle (chunk c of row n at n * 128 + ((c ^ (n % 8)) * 16) from
// a 1024-byte aligned base): start address, leading byte offset 1 (unused
// in this mode), stride 1024 bytes between groups of 8 rows, layout 1
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ uint32_t swizzle(int row, int chunk) {
  return (uint32_t)(row * KS + ((chunk ^ (row & 7)) << 4));
}

// wgmma.mma_async m64nNk32, s8 x s8 -> s32, A and B from shared memory;
// d[4j + 2h + e] is row 16 * warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, "
        "%17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, "
        "p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, "
        "p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
          "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
          "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(int (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
          "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
          "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
          "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
          "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
          "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
          "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
          "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
          "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
          "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
          "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
};

// ---------------------------------------------------------------- implicit GEMM
template <bool STAGED, int NWG_>
struct Tile {
  static constexpr int NWG = NWG_;  // consumer warpgroups of 64 rows
  static constexpr int BM = 64 * NWG;
  static constexpr int STAGES = STAGED ? 3 : 4;
  static constexpr int THREADS = 128 * (NWG + 1);  // the last warpgroup produces
};

__device__ __forceinline__ uint32_t bits(int v) { return (uint32_t)v; }
__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// One consumer warpgroup's 64 x BN tile, written from its registers. Each
// value is dequantized where it lies, by the products s_in * s_w and the
// biases the block keeps in shared memory (thread (warp, lane) holds rows
// 16 warp + lane / 4 (+ 8) and columns 8j + 2 (lane % 4) (+ 1)); then the
// four threads of a row exchange values by shuffles so that each store
// writes 16 consecutive bytes of one NHWC row. Tile row r is output pixel
// m_base + row0 + r, valid below m_count; columns start at channel n0.
template <typename OutT, int BN>
__device__ __forceinline__ void store_tile(const int (&acc)[BN / 2], int row0, int m_base,
                                           int m_count, int n0, const Geometry& g,
                                           const float* scale, const float* shift,
                                           bool has_bias, OutT* __restrict__ out) {
  const int lane = threadIdx.x & 31, q = lane & 3, quad = lane & ~3;
  const int r0 = row0 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  constexpr int JG = sizeof(OutT) == 2 ? 4 : 2;  // column groups of 8 a 16-byte store spans
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += JG) {
    float sc[JG][2], bb[JG][2];
#pragma unroll
    for (int k = 0; k < JG; ++k)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = n0 + 8 * (j0 + k) + 2 * q + e;
        sc[k][e] = bb[k][e] = 0.0f;
        if (!std::is_same<OutT, int>::value && o < g.O) {
          sc[k][e] = scale[o];
          bb[k][e] = shift[o];
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      uint32_t v[4];
      int o0;
      if constexpr (sizeof(OutT) == 2) {
        // a[k]: this thread's pair of group j0 + k; v[k]: thread k's pair of group j0 + q
        uint32_t a[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int* d = acc + 4 * (j0 + k) + 2 * h;
          a[k] = bits(finish<OutT>(d[0], sc[k][0], bb[k][0], has_bias),
                      finish<OutT>(d[1], sc[k][1], bb[k][1], has_bias));
        }
        v[0] = v[1] = v[2] = v[3] = a[q];
#pragma unroll
        for (int r = 1; r < 4; ++r) {
          const int src = (q - r) & 3;
          const uint32_t got = __shfl_sync(0xffffffffu, pick4(a, (q + r) & 3), quad | src);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k == src) v[k] = got;
        }
        o0 = n0 + 8 * (j0 + q);
      } else {
        // threads 2p and 2p + 1 pool their pairs: the even one stores group
        // j0, the odd one group j0 + 1, 4 columns each
        const int* d0 = acc + 4 * j0 + 2 * h;
        const int* d1 = acc + 4 * (j0 + 1) + 2 * h;
        const uint32_t p0[2] = {bits(finish<OutT>(d0[0], sc[0][0], bb[0][0], has_bias)),
                                bits(finish<OutT>(d0[1], sc[0][1], bb[0][1], has_bias))};
        const uint32_t p1[2] = {bits(finish<OutT>(d1[0], sc[1][0], bb[1][0], has_bias)),
                                bits(finish<OutT>(d1[1], sc[1][1], bb[1][1], has_bias))};
        const bool odd = q & 1;
        const uint32_t g0 = __shfl_xor_sync(0xffffffffu, odd ? p0[0] : p1[0], 1);
        const uint32_t g1 = __shfl_xor_sync(0xffffffffu, odd ? p0[1] : p1[1], 1);
        if (odd) {
          v[0] = g0, v[1] = g1, v[2] = p1[0], v[3] = p1[1];
          o0 = n0 + 8 * (j0 + 1) + 2 * (q - 1);
        } else {
          v[0] = p0[0], v[1] = p0[1], v[2] = g0, v[3] = g1;
          o0 = n0 + 8 * j0 + 2 * q;
        }
      }
      if (row >= m_count || o0 >= g.O) continue;
      OutT* dst = out + (size_t)(m_base + row) * g.O + o0;
      constexpr int VEC = 16 / sizeof(OutT);
      if (g.O % VEC == 0) {  // o0 + VEC <= O, 16-byte aligned
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          if (o0 + e >= g.O) break;
          const uint32_t word = v[e * sizeof(OutT) / 4];
          if constexpr (sizeof(OutT) == 2) {
            dst[e] = __ushort_as_bfloat16((unsigned short)(word >> (16 * (e & 1))));
          } else {
            dst[e] = *reinterpret_cast<const OutT*>(&word);
          }
        }
      }
    }
  }
}

// groups == 1. STAGED: A stages built from the quantized input window in
// shared memory, which the producers stage for each tile of pixels; else
// gathered from the input in 8-channel pieces. Persistent: a block walks
// the pixel tiles blockIdx.x, + gridDim.x, ..., each through every channel
// tile, and its producers fill the next tile's stages while its consumers
// store the last one. Two blocks an SM while the accumulators are small (at
// most 80 registers a thread with three warpgroups: BN <= 64; 128 with two:
// BN <= 128).
template <typename InT, int BN, bool STAGED, int NWG>
__global__ void __launch_bounds__(Tile<STAGED, NWG>::THREADS,
                                  BN <= (NWG == 1 ? 128 : 64) ? 2 : 1)
    conv_wgmma(const InT* __restrict__ x, const int8_t* __restrict__ wp, Geometry g, Scale sc,
               const float* __restrict__ s_w, const float* __restrict__ bias, void* out,
               int out_kind) {
  using T = Tile<STAGED, NWG>;
  constexpr int BM = T::BM, STAGES = T::STAGES;
  constexpr int A_BYTES = BM * KS, B_BYTES = BN * KS, STAGE_BYTES = A_BYTES + B_BYTES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the swizzle repeats every 1024 bytes: the ring starts on such a boundary
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  // per A row its pixel's geometry (two tiles' worth on the gathering route)
  int4* rows = reinterpret_cast<int4*>(empty + STAGES);
  int* words = reinterpret_cast<int*>(rows + 2 * BM);  // staged: K word -> window offset
  // s_in * s_w[o] and bias[o] (0 without one) for every output channel
  float* scale = reinterpret_cast<float*>(words + ((g.nq + 3) & ~3));
  float* shift = scale + ((g.O + 3) & ~3);
  uint8_t* window = reinterpret_cast<uint8_t*>(shift + ((g.O + 3) & ~3));

  const int tid = threadIdx.x, wg = tid >> 7;
  const int howo = g.Ho * g.Wo;
  // the pixel tile's first output pixel and its valid rows
  auto tile_rows = [&](int mt, int& m_base, int& m_count) {
    if constexpr (STAGED) {
      const int b = mt / g.tiles_img, p0 = (mt - b * g.tiles_img) * BM;
      m_base = b * howo + p0;
      m_count = min(BM, howo - p0);
    } else {
      m_base = mt * BM;
      m_count = min(BM, g.B * howo - m_base);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 128 + 1);  // the producers and the bulk copy's expect_tx
      mbar_init(&empty[s], 128 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int o = tid; o < g.O; o += T::THREADS) {
    if (out_kind != 0) scale[o] = __fmul_rn(sc.s, s_w[o]);
    shift[o] = bias != nullptr ? bias[o] : 0.0f;
  }
  if constexpr (STAGED) {  // K word -> window offset, the same for every tile
    for (int q = tid; q < g.nq; q += T::THREADS) {
      const int k = 4 * q, tap = k / g.C4, c = k - tap * g.C4;
      const int r = tap / g.kw, s = tap - r * g.kw;
      words[q] = r * g.pitch + s * g.C4 + c;
    }
  }
  __syncthreads();

  if (wg == NWG) {
    // ------------------------------------------------ producer warpgroup
    // thread pt fills 16-byte chunk ch of rows rb, rb + 16, ... of each stage
    const int pt = tid & 127, ch = pt & 7, rb = pt >> 3;
    int it = 0, local = 0;
    for (int mt = blockIdx.x; mt < g.m_tiles; mt += gridDim.x, ++local) {
      int m_base, m_count;
      tile_rows(mt, m_base, m_count);
      const int4* rt = rows;
      if constexpr (STAGED) {
        // the window: the input rows from oh_a * sh - ph that the tile's
        // output rows need, every column of the padded width, quantized once;
        // first every producer is done with the last tile's window
        named_barrier(1, 128);
        const int b_img = m_base / howo, p0 = m_base - b_img * howo, oh_a = p0 / g.Wo;
        for (int r = pt; r < BM; r += 128) {
          int4 e = make_int4(0, 0, 0, 0);
          if (r < m_count) {
            const int oh = (p0 + r) / g.Wo, ow = p0 + r - oh * g.Wo;
            e = make_int4((oh - oh_a) * g.sh * g.pitch + ow * g.sw * g.C4, 0, 0, 1);
          }
          rows[r] = e;
        }
        const int oh_b = (p0 + m_count - 1) / g.Wo;
        const int rows_in = (oh_b - oh_a) * g.sh + g.kh, cols = g.W + 2 * g.pw;
        const int ih_s = oh_a * g.sh - g.ph;
        const InT* img = x + (size_t)b_img * g.H * g.W * g.C;
        if (g.C % 8 == 0) {  // 8-channel pieces, NF in flight a thread
          constexpr int NF = sizeof(InT) == 4 ? 4 : 8;
          const int pieces = g.C / 8, n = rows_in * cols * pieces;
          for (int e0 = pt; e0 < n; e0 += NF * 128) {
            typename In<InT>::Raw raw[NF];
            int at[NF];
#pragma unroll
            for (int j = 0; j < NF; ++j) {
              const int e = min(e0 + j * 128, n - 1);
              const int pix = g.per_px.div(e), v = e - pix * pieces;
              const int wr = g.cols.div(pix), wc = pix - wr * cols;
              const int ih = ih_s + wr, iw = wc - g.pw;
              const bool in = ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
              raw[j] = In<InT>::zero(
                  In<InT>::load(in ? img + ((size_t)ih * g.W + iw) * g.C + 8 * v : img),
                  in ? ~0u : 0u);
              at[j] = wr * g.pitch + wc * g.C4 + 8 * v;
            }
#pragma unroll
            for (int j = 0; j < NF; ++j)
              if (e0 + j * 128 < n)
                *reinterpret_cast<uint2*>(window + at[j]) = In<InT>::quant8(raw[j], sc);
          }
        } else {  // the stems: each pixel's C channels as C4 / 4 words, 8 in flight
          const int words_px = g.C4 / 4, n = rows_in * cols * words_px;
          for (int e0 = pt; e0 < n; e0 += 8 * 128) {
            float v[8][4];
            int at[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int e = min(e0 + j * 128, n - 1);
              const int pix = g.per_px.div(e), w4 = 4 * (e - pix * words_px);
              const int wr = g.cols.div(pix), wc = pix - wr * cols;
              const int ih = ih_s + wr, iw = wc - g.pw;
              const bool in = ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
              const InT* px = img + (in ? ((size_t)ih * g.W + iw) * g.C : 0);
#pragma unroll
              for (int k = 0; k < 4; ++k)
                v[j][k] = (in && w4 + k < g.C) ? In<InT>::value(px[w4 + k]) : 0.0f;
              at[j] = wr * g.pitch + wc * g.C4 + w4;
            }
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (e0 + j * 128 < n)
                *reinterpret_cast<uint32_t*>(window + at[j]) = codes4<InT>(v[j], sc);
          }
        }
        named_barrier(1, 128);  // the window and the rows are in place
      } else {
        // the rows' geometry (image offset, first input row and column,
        // valid), one row a thread, into the buffer the last tile did not use
        int4* fill = rows + (local & 1) * BM;
        int4 e = make_int4(0, 0, 0, 0);
        if (pt < m_count) {
          const int m = m_base + pt, b = m / howo, p = m - b * howo;
          const int oh = p / g.Wo, ow = p - oh * g.Wo;
          e = make_int4(b * g.H * g.W, oh * g.sh - g.ph, ow * g.sw - g.pw, 1);
        }
        fill[pt] = e;
        named_barrier(1, 128);
        rt = fill;
      }
      for (int nt = 0; nt < g.n_tiles; ++nt) {
        // gathering route: the tap (r, s) and channel c of the two 8-channel
        // pieces of the thread's chunk, advanced by 128 K a stage
        int tr[2] = {0, 0}, ts[2] = {0, 0}, tc[2] = {0, 0};
        if constexpr (!STAGED) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int k = ch * 16 + u * 8, rs = k / g.C;
            tc[u] = k - rs * g.C;
            tr[u] = rs / g.kw;
            ts[u] = rs - tr[u] * g.kw;
          }
        }
        for (int ks = 0; ks < g.nks; ++ks, ++it) {
          const int st = it % STAGES;
          mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
          uint8_t* A = ring + st * STAGE_BYTES;
          if (pt == 0) {
            mbar_expect_tx(&full[st], B_BYTES);
            bulk_copy(A + A_BYTES, wp + ((size_t)nt * g.nks + ks) * B_BYTES, B_BYTES, &full[st]);
          }
          if constexpr (STAGED) {
            int off[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int q = ks * (KS / 4) + ch * 4 + j;
              off[j] = q < g.nq ? words[q] : -1;
            }
#pragma unroll
            for (int i = 0; i < BM / 16; ++i) {
              const int row = rb + 16 * i;
              const int4 e = rt[row];
              uint32_t v[4];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                v[j] = (e.w && off[j] >= 0)
                           ? *reinterpret_cast<const uint32_t*>(window + e.x + off[j])
                           : 0u;
              *reinterpret_cast<uint4*>(A + swizzle(row, ch)) = make_uint4(v[0], v[1], v[2], v[3]);
            }
          } else {
            constexpr int RB = 4;  // rows whose loads fly together
#pragma unroll
            for (int i0 = 0; i0 < BM / 16; i0 += RB) {
              typename In<InT>::Raw raw[RB][2];
#pragma unroll
              for (int i = 0; i < RB; ++i) {
                const int4 e = rt[rb + 16 * (i0 + i)];
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                  const int ih = e.y + tr[u], iw = e.z + ts[u];
                  const bool in = e.w && tr[u] < g.kh && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
                  raw[i][u] = In<InT>::zero(
                      In<InT>::load(in ? x + ((size_t)e.x + (size_t)ih * g.W + iw) * g.C + tc[u]
                                       : x),
                      in ? ~0u : 0u);
                }
              }
#pragma unroll
              for (int i = 0; i < RB; ++i) {
                const uint2 lo = In<InT>::quant8(raw[i][0], sc);
                const uint2 hi = In<InT>::quant8(raw[i][1], sc);
                *reinterpret_cast<uint4*>(A + swizzle(rb + 16 * (i0 + i), ch)) =
                    make_uint4(lo.x, lo.y, hi.x, hi.y);
              }
            }
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              tc[u] += KS % g.C;
              ts[u] += KS / g.C;
              if (tc[u] >= g.C) {
                tc[u] -= g.C;
                ++ts[u];
              }
              while (ts[u] >= g.kw) {
                ts[u] -= g.kw;
                ++tr[u];
              }
            }
          }
          fence_async_shared();
          mbar_arrive(&full[st]);
        }
      }
    }
    return;
  }

  // -------------------------------------------------- consumer warpgroups
  int it = 0;
  for (int mt = blockIdx.x; mt < g.m_tiles; mt += gridDim.x) {
    int m_base, m_count;
    tile_rows(mt, m_base, m_count);
    for (int nt = 0; nt < g.n_tiles; ++nt) {
      int acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      for (int ks = 0; ks < g.nks; ++ks, ++it) {
        const int st = it % STAGES;
        mbar_wait(&full[st], (it / STAGES) & 1);
        const uint64_t da = sw128_desc(smem_u32(ring + st * STAGE_BYTES) + wg * 64 * KS);
        const uint64_t db = sw128_desc(smem_u32(ring + st * STAGE_BYTES + A_BYTES));
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS / 32; ++kk) Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
        wgmma_wait<1>();  // the previous stage's products are done: hand it back
        if (ks > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
      mbar_arrive(&empty[(it - 1) % STAGES]);
      const int n0 = nt * BN;
      if (out_kind == 0) {
        store_tile<int, BN>(acc, wg * 64, m_base, m_count, n0, g, scale, shift,
                            bias != nullptr, static_cast<int*>(out));
      } else if (out_kind == 1) {
        store_tile<float, BN>(acc, wg * 64, m_base, m_count, n0, g, scale, shift,
                              bias != nullptr, static_cast<float*>(out));
      } else {
        store_tile<__nv_bfloat16, BN>(acc, wg * 64, m_base, m_count, n0, g, scale, shift,
                                      bias != nullptr, static_cast<__nv_bfloat16*>(out));
      }
    }
  }
}

// ---------------------------------------------------------------- depthwise
struct DwTile {
  int TH, TW, CG, CB, tiles_h, tiles_w, WR, WC, WCp, Opad;
};

template <typename OutT>
__device__ __forceinline__ void dw_store(OutT* __restrict__ dst, const int (&a)[8], int c0,
                                         const Geometry& g, float s_in,
                                         const float* __restrict__ s_w,
                                         const float* __restrict__ bias) {
  OutT v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float sc = 0.0f, bb = 0.0f;
    if (!std::is_same<OutT, int>::value && c0 + e < g.C) {
      sc = __fmul_rn(s_in, s_w[c0 + e]);
      if (bias != nullptr) bb = bias[c0 + e];
    }
    v[e] = finish<OutT>(a[e], sc, bb, bias != nullptr);
  }
  if (g.C % 8 == 0) {  // c0 + 8 <= C, 16-byte aligned
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    if constexpr (sizeof(OutT) == 4) {
      d4[0] = make_uint4(bits(v[0]), bits(v[1]), bits(v[2]), bits(v[3]));
      d4[1] = make_uint4(bits(v[4]), bits(v[5]), bits(v[6]), bits(v[7]));
    } else {
      d4[0] = make_uint4(bits(v[0], v[1]), bits(v[2], v[3]), bits(v[4], v[5]), bits(v[6], v[7]));
    }
  } else {
    for (int e = 0; e < 8 && c0 + e < g.C; ++e) dst[e] = v[e];
  }
}

// Depthwise (groups == C == O), KH x KW taps, column stride SW: the block's
// input window (WR x WC pixels of CB channels, quantized, rows of WCp
// pixels) in shared memory; thread (cg, strip) sums 4 neighbouring outputs
// of one output row for channels c0 .. c0 + 7.
template <typename InT, int KH, int KW, int SW>
__global__ void __launch_bounds__(256)
    conv_dw(const InT* __restrict__ x, const int8_t* __restrict__ wt, Geometry g, DwTile d,
            Scale sc, const float* __restrict__ s_w, const float* __restrict__ bias, void* out,
            int out_kind) {
  extern __shared__ __align__(16) uint8_t win[];
  constexpr int NX = 3 * SW + KW;                    // window columns of a thread's 4 outputs
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int tiles = d.tiles_h * d.tiles_w;
  const int b = blockIdx.x / tiles, rem = blockIdx.x - b * tiles;
  const int th0 = (rem / d.tiles_w) * d.TH, tw0 = (rem % d.tiles_w) * d.TW;
  const int cb0 = blockIdx.y * d.CB;
  const int ih0 = th0 * g.sh - g.ph, iw0 = tw0 * SW - g.pw;
  const InT* img = x + (size_t)b * g.H * g.W * g.C;
  if (g.C % 8 == 0) {  // 8-channel pieces, 4 loads in flight a thread
    const int pieces = d.CB / 8, total = d.WR * d.WC * pieces;
    for (int e0 = tid; e0 < total; e0 += 4 * nthreads) {
      typename In<InT>::Raw raw[4];
      int at[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = min(e0 + j * nthreads, total - 1);
        const int v = e % pieces, pix = e / pieces;
        const int wr = pix / d.WC, wc = pix - wr * d.WC;
        const int ih = ih0 + wr, iw = iw0 + wc, c = cb0 + 8 * v;
        const bool in = ih >= 0 && ih < g.H && iw >= 0 && iw < g.W && c < g.C;
        raw[j] = In<InT>::zero(In<InT>::load(in ? img + ((size_t)ih * g.W + iw) * g.C + c : img),
                               in ? ~0u : 0u);
        at[j] = (wr * d.WCp + wc) * d.CB + 8 * v;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e0 + j * nthreads < total)
          *reinterpret_cast<uint2*>(win + at[j]) = In<InT>::quant8(raw[j], sc);
    }
  } else {  // C not a multiple of 8: element loads
    for (int e = tid; e < d.WR * d.WC * d.CB; e += nthreads) {
      const int cc = e % d.CB, pix = e / d.CB;
      const int wr = pix / d.WC, wc = pix - wr * d.WC;
      const int ih = ih0 + wr, iw = iw0 + wc, c = cb0 + cc;
      int q = 0;
      if (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W && c < g.C)
        q = code(img[((size_t)ih * g.W + iw) * g.C + c], sc);
      win[(wr * d.WCp + wc) * d.CB + cc] = (uint8_t)q;
    }
  }
  __syncthreads();

  const int cg = tid % d.CG, strip = tid / d.CG;
  const int row = strip % d.TH, seg = strip / d.TH;
  const int c0 = cb0 + 8 * cg, oh = th0 + row, ow0 = tw0 + 4 * seg;
  if (c0 >= g.C || oh >= g.Ho || ow0 >= g.Wo) return;
  // the 8 channels' taps, 4 channels a word (the wrapper pads O to 8)
  uint32_t w[KH * KW][2];
#pragma unroll
  for (int t = 0; t < KH * KW; ++t) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(wt + (size_t)t * d.Opad + c0));
    w[t][0] = v.x;
    w[t][1] = v.y;
  }
  int acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0;
#pragma unroll
  for (int r = 0; r < KH; ++r) {
    const uint8_t* src = win + ((row * g.sh + r) * d.WCp + 4 * SW * seg) * d.CB + 8 * cg;
    uint2 xv[NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) xv[j] = *reinterpret_cast<const uint2*>(src + j * d.CB);
#pragma unroll
    for (int s = 0; s < KW; ++s) {
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        // the weight word masked to one channel: dp4a adds that channel's product alone
        const int m0 = (int)(w[r * KW + s][0] & (0xffu << (8 * ch)));
        const int m1 = (int)(w[r * KW + s][1] & (0xffu << (8 * ch)));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][ch] = __dp4a((int)xv[SW * i + s].x, m0, acc[i][ch]);
          acc[i][4 + ch] = __dp4a((int)xv[SW * i + s].y, m1, acc[i][4 + ch]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ow = ow0 + i;
    if (ow >= g.Wo) break;
    const size_t at = (((size_t)b * g.Ho + oh) * g.Wo + ow) * g.O + c0;
    if (out_kind == 0) {
      dw_store(static_cast<int*>(out) + at, acc[i], c0, g, sc.s, s_w, bias);
    } else if (out_kind == 1) {
      dw_store(static_cast<float*>(out) + at, acc[i], c0, g, sc.s, s_w, bias);
    } else {
      dw_store(static_cast<__nv_bfloat16*>(out) + at, acc[i], c0, g, sc.s, s_w, bias);
    }
  }
}

// ---------------------------------------------------------------- launch
// dynamic shared memory of a block; sets the geometry's tile counts and, on
// the staged route, the window's rows
template <int BN, bool STAGED, int NWG>
size_t gemm_smem(Geometry& g) {
  using T = Tile<STAGED, NWG>;
  const int howo = g.Ho * g.Wo;
  g.n_tiles = (g.O + BN - 1) / BN;
  size_t smem = 1024 + (size_t)T::STAGES * (T::BM + BN) * KS + 16 * T::STAGES + 32 * T::BM +
                8 * (size_t)((g.O + 3) & ~3);
  if (!STAGED) smem += 4 * (size_t)((g.nq + 3) & ~3);  // the words' room, unused
  if (STAGED) {
    g.tiles_img = (howo + T::BM - 1) / T::BM;
    int span = 1;  // most output rows a tile touches
    for (int p0 = 0; p0 < howo; p0 += T::BM)
      span = std::max(span, (std::min(p0 + T::BM, howo) - 1) / g.Wo - p0 / g.Wo + 1);
    g.win_rows = (span - 1) * g.sh + g.kh;
    smem += 4 * (size_t)((g.nq + 3) & ~3) + (size_t)g.win_rows * g.pitch;
  }
  return smem;
}

template <typename InT, int BN, bool STAGED, int NWG>
cudaError_t launch_gemm(const InT* x, const int8_t* wp, Geometry g, Scale sc, const float* s_w,
                        const float* bias, void* out, int out_kind, cudaStream_t stream) {
  using T = Tile<STAGED, NWG>;
  const size_t smem = gemm_smem<BN, STAGED, NWG>(g);
  const long long m_tiles = STAGED ? (long long)g.B * g.tiles_img
                                   : ((long long)g.B * g.Ho * g.Wo + T::BM - 1) / T::BM;
  if (smem > (size_t)kMaxSmem || m_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  g.m_tiles = (int)m_tiles;
  auto kernel = conv_wgmma<InT, BN, STAGED, NWG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // persistent: as many blocks as the SMs hold at once, each walking pixel tiles
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T::THREADS, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = std::min(m_tiles, (long long)sms * std::max(per_sm, 1));
  kernel<<<(unsigned)blocks, T::THREADS, smem, stream>>>(x, wp, g, sc, s_w, bias, out,
                                                          out_kind);
  return cudaGetLastError();
}

// groups == 1: the block a launch takes, decided from its geometry alone:
// the staged window where it fits with two consumer warpgroups, else with
// one, but for a strided 1x1 (its window would hold the rows and columns it
// skips); else the gathering route, which needs C % 8 == 0
enum Plan { kRefused = -1, kGather = 0, kStaged2 = 1, kStaged1 = 2, kDepthwise = 3 };

template <int BN>
int gemm_plan(const Geometry& g) {
  const bool c8 = g.C % 8 == 0;
  const bool strided_1x1 = g.kh == 1 && g.kw == 1 && (g.sh != 1 || g.sw != 1);
  if (!c8 || !strided_1x1) {
    Geometry t = g;
    if (gemm_smem<BN, true, 2>(t) <= (size_t)kMaxSmem) return kStaged2;
    t = g;
    if (gemm_smem<BN, true, 1>(t) <= (size_t)kMaxSmem) return kStaged1;
  }
  return c8 ? kGather : kRefused;
}

int plan_of(const Geometry& g, int groups, int bn) {
  if (groups != 1)
    return (g.kh == g.kw && (g.kh == 3 || g.kh == 5) && (g.sw == 1 || g.sw == 2)) ? kDepthwise
                                                                                  : kRefused;
  switch (bn) {
    case 32:
      return gemm_plan<32>(g);
    case 64:
      return gemm_plan<64>(g);
    case 128:
      return gemm_plan<128>(g);
    case 256:
      return gemm_plan<256>(g);
    default:
      return kRefused;
  }
}

template <typename InT, int BN>
cudaError_t launch_bn(const InT* x, const int8_t* wp, const Geometry& g, Scale sc,
                      const float* s_w, const float* bias, void* out, int out_kind,
                      cudaStream_t s) {
  switch (gemm_plan<BN>(g)) {
    case kStaged2:
      return launch_gemm<InT, BN, true, 2>(x, wp, g, sc, s_w, bias, out, out_kind, s);
    case kStaged1:
      return launch_gemm<InT, BN, true, 1>(x, wp, g, sc, s_w, bias, out, out_kind, s);
    case kGather:
      return launch_gemm<InT, BN, false, 2>(x, wp, g, sc, s_w, bias, out, out_kind, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename InT, int KH, int KW, int SW>
cudaError_t launch_dw(const InT* x, const int8_t* wt, const Geometry& g, Scale sc,
                      const float* s_w, const float* bias, void* out, int out_kind,
                      cudaStream_t stream) {
  DwTile d;
  const int segw = g.Wo > 8 ? 4 : (g.Wo > 4 ? 2 : 1);  // 4-output segments of a tile row
  d.TW = 4 * segw;
  d.TH = 1;
  while (d.TH < g.Ho && d.TH * segw < 64) d.TH *= 2;
  const int strips = d.TH * segw;
  d.CG = std::min(256 / strips, (g.C + 7) / 8);
  d.CB = 8 * d.CG;
  d.tiles_h = (g.Ho + d.TH - 1) / d.TH;
  d.tiles_w = (g.Wo + d.TW - 1) / d.TW;
  d.WR = (d.TH - 1) * g.sh + KH;
  d.WC = (d.TW - 1) * SW + KW;
  d.WCp = d.WC | 1;  // an odd pitch: neighbouring rows' words fall on other banks
  d.Opad = (g.O + 7) / 8 * 8;
  const size_t smem = (size_t)d.WR * d.WCp * d.CB;
  const long long blocks = (long long)g.B * d.tiles_h * d.tiles_w;
  if (smem > (size_t)kMaxSmem || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = conv_dw<InT, KH, KW, SW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)blocks, (unsigned)((g.C + d.CB - 1) / d.CB));
  kernel<<<grid, d.CG * strips, smem, stream>>>(x, wt, g, d, sc, s_w, bias, out, out_kind);
  return cudaGetLastError();
}

template <typename InT>
cudaError_t run(const InT* x, const int8_t* w, const Geometry& g, int groups, int bn, Scale sc,
                const float* s_w, const float* bias, void* out, int out_kind, cudaStream_t s) {
  if (groups != 1) {
    if (g.kh == 3 && g.kw == 3 && g.sw == 1)
      return launch_dw<InT, 3, 3, 1>(x, w, g, sc, s_w, bias, out, out_kind, s);
    if (g.kh == 3 && g.kw == 3 && g.sw == 2)
      return launch_dw<InT, 3, 3, 2>(x, w, g, sc, s_w, bias, out, out_kind, s);
    if (g.kh == 5 && g.kw == 5 && g.sw == 1)
      return launch_dw<InT, 5, 5, 1>(x, w, g, sc, s_w, bias, out, out_kind, s);
    if (g.kh == 5 && g.kw == 5 && g.sw == 2)
      return launch_dw<InT, 5, 5, 2>(x, w, g, sc, s_w, bias, out, out_kind, s);
    return cudaErrorInvalidValue;
  }
  switch (bn) {
    case 32:
      return launch_bn<InT, 32>(x, w, g, sc, s_w, bias, out, out_kind, s);
    case 64:
      return launch_bn<InT, 64>(x, w, g, sc, s_w, bias, out, out_kind, s);
    case 128:
      return launch_bn<InT, 128>(x, w, g, sc, s_w, bias, out, out_kind, s);
    case 256:
      return launch_bn<InT, 256>(x, w, g, sc, s_w, bias, out, out_kind, s);
    default:
      return cudaErrorInvalidValue;
  }
}

Geometry make_geometry(int B, int H, int W, int C, int O, int kh, int kw, int sh, int sw, int ph,
                       int pw, int groups) {
  Geometry g{};
  g.B = B;
  g.H = H;
  g.W = W;
  g.C = C;
  g.O = O;
  g.kh = kh;
  g.kw = kw;
  g.sh = sh;
  g.sw = sw;
  g.ph = ph;
  g.pw = pw;
  g.Ho = (H + 2 * ph - kh) / sh + 1;
  g.Wo = (W + 2 * pw - kw) / sw + 1;
  // groups == 1 with C % 8 != 0: each tap's channels padded to 4 (pack_weights)
  g.C4 = groups == 1 && C % 8 != 0 ? (C + 3) / 4 * 4 : C / groups;
  const int K = kh * kw * g.C4;
  g.nks = (K + KS - 1) / KS;
  g.nq = K / 4;
  g.pitch = (W + 2 * pw) * g.C4;
  if (groups == 1) {  // the staged window's divisors
    g.per_px.set(C % 8 == 0 ? C / 8 : g.C4 / 4);
    g.cols.set(W + 2 * pw);
  }
  return g;
}

}  // namespace

// Launch on `stream`. x: (B, H, W, C) of in_kind 0 = int8 (already
// quantized), 1 = bf16, 2 = f32, 16-byte aligned; w: the weights as
// ops/conv_int8.py's pack_weights lays them out for groups and bn, the output
// channels of a tile; s_w: f32 (O,); bias: f32 (O,) or null; out:
// (B, Ho, Wo, O) of out_kind 0 = int32 (the raw sum; s_w and bias unread),
// 1 = f32, 2 = bf16. groups is 1 or C == O (depthwise). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a geometry the kernels do
// not take (conv_int8_plan says which).
extern "C" int conv_int8(const void* x, int in_kind, const void* w, const void* s_w,
                         const void* bias, void* out, int B, int H, int W, int C, int O, int kh,
                         int kw, int sh, int sw, int ph, int pw, int groups, int bn, float s_in,
                         int out_kind, void* stream) {
  const Geometry g = make_geometry(B, H, W, C, O, kh, kw, sh, sw, ph, pw, groups);
  // the screen's reciprocal, correctly rounded on the host
  const float r = 1.0f / s_in;
  const Scale sc{s_in, std::isnormal(r) ? r : 0.0f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wi = static_cast<const int8_t*>(w);
  const float* sw_f = static_cast<const float*>(s_w);
  const float* b_f = static_cast<const float*>(bias);
  cudaError_t err;
  if (in_kind == 0) {
    err = run(static_cast<const int8_t*>(x), wi, g, groups, bn, sc, sw_f, b_f, out, out_kind, s);
  } else if (in_kind == 1) {
    err = run(static_cast<const __nv_bfloat16*>(x), wi, g, groups, bn, sc, sw_f, b_f, out,
              out_kind, s);
  } else {
    err = run(static_cast<const float*>(x), wi, g, groups, bn, sc, sw_f, b_f, out, out_kind, s);
  }
  return (int)err;
}

// The block conv_int8 takes for this geometry (host only, nothing
// launched): 0 the gathering route, 1 the staged window with 128-pixel
// tiles, 2 with 64-pixel tiles, 3 depthwise, -1 refused.
extern "C" int conv_int8_plan(int B, int H, int W, int C, int O, int kh, int kw, int sh, int sw,
                              int ph, int pw, int groups, int bn) {
  return plan_of(make_geometry(B, H, W, C, O, kh, kw, sh, sw, ph, pw, groups), groups, bn);
}
