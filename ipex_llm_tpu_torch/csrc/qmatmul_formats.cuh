// The ten block formats of the dequant-matmul kernels (B2, csrc/qmatmul.cu,
// and B2e, csrc/qmatmul_experts.cu): each format's traits and the device
// functions that decode its codes.
//
// Layouts (quantize/core.py, shared byte for byte with the JAX package),
// each plane [rows, N] row-major, the contraction axis K along the rows:
//   4-bit (sym_int4, asym_int4, nf4, fp4): data uint8 [K/2, N]; in each
//          block of BS rows, byte j holds row j in its low nibble and row
//          j + BS/2 in its high nibble;
//   5-bit (sym_int5, asym_int5): the 4-bit layout of the low nibbles
//          ([K/2, N]), then the fifth bits ([K/8, N]): row r's bit is bit
//          r % 8 of bit-plane row r / 8.  The kernel takes both base
//          pointers;
//   byte  (sym_int8, fp6, fp8_e4m3, fp8_e5m2): one code per byte [K, N];
//   scales fp16 [K/BS, N]; zeros (asym formats: the block minimum) fp16
//          [K/BS, N].
// A weight decodes in fp32 as value(code) * scale (+ zero for the asym
// formats), is rounded to bf16 once (the reference's rounding point), and
// multiplies bf16 x with an fp32 sum; y is bf16 or fp32.  The minifloats
// decode arithmetically, as the Pallas kernel does (_minifloat_decode); on
// the codes that are NaN or inf in IEEE fp8 (which the codec never writes)
// that differs from a cast through the fp8 dtypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// format ids: the order of FORMATS in ops/cuda/qmatmul.py
enum Format : int {
  kSymInt4 = 0, kAsymInt4, kNF4, kFP4, kSymInt5, kAsymInt5, kSymInt8,
  kFP6, kFP8E4M3, kFP8E5M2
};

enum class Layout { kNib4, kBit5, kByte };

// c - BIAS in fp32, exactly, for 0 <= c < 2^23, without an int-to-float
// conversion (a quarter-rate instruction): 2^23 + c holds c in its mantissa
template <int BIAS>
__device__ __forceinline__ float code_minus(int c) {
  return __int_as_float(0x4B000000 | c) - (8388608.f + (float)BIAS);
}

// 1+EB+MB minifloat with bias BIAS (subnormals, no inf/nan), exactly in
// fp32 and without a branch or a conversion: sign x (1 + m/2^MB) x
// 2^(e-BIAS), subnormals m/2^MB x 2^(1-BIAS).  The code's exponent and
// mantissa bits are placed where an fp32 keeps them (an fp32 subnormal
// when e == 0), the sign at bit 31, then one exact multiply by
// 2^(127 - BIAS) turns 2^(e-127) (1 + m/2^MB) into the first and the
// subnormal m/2^MB x 2^-126 into the second (fp32 subnormals are not
// flushed without --use_fast_math)
template <int EB, int MB, int BIAS>
__device__ __forceinline__ float minifloat(int c) {
  const uint32_t bits = (((uint32_t)c >> (EB + MB)) & 1u) << 31 |
                        ((uint32_t)c & ((1u << (EB + MB)) - 1u)) << (23 - MB);
  return __fmul_rn(__uint_as_float(bits),
                   __uint_as_float((uint32_t)(254 - BIAS) << 23));
}

// INT: the integer formats' code bias (value = code - INT), -1 for the
// codebook and minifloat formats
template <int BS, Layout L, bool ZEROS, bool TABLE, int INT = -1>
struct FormatBase {
  static constexpr int kBS = BS;
  static constexpr Layout kLayout = L;
  static constexpr bool kZeros = ZEROS;
  static constexpr bool kTable = TABLE;
  static constexpr int kIntBias = INT;
};

template <int F> struct Traits;
template <> struct Traits<kSymInt4> : FormatBase<32, Layout::kNib4, false, false, 8> {
  __device__ static float value(int c, const float* tab) { return code_minus<8>(c); }
};
template <> struct Traits<kAsymInt4> : FormatBase<32, Layout::kNib4, true, false, 0> {
  __device__ static float value(int c, const float* tab) { return code_minus<0>(c); }
};
template <> struct Traits<kNF4> : FormatBase<64, Layout::kNib4, false, true> {
  __device__ static float value(int c, const float* tab) { return tab[c]; }
};
template <> struct Traits<kFP4> : FormatBase<64, Layout::kNib4, false, true> {
  __device__ static float value(int c, const float* tab) { return tab[c]; }
};
template <> struct Traits<kSymInt5> : FormatBase<32, Layout::kBit5, false, false, 16> {
  __device__ static float value(int c, const float* tab) { return code_minus<16>(c); }
};
template <> struct Traits<kAsymInt5> : FormatBase<32, Layout::kBit5, true, false, 0> {
  __device__ static float value(int c, const float* tab) { return code_minus<0>(c); }
};
template <> struct Traits<kSymInt8> : FormatBase<32, Layout::kByte, false, false, 128> {
  __device__ static float value(int c, const float* tab) { return code_minus<128>(c); }
};
template <> struct Traits<kFP6> : FormatBase<64, Layout::kByte, false, false> {
  __device__ static float value(int c, const float* tab) { return minifloat<3, 2, 3>(c); }
};
template <> struct Traits<kFP8E4M3> : FormatBase<128, Layout::kByte, false, false> {
  __device__ static float value(int c, const float* tab) { return minifloat<4, 3, 7>(c); }
};
template <> struct Traits<kFP8E5M2> : FormatBase<128, Layout::kByte, false, false> {
  __device__ static float value(int c, const float* tab) { return minifloat<5, 2, 15>(c); }
};

// one weight, value(code) * scale (+ zero) in fp32, the product and the
// sum rounded separately (no fused multiply-add) as the plain version
// computes them, before its one rounding to bf16: both instances round two
// weights at once as they pack them (the GEMV decodes the integer formats
// with int_weight(), bitwise the same)
template <class T>
__device__ __forceinline__ float weight_unrounded(int c, float s, float z,
                                                  const float* tab) {
  const float v = __fmul_rn(T::value(c, tab), s);
  return T::kZeros ? __fadd_rn(v, z) : v;
}

// The integer formats' GEMV decode, in three instructions a weight or
// fewer: byte k of `word` (a code of at most 8 bits) placed in bits 8..15
// of 1.0f's mantissa by one byte permute gives f = 1 + code x 2^-15
// exactly; with a = s x 2^15, one fused multiply-add f a - (2^15 + bias) s
// is (code - bias) s computed exactly and rounded once, bitwise
// __fmul_rn(code - bias, s) (both constants are exact in fp32: s has 11
// significant bits, 2^15 + bias at most 13); the asymmetric formats take
// f a - a = code x s, exact, then add the zero with one rounding, as
// weight_unrounded() does
__device__ __forceinline__ float code_float(uint32_t word, int k) {
  return __uint_as_float(__byte_perm(word, 0x3F800000u, 0x7604 | (k << 4)));
}

template <class T>
__device__ __forceinline__ float int_weight(float f, float a, float b) {
  if constexpr (T::kZeros)
    return __fadd_rn(__fmaf_rn(f, a, -a), b);   // b: the zero
  else
    return __fmaf_rn(f, a, b);                  // b: -(2^15 + bias) s
}

}  // namespace
