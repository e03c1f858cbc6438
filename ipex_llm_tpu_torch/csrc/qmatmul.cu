// Fused block dequant-matmul for Hopper, in all ten block formats:
// y[M,N] = x[M,K] @ dequant(W).
//
// Replaces the TPU kernel ipex_llm_tpu/ops/pallas/qmatmul.py::qmatmul_pallas
// (body _qmatmul_2d, _make_kernel, _dequant_tile), which is also one kernel
// with the format as a parameter.  Here the format is a template argument:
// a traits struct gives its block size, its plane layout and the value of a
// code; one kernel body reads every layout.
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
//
// What bounds it: at decode (M <= 8) the packed weight stream, 0.53 to
// 1.06 bytes per weight by format, so the card's memory rate; at prefill
// the multiply-adds, which this first version runs on the CUDA cores (no
// wgmma yet).
//
// Design: a warp owns 128 output columns, each lane 4 neighbouring columns,
// so one 32-bit load per lane per packed row reads 128 contiguous bytes per
// warp (coalesced; the planes are read as stored, no repack).  A block is 4
// warps = 512 columns and MT rows of x; x is staged through shared memory
// in chunks of 512 K-rows, converted to fp32 once and read back as
// broadcasts.  Decode shapes have too few column tiles to fill 132 SMs, so
// the K axis splits over gridDim.z in whole quantization blocks; each split
// writes an fp32 partial and a second kernel sums the splits in a fixed
// order (deterministic, no atomics).  With one split the first kernel
// writes the output directly.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kColsPerLane = 4;
constexpr int kColsPerWarp = 32 * kColsPerLane;        // 128
constexpr int kColsPerBlock = kWarps * kColsPerWarp;   // 512
constexpr int kChunkRows = 512;                        // x staging rows
constexpr int kLoadRows = 16;                          // packed rows / load

// format ids: the order of FORMATS in ops/cuda/qmatmul.py
enum Format : int {
  kSymInt4 = 0, kAsymInt4, kNF4, kFP4, kSymInt5, kAsymInt5, kSymInt8,
  kFP6, kFP8E4M3, kFP8E5M2
};

enum class Layout { kNib4, kBit5, kByte };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 1+EB+MB minifloat with bias BIAS (subnormals, no inf/nan), exact in fp32:
// sign x (1 + m/2^MB) x 2^(e-BIAS), subnormals m/2^MB x 2^(1-BIAS)
template <int EB, int MB, int BIAS>
__device__ __forceinline__ float minifloat(int c) {
  const int e = (c >> MB) & ((1 << EB) - 1);
  const int m = c & ((1 << MB) - 1);
  const float mag =
      e > 0 ? __int_as_float(((e - BIAS + 127) << 23) | (m << (23 - MB)))
            : (float)m * __int_as_float((1 - BIAS - MB + 127) << 23);
  return ((c >> (EB + MB)) & 1) ? -mag : mag;
}

template <int BS, Layout L, bool ZEROS, bool TABLE>
struct FormatBase {
  static constexpr int kBS = BS;
  static constexpr Layout kLayout = L;
  static constexpr bool kZeros = ZEROS;
  static constexpr bool kTable = TABLE;
};

template <int F> struct Traits;
template <> struct Traits<kSymInt4> : FormatBase<32, Layout::kNib4, false, false> {
  __device__ static float value(int c, const float*) { return (float)(c - 8); }
};
template <> struct Traits<kAsymInt4> : FormatBase<32, Layout::kNib4, true, false> {
  __device__ static float value(int c, const float*) { return (float)c; }
};
template <> struct Traits<kNF4> : FormatBase<64, Layout::kNib4, false, true> {
  __device__ static float value(int c, const float* tab) { return tab[c]; }
};
template <> struct Traits<kFP4> : FormatBase<64, Layout::kNib4, false, true> {
  __device__ static float value(int c, const float* tab) { return tab[c]; }
};
template <> struct Traits<kSymInt5> : FormatBase<32, Layout::kBit5, false, false> {
  __device__ static float value(int c, const float*) { return (float)(c - 16); }
};
template <> struct Traits<kAsymInt5> : FormatBase<32, Layout::kBit5, true, false> {
  __device__ static float value(int c, const float*) { return (float)c; }
};
template <> struct Traits<kSymInt8> : FormatBase<32, Layout::kByte, false, false> {
  __device__ static float value(int c, const float*) { return (float)(c - 128); }
};
template <> struct Traits<kFP6> : FormatBase<64, Layout::kByte, false, false> {
  __device__ static float value(int c, const float*) { return minifloat<3, 2, 3>(c); }
};
template <> struct Traits<kFP8E4M3> : FormatBase<128, Layout::kByte, false, false> {
  __device__ static float value(int c, const float*) { return minifloat<4, 3, 7>(c); }
};
template <> struct Traits<kFP8E5M2> : FormatBase<128, Layout::kByte, false, false> {
  __device__ static float value(int c, const float*) { return minifloat<5, 2, 15>(c); }
};

// one weight: value(code) * scale (+ zero), fp32, rounded once to bf16.
// The product and the sum are rounded separately (no fused multiply-add),
// as the plain version computes them.
template <class T>
__device__ __forceinline__ float weight(int c, float s, float z,
                                        const float* tab) {
  const float v = __fmul_rn(T::value(c, tab), s);
  return bf16_round(T::kZeros ? __fadd_rn(v, z) : v);
}

template <int F, int MT>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const __nv_bfloat16* __restrict__ x,
           const uint8_t* __restrict__ w,
           const uint8_t* __restrict__ hbits,
           const __half* __restrict__ s,
           const __half* __restrict__ z,
           const float* __restrict__ table,
           float* __restrict__ partial,
           __nv_bfloat16* __restrict__ out_bf16,
           float* __restrict__ out_f32,
           int M, int N, int K, int qb_per_split) {
  using T = Traits<F>;
  constexpr int kBS = T::kBS;
  constexpr int kChunkQB = kChunkRows / kBS;
  __shared__ float xs[MT][kChunkRows];
  __shared__ float tab[16];
  if constexpr (T::kTable) {
    if (threadIdx.x < 16) tab[threadIdx.x] = table[threadIdx.x];
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * MT;
  const int n0 = blockIdx.y * kColsPerBlock + warp * kColsPerWarp +
                 lane * kColsPerLane;
  const int split = blockIdx.z;
  const int nqb = K / kBS;
  const int qb_begin = split * qb_per_split;
  const int qb_end = min(nqb, qb_begin + qb_per_split);
  // N % 4 == 0 (checked by the wrapper): n0 < N means all 4 columns exist
  const bool col_ok = n0 < N;
  const size_t n_words = (size_t)(N / 4);   // 32-bit words per packed row

  float acc[MT][kColsPerLane];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[m][c] = 0.f;

  for (int c0 = qb_begin; c0 < qb_end; c0 += kChunkQB) {
    const int nq = min(kChunkQB, qb_end - c0);
    const int klen = nq * kBS;
    __syncthreads();                       // previous chunk fully consumed
    for (int i = threadIdx.x; i < MT * klen; i += kThreads) {
      const int m = i / klen;
      const int k = i - m * klen;
      float v = 0.f;
      if (m0 + m < M)
        v = __bfloat162float(x[(size_t)(m0 + m) * K + (size_t)c0 * kBS + k]);
      xs[m][k] = v;
    }
    __syncthreads();
    if (!col_ok) continue;
    for (int q = 0; q < nq; ++q) {
      const int qb = c0 + q;
      const int kq = q * kBS;              // block's first row in xs
      const uint2 sraw =
          *reinterpret_cast<const uint2*>(s + (size_t)qb * N + n0);
      const __half2 s01 = *reinterpret_cast<const __half2*>(&sraw.x);
      const __half2 s23 = *reinterpret_cast<const __half2*>(&sraw.y);
      const float sc[kColsPerLane] = {__low2float(s01), __high2float(s01),
                                      __low2float(s23), __high2float(s23)};
      float zc[kColsPerLane] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (T::kZeros) {
        const uint2 zraw =
            *reinterpret_cast<const uint2*>(z + (size_t)qb * N + n0);
        const __half2 z01 = *reinterpret_cast<const __half2*>(&zraw.x);
        const __half2 z23 = *reinterpret_cast<const __half2*>(&zraw.y);
        zc[0] = __low2float(z01);
        zc[1] = __high2float(z01);
        zc[2] = __low2float(z23);
        zc[3] = __high2float(z23);
      }
      if constexpr (T::kLayout == Layout::kByte) {
        const uint32_t* wp =
            reinterpret_cast<const uint32_t*>(w + (size_t)qb * kBS * N + n0);
        for (int r0 = 0; r0 < kBS; r0 += kLoadRows) {
          uint32_t pk[kLoadRows];
#pragma unroll
          for (int j = 0; j < kLoadRows; ++j)
            pk[j] = __ldg(wp + (size_t)(r0 + j) * n_words);
#pragma unroll
          for (int j = 0; j < kLoadRows; ++j) {
            float wv[kColsPerLane];
#pragma unroll
            for (int c = 0; c < kColsPerLane; ++c)
              wv[c] = weight<T>((pk[j] >> (8 * c)) & 0xFF, sc[c], zc[c], tab);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const float xv = xs[m][kq + r0 + j];
#pragma unroll
              for (int c = 0; c < kColsPerLane; ++c)
                acc[m][c] = fmaf(xv, wv[c], acc[m][c]);
            }
          }
        }
      } else {
        constexpr int kHalf = kBS / 2;
        const uint32_t* wp = reinterpret_cast<const uint32_t*>(
            w + (size_t)qb * kHalf * N + n0);
        // 5-bit: the block's 32 fifth bits of each column, 4 bit-plane rows
        uint32_t hw[4] = {0u, 0u, 0u, 0u};
        if constexpr (T::kLayout == Layout::kBit5) {
          static_assert(kBS == 32, "the 5-bit layout has 32-row blocks");
          const uint32_t* hp = reinterpret_cast<const uint32_t*>(
              hbits + (size_t)qb * 4 * N + n0);
#pragma unroll
          for (int i = 0; i < 4; ++i) hw[i] = __ldg(hp + (size_t)i * n_words);
        }
#pragma unroll
        for (int j0 = 0; j0 < kHalf; j0 += kLoadRows) {
          uint32_t pk[kLoadRows];
#pragma unroll
          for (int j = 0; j < kLoadRows; ++j)
            pk[j] = __ldg(wp + (size_t)(j0 + j) * n_words);
#pragma unroll
          for (int j = 0; j < kLoadRows; ++j) {
            const int rl = j0 + j;          // low nibble: block row rl
            const int rh = rl + kHalf;      // high nibble: block row rh
            float wl[kColsPerLane], wh[kColsPerLane];
#pragma unroll
            for (int c = 0; c < kColsPerLane; ++c) {
              const int byte = (pk[j] >> (8 * c)) & 0xFF;
              int lo = byte & 0xF, hi = byte >> 4;
              if constexpr (T::kLayout == Layout::kBit5) {
                lo |= ((hw[rl >> 3] >> (8 * c + (rl & 7))) & 1) << 4;
                hi |= ((hw[rh >> 3] >> (8 * c + (rh & 7))) & 1) << 4;
              }
              wl[c] = weight<T>(lo, sc[c], zc[c], tab);
              wh[c] = weight<T>(hi, sc[c], zc[c], tab);
            }
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const float xl = xs[m][kq + rl];
              const float xh = xs[m][kq + rh];
#pragma unroll
              for (int c = 0; c < kColsPerLane; ++c) {
                acc[m][c] = fmaf(xl, wl[c], acc[m][c]);
                acc[m][c] = fmaf(xh, wh[c], acc[m][c]);
              }
            }
          }
        }
      }
    }
  }
  if (!col_ok) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int row = m0 + m;
    if (row >= M) break;
    if (partial != nullptr) {
      float4 v = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      *reinterpret_cast<float4*>(
          partial + ((size_t)split * M + row) * N + n0) = v;
    } else if (out_f32 != nullptr) {
      float4 v = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      *reinterpret_cast<float4*>(out_f32 + (size_t)row * N + n0) = v;
    } else {
      __nv_bfloat162 lo = __floats2bfloat162_rn(acc[m][0], acc[m][1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(acc[m][2], acc[m][3]);
      uint2 v;
      v.x = *reinterpret_cast<uint32_t*>(&lo);
      v.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(out_bf16 + (size_t)row * N + n0) = v;
    }
  }
}

// Sum the K-split partials in split order (fixed, so the result does not
// change from run to run) and write the output type.
__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  __nv_bfloat16* __restrict__ out_bf16,
                                  float* __restrict__ out_f32,
                                  long long mn, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = 0.f;
  for (int sp = 0; sp < splits; ++sp) acc += partial[(long long)sp * mn + i];
  if (out_f32 != nullptr)
    out_f32[i] = acc;
  else
    out_bf16[i] = __float2bfloat16_rn(acc);
}

struct Args {
  const __nv_bfloat16* x;
  const uint8_t* w;
  const uint8_t* hbits;
  const __half* s;
  const __half* z;
  const float* table;
  float* part;
  __nv_bfloat16* ob;
  float* of;
  int M, N, K, qbps;
};

template <int F>
int launch_format(int mt, dim3 grid, cudaStream_t st, const Args& a) {
#define QMM_CASE(MTV)                                                       \
  case MTV:                                                                 \
    qmm_kernel<F, MTV><<<grid, kThreads, 0, st>>>(                          \
        a.x, a.w, a.hbits, a.s, a.z, a.table, a.part, a.ob, a.of, a.M, a.N, \
        a.K, a.qbps);                                                       \
    return 0;
  switch (mt) {
    QMM_CASE(1)
    QMM_CASE(2)
    QMM_CASE(4)
    QMM_CASE(8)
    QMM_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QMM_CASE
}

}  // namespace

// x bf16 [M,K] contiguous; data uint8 in the format's layout (for the
// 5-bit formats the K/2 nibble rows then the K/8 bit-plane rows); scales
// fp16 [K/BS,N]; zeros fp16 [K/BS,N] (asym formats, else null); table
// fp32 [16] (nf4, fp4, else null); out bf16 or fp32 [M,N]; partial fp32
// [splits,M,N] when splits > 1; mt in {1,2,4,8,16} rows of x per block (the
// wrapper's row_tile); format one of the Format ids.
// Returns cudaGetLastError() after the launches (cudaErrorInvalidValue for
// an unknown format or an mt without an instance).
extern "C" int qmatmul(int format, const void* x, const void* data,
                       const void* scales, const void* zeros,
                       const void* table, void* out, int out_f32,
                       void* partial, int M, int N, int K, int splits,
                       int qb_per_split, int mt, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid((M + mt - 1) / mt, (N + kColsPerBlock - 1) / kColsPerBlock,
            splits);
  const auto* wp = static_cast<const uint8_t*>(data);
  Args a{static_cast<const __nv_bfloat16*>(x), wp,
         wp + (size_t)(K / 2) * N,
         static_cast<const __half*>(scales),
         static_cast<const __half*>(zeros),
         static_cast<const float*>(table),
         splits > 1 ? static_cast<float*>(partial) : nullptr,
         (splits == 1 && !out_f32) ? static_cast<__nv_bfloat16*>(out) : nullptr,
         (splits == 1 && out_f32) ? static_cast<float*>(out) : nullptr,
         M, N, K, qb_per_split};
  int err;
  switch (format) {
    case kSymInt4: err = launch_format<kSymInt4>(mt, grid, st, a); break;
    case kAsymInt4: err = launch_format<kAsymInt4>(mt, grid, st, a); break;
    case kNF4: err = launch_format<kNF4>(mt, grid, st, a); break;
    case kFP4: err = launch_format<kFP4>(mt, grid, st, a); break;
    case kSymInt5: err = launch_format<kSymInt5>(mt, grid, st, a); break;
    case kAsymInt5: err = launch_format<kAsymInt5>(mt, grid, st, a); break;
    case kSymInt8: err = launch_format<kSymInt8>(mt, grid, st, a); break;
    case kFP6: err = launch_format<kFP6>(mt, grid, st, a); break;
    case kFP8E4M3: err = launch_format<kFP8E4M3>(mt, grid, st, a); break;
    case kFP8E5M2: err = launch_format<kFP8E5M2>(mt, grid, st, a); break;
    default: err = (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  if (splits > 1) {
    const long long mn = (long long)M * N;
    const int threads = 256;
    const unsigned blocks = (unsigned)((mn + threads - 1) / threads);
    qmm_reduce_kernel<<<blocks, threads, 0, st>>>(
        static_cast<const float*>(partial),
        out_f32 ? nullptr : static_cast<__nv_bfloat16*>(out),
        out_f32 ? static_cast<float*>(out) : nullptr, mn, splits);
  }
  return (int)cudaGetLastError();
}
