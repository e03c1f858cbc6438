// Fused block dequant-matmul for Hopper, in all ten block formats:
// y[M,N] = x[M,K] @ dequant(W).
//
// Replaces the TPU kernel ipex_llm_tpu/ops/pallas/qmatmul.py::qmatmul_pallas
// (body _qmatmul_2d, _make_kernel, _dequant_tile), which is also one kernel
// with the format as a parameter.  Here the format is a template argument:
// a traits struct gives its block size, its plane layout and the value of a
// code; both instances below read every layout through it.
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
// Two instances, chosen by the wrapper from M alone:
//
// GEMV (M <= 8, decode).  What bounds it: the packed weight stream, 0.53
// to 1.06 bytes per weight by format, so the card's memory rate.  A warp
// owns 128 output columns, each lane 4 neighbouring columns, so one 32-bit
// load per lane per packed row reads 128 contiguous bytes per warp
// (coalesced; the planes are read as stored, no repack).  A block is 4
// warps = 512 columns and MT <= 8 rows of x; x is staged through shared
// memory in chunks of 512 K-rows as fp32 and read back as broadcasts; the
// multiply-adds run on the CUDA cores.
//
// Tiled (M > 8: the verify forward, the mixed tick's prefill rows,
// generate's prefill).  What bounds it: at M >= 128 the multiply-adds
// (2MNK operations against 0.5-1 byte a weight), so the tensor cores; in
// this version the copies into shared memory and the decode of each weight
// once per row tile, on the CUDA cores, take more of its time than the
// products (PERF.md), which wgmma and TMA would address.  A block owns
// a BM x 128 output tile (BM = 16, 64 or 128 by M) and walks K in steps of
// 64 rows: two 32-row quantization blocks, one 64-row block, or half of a
// 128-row fp8 block.  A ring of three stages in dynamic shared memory
// holds each step's x tile and packed planes (data, fifth bits, scales,
// zeros), filled with 16-byte cp.async (4-byte where N is not a multiple
// of 16) two steps ahead of the step being multiplied; rows and columns
// past the edges are zero-filled.  The block decodes a step's packed
// planes into a bf16 [64 x 128] tile in shared memory with weight<T>()'s
// arithmetic (bitwise the weights the plain version uses), but without
// its conversions, which run at a quarter of the ALU rate: codes become
// floats by bit tricks (fast()), and each weight is rounded to bf16 once,
// two at a time, as it is packed.  Two weight tiles alternate, so with one
// barrier a step the warps decode step s + 1 while they multiply step s:
// each warp runs ldmatrix (.trans for the K-major weight) and mma.sync
// m16n8k16 bf16 with fp32 accumulators in registers over its warp tile
// (16 x 32, 32 x 32 or, at BM = 128, 64 x 64, which reads the fewest
// fragment bytes per multiply-add).  The x and weight tiles are
// XOR-swizzled by 16-byte chunk so ldmatrix reads are free of bank
// conflicts.  The epilogue writes bf16 or fp32.
//
// Both instances split K over gridDim.z when their tiles cannot fill the
// card, in whole quantization blocks (the tiled one also in whole K steps);
// each split writes an fp32 partial and a second kernel sums the splits in
// a fixed order (deterministic, no atomics).  With one split the product
// kernel writes the output directly.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// c - BIAS in fp32, exactly, for 0 <= c < 2^23, without an int-to-float
// conversion (a quarter-rate instruction): 2^23 + c holds c in its mantissa
template <int BIAS>
__device__ __forceinline__ float code_minus(int c) {
  return __int_as_float(0x4B000000 | c) - (8388608.f + (float)BIAS);
}

// minifloat() with the subnormal mantissa converted by code_minus
template <int EB, int MB, int BIAS>
__device__ __forceinline__ float minifloat_fast(int c) {
  const int e = (c >> MB) & ((1 << EB) - 1);
  const int m = c & ((1 << MB) - 1);
  const float mag =
      e > 0 ? __int_as_float(((e - BIAS + 127) << 23) | (m << (23 - MB)))
            : code_minus<0>(m) * __int_as_float((1 - BIAS - MB + 127) << 23);
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
  __device__ static float fast(int c, const float* tab) { return code_minus<8>(c); }
};
template <> struct Traits<kAsymInt4> : FormatBase<32, Layout::kNib4, true, false> {
  __device__ static float value(int c, const float*) { return (float)c; }
  __device__ static float fast(int c, const float* tab) { return code_minus<0>(c); }
};
template <> struct Traits<kNF4> : FormatBase<64, Layout::kNib4, false, true> {
  __device__ static float value(int c, const float* tab) { return tab[c]; }
  __device__ static float fast(int c, const float* tab) { return tab[c]; }
};
template <> struct Traits<kFP4> : FormatBase<64, Layout::kNib4, false, true> {
  __device__ static float value(int c, const float* tab) { return tab[c]; }
  __device__ static float fast(int c, const float* tab) { return tab[c]; }
};
template <> struct Traits<kSymInt5> : FormatBase<32, Layout::kBit5, false, false> {
  __device__ static float value(int c, const float*) { return (float)(c - 16); }
  __device__ static float fast(int c, const float* tab) { return code_minus<16>(c); }
};
template <> struct Traits<kAsymInt5> : FormatBase<32, Layout::kBit5, true, false> {
  __device__ static float value(int c, const float*) { return (float)c; }
  __device__ static float fast(int c, const float* tab) { return code_minus<0>(c); }
};
template <> struct Traits<kSymInt8> : FormatBase<32, Layout::kByte, false, false> {
  __device__ static float value(int c, const float*) { return (float)(c - 128); }
  __device__ static float fast(int c, const float* tab) { return code_minus<128>(c); }
};
template <> struct Traits<kFP6> : FormatBase<64, Layout::kByte, false, false> {
  __device__ static float value(int c, const float*) { return minifloat<3, 2, 3>(c); }
  __device__ static float fast(int c, const float* tab) { return minifloat_fast<3, 2, 3>(c); }
};
template <> struct Traits<kFP8E4M3> : FormatBase<128, Layout::kByte, false, false> {
  __device__ static float value(int c, const float*) { return minifloat<4, 3, 7>(c); }
  __device__ static float fast(int c, const float* tab) { return minifloat_fast<4, 3, 7>(c); }
};
template <> struct Traits<kFP8E5M2> : FormatBase<128, Layout::kByte, false, false> {
  __device__ static float value(int c, const float*) { return minifloat<5, 2, 15>(c); }
  __device__ static float fast(int c, const float* tab) { return minifloat_fast<5, 2, 15>(c); }
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

// ---- tiled instance (M > 8): cp.async ring, decode to bf16, mma.sync ----

constexpr int kTN = 128;     // output columns per block
constexpr int kTK = 64;      // contraction rows per step
constexpr int kStages = 3;   // cp.async ring depth

// warps and warp tiles: BM=16 4 warps of 16x32, BM=64 8 warps of 32x32,
// BM=128 4 warps of 64x64 (the largest warp tile reads the fewest
// fragment bytes out of shared memory per multiply-add)
template <int BM>
struct TileShape {
  static constexpr int kWarpsM = BM == 16 ? 1 : 2;
  static constexpr int kWarpsN = BM == 128 ? 2 : 4;
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int kWarpRows = BM / kWarpsM;     // 16, 32 or 64
  static constexpr int kMT = kWarpRows / 16;         // m16 tiles per warp
  static constexpr int kNT = kTN / kWarpsN / 8;      // n8 tiles per warp
  static constexpr int kMinBlocks = BM == 128 ? 2 : 1;
};

// bytes of one step's packed planes in a stage
template <class T>
struct StagePlanes {
  static constexpr int kDataRows = T::kLayout == Layout::kByte ? kTK : kTK / 2;
  static constexpr int kData = kDataRows * kTN;
  static constexpr int kHbits = T::kLayout == Layout::kBit5 ? kTK / 8 * kTN : 0;
  static constexpr int kScaleRows = T::kBS >= kTK ? 1 : kTK / T::kBS;
  static constexpr int kScales = kScaleRows * kTN * 2;
  static constexpr int kZeros = T::kZeros ? kScales : 0;
  static constexpr int kBytes = kData + kHbits + kScales + kZeros;
};

template <class T, int BM>
__host__ __device__ constexpr int tc_stage_bytes() {
  return BM * kTK * 2 + StagePlanes<T>::kBytes;
}

template <class T, int BM>
__host__ __device__ constexpr int tc_smem_bytes() {
  return kStages * tc_stage_bytes<T, BM>() + 2 * kTK * kTN * 2 + 16 * 4;
}

// rows [r0, r0 + rows) of a row-major [*, N] plane of ELEM-byte elements,
// columns [n0, n0 + 128), into `dst` (rows x 128 ELEM-byte elements); rows
// at or past r_end and columns at or past N are zero-filled
template <int THREADS, int ELEM, int CHUNK>
__device__ __forceinline__ void stage_plane(uint8_t* dst, const uint8_t* base,
                                            int r0, int rows, int r_end,
                                            int n0, int N) {
  constexpr int kRowBytes = kTN * ELEM;
  constexpr int kChunks = kRowBytes / CHUNK;
  for (int i = threadIdx.x; i < rows * kChunks; i += THREADS) {
    const int r = i / kChunks, c = i - r * kChunks;
    const int col = n0 + c * (CHUNK / ELEM);
    const bool ok = r0 + r < r_end && col < N;
    const uint8_t* src =
        ok ? base + ((size_t)(r0 + r) * N + col) * ELEM : base;
    hopper::cp_async<CHUNK>(dst + r * kRowBytes + c * CHUNK, src, ok);
  }
}

// weight() before its bf16 rounding, with value() computed by fast(): the
// tiled instance rounds two weights at once as it packs them, so each is
// bitwise weight()'s
template <class T>
__device__ __forceinline__ float weight_unrounded(int c, float s, float z,
                                                  const float* tab) {
  const float v = __fmul_rn(T::fast(c, tab), s);
  return T::kZeros ? __fadd_rn(v, z) : v;
}

template <int F, int BM>
__global__ void __launch_bounds__(TileShape<BM>::kThreads,
                                  TileShape<BM>::kMinBlocks)
qmm_tc_kernel(const __nv_bfloat16* __restrict__ x,
              const uint8_t* __restrict__ w,
              const uint8_t* __restrict__ hbits,
              const __half* __restrict__ s,
              const __half* __restrict__ z,
              const float* __restrict__ table,
              float* __restrict__ partial,
              __nv_bfloat16* __restrict__ out_bf16,
              float* __restrict__ out_f32,
              int M, int N, int K, int qb_per_split, int vec16) {
  using T = Traits<F>;
  using S = TileShape<BM>;
  using P = StagePlanes<T>;
  constexpr int kThr = S::kThreads;
  constexpr int kABytes = BM * kTK * 2;
  constexpr int kStage = tc_stage_bytes<T, BM>();
  extern __shared__ __align__(128) uint8_t smem[];
  // two bf16 weight tiles: step s+1 is decoded while step s multiplies
  __nv_bfloat16* wts = reinterpret_cast<__nv_bfloat16*>(smem + kStages * kStage);
  float* tab =
      reinterpret_cast<float*>(smem + kStages * kStage + 2 * kTK * kTN * 2);
  if constexpr (T::kTable) {
    if (threadIdx.x < 16) tab[threadIdx.x] = table[threadIdx.x];
  }
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kTN;
  const int split = blockIdx.z;
  const int k_begin = split * qb_per_split * T::kBS;
  const int k_end = min(K, k_begin + qb_per_split * T::kBS);
  const int n_steps = (k_end - k_begin + kTK - 1) / kTK;
  const uint8_t* sbase = reinterpret_cast<const uint8_t*>(s);
  const uint8_t* zbase = reinterpret_cast<const uint8_t*>(z);

  auto load_stage = [&](int step, int slot) {
    uint8_t* st = smem + slot * kStage;
    const int k0 = k_begin + step * kTK;
    // x: BM rows x 64 bf16 = 8 chunks of 16 bytes per row, swizzled
    for (int i = tid; i < BM * 8; i += kThr) {
      const int row = i >> 3, c = i & 7;
      const int gm = m0 + row, gk = k0 + c * 8;
      const bool ok = gm < M && gk < k_end;
      const __nv_bfloat16* src = ok ? x + (size_t)gm * K + gk : x;
      hopper::cp_async<16>(st + row * 128 + ((c ^ (row & 7)) << 4), src, ok);
    }
    uint8_t* pl = st + kABytes;
    const int drow = T::kLayout == Layout::kByte ? k0 : k0 / 2;
    const int dend = T::kLayout == Layout::kByte ? k_end : k_end / 2;
    const int srow = k0 / T::kBS, send = k_end / T::kBS;
    if (vec16) {
      stage_plane<kThr, 1, 16>(pl, w, drow, P::kDataRows, dend, n0, N);
      if constexpr (T::kLayout == Layout::kBit5)
        stage_plane<kThr, 1, 16>(pl + P::kData, hbits, k0 / 8, kTK / 8,
                                 k_end / 8, n0, N);
      stage_plane<kThr, 2, 16>(pl + P::kData + P::kHbits, sbase, srow,
                               P::kScaleRows, send, n0, N);
      if constexpr (T::kZeros)
        stage_plane<kThr, 2, 16>(pl + P::kData + P::kHbits + P::kScales,
                                 zbase, srow, P::kScaleRows, send, n0, N);
    } else {
      stage_plane<kThr, 1, 4>(pl, w, drow, P::kDataRows, dend, n0, N);
      if constexpr (T::kLayout == Layout::kBit5)
        stage_plane<kThr, 1, 4>(pl + P::kData, hbits, k0 / 8, kTK / 8,
                                k_end / 8, n0, N);
      stage_plane<kThr, 2, 4>(pl + P::kData + P::kHbits, sbase, srow,
                              P::kScaleRows, send, n0, N);
      if constexpr (T::kZeros)
        stage_plane<kThr, 2, 4>(pl + P::kData + P::kHbits + P::kScales,
                                zbase, srow, P::kScaleRows, send, n0, N);
    }
  };

  // one 16-byte chunk (8 columns) of weight row k into the swizzled tile
  auto put = [&](__nv_bfloat16* wt, int k, int cg, const float* v) {
    uint4 o;
    o.x = hopper::pack_bf16(v[0], v[1]);
    o.y = hopper::pack_bf16(v[2], v[3]);
    o.z = hopper::pack_bf16(v[4], v[5]);
    o.w = hopper::pack_bf16(v[6], v[7]);
    *reinterpret_cast<uint4*>(wt + k * kTN + ((cg ^ (k & 7)) << 3)) = o;
  };
  auto scales8 = [&](const uint8_t* plane, int row, int cg, float* out) {
    const uint4 raw =
        *reinterpret_cast<const uint4*>(plane + (row * kTN + cg * 8) * 2);
    const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out[2 * e] = __low2float(h[e]);
      out[2 * e + 1] = __high2float(h[e]);
    }
  };

  // decode the packed planes of `slot` into the bf16 tile wt [64 x 128].
  // A thread keeps one group of 8 columns (cg) and walks rows r0, r0 +
  // kRowStep, ...: its scales and zeros are converted once a step, the
  // block row of each of its rows is known at compile time, and the rows
  // are unrolled so that their shared-memory reads are in flight together
  auto decode = [&](int slot, __nv_bfloat16* wt) {
    constexpr int kRowStep = kThr / 16;
    static_assert(kRowStep <= T::kBS / 2, "a step of rows stays in a block");
    const uint8_t* pl = smem + slot * kStage + kABytes;
    const uint8_t* ps = pl + P::kData + P::kHbits;
    const uint8_t* pz = ps + P::kScales;
    const int cg = tid & 15, r0 = tid >> 4;
    float sc[P::kScaleRows][8], zc[P::kScaleRows][8];
#pragma unroll
    for (int r = 0; r < P::kScaleRows; ++r) {
      scales8(ps, r, cg, sc[r]);
      if constexpr (T::kZeros) {
        scales8(pz, r, cg, zc[r]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) zc[r][e] = 0.f;
      }
    }
    if constexpr (T::kLayout == Layout::kByte) {
#pragma unroll
      for (int i = 0; i < kTK / kRowStep; ++i) {
        const int k = r0 + i * kRowStep;
        const int sr = P::kScaleRows == 1 ? 0 : (i * kRowStep) / T::kBS;
        const uint2 raw = *reinterpret_cast<const uint2*>(pl + k * kTN + cg * 8);
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t word = e < 4 ? raw.x : raw.y;
          v[e] = weight_unrounded<T>((word >> (8 * (e & 3))) & 0xFF,
                                     sc[sr][e], zc[sr][e], tab);
        }
        put(wt, k, cg, v);
      }
    } else {
      constexpr int kHalf = T::kBS / 2;
#pragma unroll
      for (int i = 0; i < (kTK / 2) / kRowStep; ++i) {
        const int dr = r0 + i * kRowStep;
        const int b = (i * kRowStep) / kHalf;     // dr / kHalf
        const int klo = dr + b * kHalf, khi = klo + kHalf;
        const uint2 raw = *reinterpret_cast<const uint2*>(pl + dr * kTN + cg * 8);
        uint2 hl = make_uint2(0u, 0u), hh = make_uint2(0u, 0u);
        if constexpr (T::kLayout == Layout::kBit5) {
          const uint8_t* ph = pl + P::kData;
          hl = *reinterpret_cast<const uint2*>(ph + (klo >> 3) * kTN + cg * 8);
          hh = *reinterpret_cast<const uint2*>(ph + (khi >> 3) * kTN + cg * 8);
        }
        float vl[8], vh[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int sh = 8 * (e & 3);
          const int byte = ((e < 4 ? raw.x : raw.y) >> sh) & 0xFF;
          int lo = byte & 0xF, hi = byte >> 4;
          if constexpr (T::kLayout == Layout::kBit5) {
            lo |= (((e < 4 ? hl.x : hl.y) >> (sh + (klo & 7))) & 1) << 4;
            hi |= (((e < 4 ? hh.x : hh.y) >> (sh + (khi & 7))) & 1) << 4;
          }
          vl[e] = weight_unrounded<T>(lo, sc[b][e], zc[b][e], tab);
          vh[e] = weight_unrounded<T>(hi, sc[b][e], zc[b][e], tab);
        }
        put(wt, klo, cg, vl);
        put(wt, khi, cg, vh);
      }
    }
  };

  float acc[S::kMT][S::kNT][4];
#pragma unroll
  for (int i = 0; i < S::kMT; ++i)
#pragma unroll
    for (int j = 0; j < S::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // one barrier a step: step s multiplies wts[s % 2] while step s + 1 is
  // decoded into the other tile and step s + 2 is copied into the ring
  static_assert(kStages == 3, "the schedule below holds three stages");
  if (n_steps > 0) load_stage(0, 0);
  hopper::cp_async_commit();
  if (n_steps > 1) load_stage(1, 1);
  hopper::cp_async_commit();
  hopper::cp_async_wait<1>();
  __syncthreads();
  if (n_steps > 0) decode(0, wts);
  for (int step = 0; step < n_steps; ++step) {
    hopper::cp_async_wait<0>();
    // step + 1's stage has landed for every thread, step's weight tile is
    // decoded, and step - 1's products (the last readers of its ring slot
    // and of the other weight tile) are done
    __syncthreads();
    if (step + 2 < n_steps) load_stage(step + 2, (step + 2) % kStages);
    hopper::cp_async_commit();
    if (step + 1 < n_steps)
      decode((step + 1) % kStages, wts + ((step + 1) & 1) * kTK * kTN);
    const uint8_t* at = smem + (step % kStages) * kStage;
    const __nv_bfloat16* wt = wts + (step & 1) * kTK * kTN;
#pragma unroll
    for (int kc = 0; kc < kTK / 16; ++kc) {
      uint32_t af[S::kMT][4];
#pragma unroll
      for (int mt = 0; mt < S::kMT; ++mt) {
        const int row = wm * S::kWarpRows + mt * 16 + ((lane >> 3) & 1) * 8 +
                        (lane & 7);
        const int c = kc * 2 + (lane >> 4);
        hopper::ldsm_x4(af[mt][0], af[mt][1], af[mt][2], af[mt][3],
                        at + row * 128 + ((c ^ (row & 7)) << 4));
      }
      uint32_t bf[S::kNT][2];
#pragma unroll
      for (int np = 0; np < S::kNT; np += 2) {
        const int k = kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int c = wn * S::kNT + np + (lane >> 4);
        hopper::ldsm_x4_trans(bf[np][0], bf[np][1], bf[np + 1][0],
                              bf[np + 1][1], wt + k * kTN + ((c ^ (k & 7)) << 3));
      }
#pragma unroll
      for (int mt = 0; mt < S::kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < S::kNT; ++nt)
          hopper::mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }

#pragma unroll
  for (int mt = 0; mt < S::kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < S::kNT; ++nt) {
      // N % 4 == 0: an even column below N has its neighbour below N too
      const int col = n0 + wn * (S::kNT * 8) + nt * 8 + (lane & 3) * 2;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * S::kWarpRows + mt * 16 + (lane >> 2) + 8 * h;
        if (row >= M) continue;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (partial != nullptr) {
          *reinterpret_cast<float2*>(
              partial + ((size_t)split * M + row) * N + col) =
              make_float2(v0, v1);
        } else if (out_f32 != nullptr) {
          *reinterpret_cast<float2*>(out_f32 + (size_t)row * N + col) =
              make_float2(v0, v1);
        } else {
          *reinterpret_cast<uint32_t*>(out_bf16 + (size_t)row * N + col) =
              hopper::pack_bf16(v0, v1);
        }
      }
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
  int M, N, K, qbps, vec16;
};

template <int F, int BM>
int launch_tc(cudaStream_t st, int splits, const Args& a) {
  constexpr int smem = tc_smem_bytes<Traits<F>, BM>();
  cudaError_t e = cudaFuncSetAttribute(
      qmm_tc_kernel<F, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.M + BM - 1) / BM, (a.N + kTN - 1) / kTN, splits);
  qmm_tc_kernel<F, BM><<<grid, TileShape<BM>::kThreads, smem, st>>>(
      a.x, a.w, a.hbits, a.s, a.z, a.table, a.part, a.ob, a.of, a.M, a.N, a.K,
      a.qbps, a.vec16);
  return 0;
}

// tile: rows of x per block; 1, 2, 4 or 8 launch the GEMV instance, 16, 64
// or 128 the tiled one
template <int F>
int launch_format(int tile, cudaStream_t st, int splits, const Args& a) {
  const dim3 grid((a.M + tile - 1) / tile,
                  (a.N + kColsPerBlock - 1) / kColsPerBlock, splits);
#define QMM_CASE(MTV)                                                       \
  case MTV:                                                                 \
    qmm_kernel<F, MTV><<<grid, kThreads, 0, st>>>(                          \
        a.x, a.w, a.hbits, a.s, a.z, a.table, a.part, a.ob, a.of, a.M, a.N, \
        a.K, a.qbps);                                                       \
    return 0;
  switch (tile) {
    QMM_CASE(1)
    QMM_CASE(2)
    QMM_CASE(4)
    QMM_CASE(8)
    case 16: return launch_tc<F, 16>(st, splits, a);
    case 64: return launch_tc<F, 64>(st, splits, a);
    case 128: return launch_tc<F, 128>(st, splits, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QMM_CASE
}

}  // namespace

// x bf16 [M,K] contiguous (16-byte aligned for the tiled instance); data
// uint8 in the format's layout (for the 5-bit formats the K/2 nibble rows
// then the K/8 bit-plane rows); scales fp16 [K/BS,N]; zeros fp16 [K/BS,N]
// (asym formats, else null); table fp32 [16] (nf4, fp4, else null); out
// bf16 or fp32 [M,N]; partial fp32 [splits,M,N] when splits > 1; tile the
// rows of x per block (the wrapper's tile_rows: 1, 2, 4, 8 the GEMV
// instance, 16, 64, 128 the tiled one, whose K splits hold whole 64-row
// steps); vec16 != 0 when N % 16 == 0 and the planes are 16-byte aligned
// (the tiled instance's 16-byte copies; else 4-byte); format one of the
// Format ids.  Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for an unknown format or tile).
extern "C" int qmatmul(int format, const void* x, const void* data,
                       const void* scales, const void* zeros,
                       const void* table, void* out, int out_f32,
                       void* partial, int M, int N, int K, int splits,
                       int qb_per_split, int tile, int vec16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* wp = static_cast<const uint8_t*>(data);
  Args a{static_cast<const __nv_bfloat16*>(x), wp,
         wp + (size_t)(K / 2) * N,
         static_cast<const __half*>(scales),
         static_cast<const __half*>(zeros),
         static_cast<const float*>(table),
         splits > 1 ? static_cast<float*>(partial) : nullptr,
         (splits == 1 && !out_f32) ? static_cast<__nv_bfloat16*>(out) : nullptr,
         (splits == 1 && out_f32) ? static_cast<float*>(out) : nullptr,
         M, N, K, qb_per_split, vec16};
  int err;
  switch (format) {
#define QMM_FORMAT(FID) \
    case FID: err = launch_format<FID>(tile, st, splits, a); break;
    QMM_FORMAT(kSymInt4)
    QMM_FORMAT(kAsymInt4)
    QMM_FORMAT(kNF4)
    QMM_FORMAT(kFP4)
    QMM_FORMAT(kSymInt5)
    QMM_FORMAT(kAsymInt5)
    QMM_FORMAT(kSymInt8)
    QMM_FORMAT(kFP6)
    QMM_FORMAT(kFP8E4M3)
    QMM_FORMAT(kFP8E5M2)
#undef QMM_FORMAT
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
