// Fused sym_int4 dequant-matmul for Hopper: y[M,N] = x[M,K] @ dequant(W).
//
// Replaces the TPU kernel ipex_llm_tpu/ops/pallas/qmatmul.py::qmatmul_pallas
// (body _qmatmul_2d, _make_kernel, _dequant_tile) for sym_int4.
//
// Layout (quantize/core.py, shared byte for byte with the JAX package):
//   data   uint8 [K/2, N]: in each 32-row quantization block, byte j holds
//          row j in its low nibble and row j+16 in its high nibble;
//   scales fp16  [K/32, N];  w = bf16((code - 8) * scale), computed in fp32
//          and rounded to bf16 before the product (the reference's rounding
//          point); x is bf16; the sum is fp32; y is bf16 or fp32.
//
// What bounds it: at decode (M <= 8) the packed weight stream, ~0.56 bytes
// per weight, so the card's memory rate; at prefill the multiply-adds,
// which this first version runs on the CUDA cores (no wgmma yet).
//
// Design: a warp owns 128 output columns, each lane 4 neighbouring columns,
// so one 32-bit load per lane per packed row reads 128 contiguous bytes per
// warp (coalesced; the planes are read as stored, no repack).  A block is 4
// warps = 512 columns and MT rows of x; x is staged through shared memory
// in chunks of 512 K-rows, converted to fp32 once and read back as
// broadcasts.  Decode shapes have too few column tiles to fill 132 SMs, so
// the K axis splits over gridDim.z; each split writes an fp32 partial and a
// second kernel sums the splits in a fixed order (deterministic, no
// atomics).  With one split the first kernel writes the output directly.
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
constexpr int kQB = 32;                                // quantization block
constexpr int kHalf = kQB / 2;                         // packed rows / block
constexpr int kChunkQB = 16;                           // x staging: 512 rows

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
qmm_int4_kernel(const __nv_bfloat16* __restrict__ x,
                const uint8_t* __restrict__ w,
                const __half* __restrict__ s,
                float* __restrict__ partial,
                __nv_bfloat16* __restrict__ out_bf16,
                float* __restrict__ out_f32,
                int M, int N, int K, int qb_per_split) {
  __shared__ float xs[MT][kChunkQB * kQB];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * MT;
  const int n0 = blockIdx.y * kColsPerBlock + warp * kColsPerWarp +
                 lane * kColsPerLane;
  const int split = blockIdx.z;
  const int nqb = K / kQB;
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
    const int klen = nq * kQB;
    __syncthreads();                       // previous chunk fully consumed
    for (int i = threadIdx.x; i < MT * klen; i += kThreads) {
      const int m = i / klen;
      const int k = i - m * klen;
      float v = 0.f;
      if (m0 + m < M)
        v = __bfloat162float(x[(size_t)(m0 + m) * K + (size_t)c0 * kQB + k]);
      xs[m][k] = v;
    }
    __syncthreads();
    if (!col_ok) continue;
    for (int q = 0; q < nq; ++q) {
      const int qb = c0 + q;
      const uint2 sraw =
          *reinterpret_cast<const uint2*>(s + (size_t)qb * N + n0);
      const __half2 s01 = *reinterpret_cast<const __half2*>(&sraw.x);
      const __half2 s23 = *reinterpret_cast<const __half2*>(&sraw.y);
      const float sc[kColsPerLane] = {__low2float(s01), __high2float(s01),
                                      __low2float(s23), __high2float(s23)};
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(
          w + (size_t)qb * kHalf * N + n0);
      uint32_t pk[kHalf];
#pragma unroll
      for (int j = 0; j < kHalf; ++j) pk[j] = __ldg(wp + (size_t)j * n_words);
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        float wl[kColsPerLane], wh[kColsPerLane];
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) {
          const int byte = (pk[j] >> (8 * c)) & 0xFF;   // column n0 + c
          wl[c] = bf16_round((float)((byte & 0xF) - 8) * sc[c]);  // row j
          wh[c] = bf16_round((float)((byte >> 4) - 8) * sc[c]);   // row j+16
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xl = xs[m][q * kQB + j];
          const float xh = xs[m][q * kQB + j + kHalf];
#pragma unroll
          for (int c = 0; c < kColsPerLane; ++c) {
            acc[m][c] = fmaf(xl, wl[c], acc[m][c]);
            acc[m][c] = fmaf(xh, wh[c], acc[m][c]);
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

template <int MT>
void launch(dim3 grid, cudaStream_t st, const __nv_bfloat16* x,
            const uint8_t* w, const __half* s, float* part,
            __nv_bfloat16* ob, float* of, int M, int N, int K, int qbps) {
  qmm_int4_kernel<MT><<<grid, kThreads, 0, st>>>(x, w, s, part, ob, of, M, N,
                                                 K, qbps);
}

}  // namespace

// x bf16 [M,K] contiguous; data uint8 [K/2,N]; scales fp16 [K/32,N];
// out bf16 or fp32 [M,N]; partial fp32 [splits,M,N] when splits > 1;
// mt in {1,2,4,8,16} rows of x per block (the wrapper's row_tile).
// Returns cudaGetLastError() after the launches (cudaErrorInvalidValue for
// an mt without an instance).
extern "C" int qmatmul_int4(const void* x, const void* data,
                            const void* scales, void* out, int out_f32,
                            void* partial, int M, int N, int K, int splits,
                            int qb_per_split, int mt, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid((M + mt - 1) / mt, (N + kColsPerBlock - 1) / kColsPerBlock,
            splits);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  __nv_bfloat16* ob = (splits == 1 && !out_f32)
                          ? static_cast<__nv_bfloat16*>(out) : nullptr;
  float* of = (splits == 1 && out_f32) ? static_cast<float*>(out) : nullptr;
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint8_t*>(data);
  const auto* sp = static_cast<const __half*>(scales);
  switch (mt) {
    case 1: launch<1>(grid, st, xp, wp, sp, part, ob, of, M, N, K, qb_per_split); break;
    case 2: launch<2>(grid, st, xp, wp, sp, part, ob, of, M, N, K, qb_per_split); break;
    case 4: launch<4>(grid, st, xp, wp, sp, part, ob, of, M, N, K, qb_per_split); break;
    case 8: launch<8>(grid, st, xp, wp, sp, part, ob, of, M, N, K, qb_per_split); break;
    case 16: launch<16>(grid, st, xp, wp, sp, part, ob, of, M, N, K, qb_per_split); break;
    default: return (int)cudaErrorInvalidValue;
  }
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
