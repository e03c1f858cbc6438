// The input gradient of the dequant-matmul (B2^T) for Hopper, in all ten
// block formats: dx[M, K] = dy[M, N] . dequant(W)^T, W [K, N] packed as B2
// reads it.
//
// Replaces no TPU kernel: the JAX package has no backward Pallas kernel;
// its gradient of B2 is XLA's autodiff of the oracle (qmatmul_reference's
// dequantize, then the product), the straight-through gradient of the
// reference's MatMulLowBit.backward.  The planes get no gradient (the base
// is frozen).  Semantics: each weight decodes bitwise as B2 decodes it (in
// fp32, rounded to bf16 once, csrc/qmatmul_formats.cuh through
// qmatmul_tile.cuh's decode_step), dy is bf16, the sums over N run in
// fp32, and dx is rounded to bf16 once.  dx has the padded contraction
// width K (whole quantization blocks); the caller slices it to the
// weight's in_features.
//
// What bounds it: at the training shapes (M = 2048 rows of a step) the
// 2 M N K multiply-adds, so the tensor cores, as B2's tiled instance; in
// this first version the decode of each weight once per 128-row block of
// dy, on the CUDA cores, as in B2's tiled instance (PERF.md).
//
// Design (B2's tiled tile, read transposed).  A block owns a 128 x 64
// tile of dx (rows m0.., contraction rows k0..k0+63 of W) and walks N in
// steps of 128: each step stages the dy tile [128 x 128] (16-byte
// cp.async, chunk c of row r at chunk c ^ (r % 8)) and W's packed planes
// for rows k0..k0+63 and the step's 128 columns (B2's stage layout), two
// stages deep, then decodes the planes into the bf16 tile wt [64 k x 128
// n] (B2's swizzled layout) and multiplies: dy's fragments by ldmatrix,
// and W^T's B fragments by plain ldmatrix of wt's rows (each row of wt is
// a column of the product, its 16-byte chunks 8 consecutive n of the
// reduction), mma.sync m16n8k16 with fp32 accumulators, eight warps of 32
// x 32.  No split of N: one block sums a tile over all of N in a fixed
// order, so two runs give the same bits.
#include "qmatmul_tile.cuh"

namespace {

constexpr int kDxBM = 128;       // rows of dy and dx per block
constexpr int kDxThreads = 256;  // 8 warps: 4 along M x 2 along K, 32 x 32
constexpr int kDxStages = 2;
constexpr int kDyRowBytes = kTN * 2;   // one staged dy row: 128 bf16

template <class T>
__host__ __device__ constexpr int dx_stage_bytes() {
  return kDxBM * kDyRowBytes + StagePlanes<T>::kBytes;
}

template <class T>
__host__ __device__ constexpr int dx_smem_bytes() {
  return kDxStages * dx_stage_bytes<T>() + kTK * kTN * 2 + 16 * 4;
}

template <int F>
__global__ void __launch_bounds__(kDxThreads)
qmm_dx_kernel(const __nv_bfloat16* __restrict__ dy,
              const uint8_t* __restrict__ w,
              const uint8_t* __restrict__ hbits,
              const __half* __restrict__ s, const __half* __restrict__ z,
              const float* __restrict__ table,
              __nv_bfloat16* __restrict__ dx, int M, int N, int K,
              int vec16) {
  using T = Traits<F>;
  using P = StagePlanes<T>;
  constexpr int kStage = dx_stage_bytes<T>();
  constexpr int kYBytes = kDxBM * kDyRowBytes;
  extern __shared__ __align__(128) uint8_t smem[];
  __nv_bfloat16* wt =
      reinterpret_cast<__nv_bfloat16*>(smem + kDxStages * kStage);
  float* tab =
      reinterpret_cast<float*>(smem + kDxStages * kStage + kTK * kTN * 2);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wk = warp & 1;
  const int m0 = blockIdx.x * kDxBM, k0 = blockIdx.y * kTK;
  if constexpr (T::kTable) {
    if (tid < 16) tab[tid] = table[tid];
  }
  const int n_steps = (N + kTN - 1) / kTN;
  const uint8_t* sbase = reinterpret_cast<const uint8_t*>(s);
  const uint8_t* zbase = reinterpret_cast<const uint8_t*>(z);

  auto load_stage = [&](int step, int slot) {
    uint8_t* st = smem + slot * kStage;
    const int n0 = step * kTN;
    // dy: 128 rows x 16 chunks of 16 bytes (N % 8 == 0), swizzled
    for (int i = tid; i < kDxBM * 16; i += kDxThreads) {
      const int row = i >> 4, c = i & 15;
      const int gm = m0 + row, gn = n0 + c * 8;
      const bool ok = gm < M && gn < N;
      hopper::cp_async<16>(st + row * kDyRowBytes + ((c ^ (row & 7)) << 4),
                           ok ? dy + (size_t)gm * N + gn : dy, ok);
    }
    uint8_t* pl = st + kYBytes;
    const int drow = T::kLayout == Layout::kByte ? k0 : k0 / 2;
    const int dend = T::kLayout == Layout::kByte ? K : K / 2;
    const int srow = k0 / T::kBS, send = K / T::kBS;
    if (vec16) {
      stage_plane<kDxThreads, 1, 16>(pl, w, drow, P::kDataRows, dend, n0, N);
      if constexpr (T::kLayout == Layout::kBit5)
        stage_plane<kDxThreads, 1, 16>(pl + P::kData, hbits, k0 / 8, kTK / 8,
                                       K / 8, n0, N);
      stage_plane<kDxThreads, 2, 16>(pl + P::kData + P::kHbits, sbase, srow,
                                     P::kScaleRows, send, n0, N);
      if constexpr (T::kZeros)
        stage_plane<kDxThreads, 2, 16>(pl + P::kData + P::kHbits + P::kScales,
                                       zbase, srow, P::kScaleRows, send, n0,
                                       N);
    } else {
      stage_plane<kDxThreads, 1, 4>(pl, w, drow, P::kDataRows, dend, n0, N);
      if constexpr (T::kLayout == Layout::kBit5)
        stage_plane<kDxThreads, 1, 4>(pl + P::kData, hbits, k0 / 8, kTK / 8,
                                      K / 8, n0, N);
      stage_plane<kDxThreads, 2, 4>(pl + P::kData + P::kHbits, sbase, srow,
                                    P::kScaleRows, send, n0, N);
      if constexpr (T::kZeros)
        stage_plane<kDxThreads, 2, 4>(pl + P::kData + P::kHbits + P::kScales,
                                      zbase, srow, P::kScaleRows, send, n0,
                                      N);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load_stage(0, 0);
  hopper::cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) load_stage(step + 1, (step + 1) & 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();     // the step's stage has landed for every thread
    const uint8_t* yt = smem + (step & 1) * kStage;
    decode_step<T, kDxThreads>(yt + kYBytes, tab, wt, tid);
    __syncthreads();     // wt is decoded
#pragma unroll
    for (int kc = 0; kc < kTN / 16; ++kc) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = wm * 32 + mt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int c = kc * 2 + (lane >> 4);
        hopper::ldsm_x4(af[mt][0], af[mt][1], af[mt][2], af[mt][3],
                        yt + row * kDyRowBytes + ((c ^ (row & 7)) << 4));
      }
      uint32_t bf[4][2];
#pragma unroll
      for (int np = 0; np < 4; np += 2) {
        // rows of wt (dx columns) np*8.. and np*8+8.., chunks 2kc, 2kc+1
        const int row = wk * 32 + np * 8 + (lane >> 4) * 8 + (lane & 7);
        const int c = kc * 2 + ((lane >> 3) & 1);
        hopper::ldsm_x4(bf[np][0], bf[np][1], bf[np + 1][0], bf[np + 1][1],
                        wt + row * kTN + ((c ^ (row & 7)) << 3));
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          hopper::mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
    __syncthreads();     // wt and the stage's slot are refilled next
  }
  hopper::cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      // K is even: an even column below K has its neighbour below K too
      const int col = k0 + wk * 32 + nt * 8 + (lane & 3) * 2;
      if (col >= K) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + mt * 16 + (lane >> 2) + 8 * h;
        if (row >= M) continue;
        *reinterpret_cast<uint32_t*>(dx + (size_t)row * K + col) =
            hopper::pack_bf16(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
}

template <int F>
int launch_dx(cudaStream_t st, const __nv_bfloat16* dy, const uint8_t* w,
              const uint8_t* hbits, const __half* s, const __half* z,
              const float* table, __nv_bfloat16* dx, int M, int N, int K,
              int vec16) {
  constexpr int smem = dx_smem_bytes<Traits<F>>();
  cudaError_t e = cudaFuncSetAttribute(
      qmm_dx_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + kDxBM - 1) / kDxBM, (K + kTK - 1) / kTK);
  qmm_dx_kernel<F><<<grid, kDxThreads, smem, st>>>(dy, w, hbits, s, z, table,
                                                   dx, M, N, K, vec16);
  return 0;
}

}  // namespace

// dy bf16 [M,N] contiguous, 16-byte aligned, N % 8 == 0; data, scales,
// zeros and table as csrc/qmatmul.cu's qmatmul takes them (K the padded
// contraction width, a whole number of quantization blocks); dx bf16
// [M,K] contiguous.  vec16 != 0 when N % 16 == 0 and the planes are
// 16-byte aligned (16-byte copies of the planes; else 4-byte).  One
// launch; returns its error or cudaGetLastError() (cudaErrorInvalidValue
// for an unknown format).
extern "C" int qmatmul_dx(int format, const void* dy, const void* data,
                          const void* scales, const void* zeros,
                          const void* table, void* dx, int M, int N, int K,
                          int vec16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* wp = static_cast<const uint8_t*>(data);
  const auto* y = static_cast<const __nv_bfloat16*>(dy);
  const uint8_t* hb = wp + (size_t)(K / 2) * N;
  const auto* sp = static_cast<const __half*>(scales);
  const auto* zp = static_cast<const __half*>(zeros);
  const auto* tp = static_cast<const float*>(table);
  auto* out = static_cast<__nv_bfloat16*>(dx);
  int err;
  switch (format) {
#define DX_FORMAT(FID)                                                     \
    case FID: err = launch_dx<FID>(st, y, wp, hb, sp, zp, tp, out, M, N, K, \
                                   vec16); break;
    DX_FORMAT(kSymInt4)
    DX_FORMAT(kAsymInt4)
    DX_FORMAT(kNF4)
    DX_FORMAT(kFP4)
    DX_FORMAT(kSymInt5)
    DX_FORMAT(kAsymInt5)
    DX_FORMAT(kSymInt8)
    DX_FORMAT(kFP6)
    DX_FORMAT(kFP8E4M3)
    DX_FORMAT(kFP8E5M2)
#undef DX_FORMAT
    default: err = (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
