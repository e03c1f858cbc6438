// Fused block dequant-matmul for Hopper, in all ten block formats:
// y[M,N] = x[M,K] @ dequant(W).
//
// Replaces the TPU kernel ipex_llm_tpu/ops/pallas/qmatmul.py::qmatmul_pallas
// (body _qmatmul_2d, _make_kernel, _dequant_tile), which is also one kernel
// with the format as a parameter.  Here the format is a template argument:
// a traits struct gives its block size, its plane layout and the value of a
// code; both instances below read every layout through it.
//
// The formats' plane layouts, traits and decode are in
// csrc/qmatmul_formats.cuh; the GEMV instance's block is in
// csrc/qmatmul_gemv.cuh and the tiled instance's tile in
// csrc/qmatmul_tile.cuh, which the expert-grouped kernel (B2e,
// csrc/qmatmul_experts*.cu) shares.
//
// Two instances, chosen by the wrapper from M alone:
//
// GEMV (M <= 8, decode).  What bounds it: the packed weight stream, 0.53
// to 1.06 bytes per weight by format, so the card's memory rate -- as long
// as the decode keeps up, since every weight costs a few instructions and
// the ALUs issue about 128 of them a cycle per SM.  So the decode runs
// without conversion instructions (value(), as the tiled instance's), two
// weights rounded to bf16 at once straight into the registers of an
// mma.sync A fragment, and the multiply-adds run on the tensor cores
// (m16n8k16: 16 output columns x 16 contraction rows of weights against
// the M <= 8 rows of x, zero-padded to 8); a lane reads whole 16-byte
// chunks of its own 16 columns, which the fragment map below puts in its
// A rows (the planes are read as stored, no repack).  Each warp streams
// its columns' packed planes through a 4-stage ring of 16-byte cp.async
// in shared memory; x is staged once per block in bf16.  The K split that
// fills the card never writes partials to device memory: the warps of a
// block and the blocks of a thread-block cluster (at most 8) split K, and
// their fp32 sums meet in (distributed) shared memory, added in split
// order: one launch, the same output every run.
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
// planes into a bf16 [64 x 128] tile in shared memory (bitwise the
// weights the plain version uses) without conversion instructions, which
// run at a quarter of the ALU rate: codes become floats by bit tricks
// (value()), and each weight is rounded to bf16 once, two at a time, as
// it is packed.  Two weight tiles alternate, so with one
// barrier a step the warps decode step s + 1 while they multiply step s:
// each warp runs ldmatrix (.trans for the K-major weight) and mma.sync
// m16n8k16 bf16 with fp32 accumulators in registers over its warp tile
// (16 x 32, 32 x 32 or, at BM = 128, 64 x 64, which reads the fewest
// fragment bytes per multiply-add).  The x and weight tiles are
// XOR-swizzled by 16-byte chunk so ldmatrix reads are free of bank
// conflicts.  The epilogue writes bf16 or fp32.
//
// The tiled instance splits K over gridDim.z when its tiles cannot fill
// the card, in whole quantization blocks and whole K steps; each split
// writes an fp32 partial and a second kernel sums the splits in a fixed
// order (deterministic, no atomics).  With one split it writes the output
// directly.
#include "qmatmul_gemv.cuh"
#include "qmatmul_tile.cuh"

namespace {

// ---- GEMV instance (M <= 8): decode into mma.sync fragments ------------

// the GEMV block of csrc/qmatmul_gemv.cuh at block (cluster rank, column
// block); the cluster spans grid x
template <int F, int MT, bool VEC16>
__global__ void __launch_bounds__(kGemvThreads)
qmm_kernel(const __nv_bfloat16* __restrict__ x,
           const uint8_t* __restrict__ w,
           const uint8_t* __restrict__ hbits,
           const __half* __restrict__ s,
           const __half* __restrict__ z,
           const float* __restrict__ table,
           __nv_bfloat16* __restrict__ out_bf16,
           float* __restrict__ out_f32,
           int M, int N, int K, int warps_k, int qb_per_warp) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int cs = gridDim.x;
  qmm_gemv_block<F, MT, VEC16>(smem, x, w, hbits, s, z, table, out_bf16,
                               out_f32, M, N, K, warps_k, qb_per_warp,
                               blockIdx.y, cs, (int)hopper::cluster_rank());
  if (cs > 1) hopper::cluster_sync();   // partials stay until all are read
}

// ---- tiled instance (M > 8): cp.async ring, decode to bf16, mma.sync ----

// the tile of csrc/qmatmul_tile.cuh at block (m tile, n tile, K split)
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
  extern __shared__ __align__(128) uint8_t smem[];
  qmm_tc_tile<F, BM>(smem, x, w, hbits, s, z, table, partial, out_bf16,
                     out_f32, blockIdx.x * BM, blockIdx.y * kTN, blockIdx.z,
                     M, N, K, qb_per_split, vec16);
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

// the GEMV instance: one launch, grid (cluster, column blocks), the
// cluster spanning grid x
template <int F, int MT, bool VEC16>
int launch_gemv(cudaStream_t st, int warps_k, int cluster, const Args& a) {
  using T = Traits<F>;
  const int smem = gemv_smem_bytes<T, MT>(warps_k * a.qbps * T::kBS);
  cudaError_t e = cudaFuncSetAttribute(
      qmm_kernel<F, MT, VEC16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const int cols = kGemvWarps / warps_k * kGemvCols;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (a.N + cols - 1) / cols, 1);
  cfg.blockDim = dim3(kGemvThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, qmm_kernel<F, MT, VEC16>, a.x, a.w,
                                 a.hbits, a.s, a.z, a.table, a.ob, a.of, a.M,
                                 a.N, a.K, warps_k, a.qbps);
}

template <int F, int MT>
int launch_gemv(cudaStream_t st, int warps_k, int cluster, const Args& a) {
  return a.vec16 ? launch_gemv<F, MT, true>(st, warps_k, cluster, a)
                 : launch_gemv<F, MT, false>(st, warps_k, cluster, a);
}

// tile: rows of x per block; 1, 2, 4 or 8 launch the GEMV instance, 16, 64
// or 128 the tiled one
template <int F>
int launch_format(int tile, cudaStream_t st, int splits, int warps_k,
                  const Args& a) {
  switch (tile) {
    case 1: return launch_gemv<F, 1>(st, warps_k, splits / warps_k, a);
    case 2: return launch_gemv<F, 2>(st, warps_k, splits / warps_k, a);
    case 4: return launch_gemv<F, 4>(st, warps_k, splits / warps_k, a);
    case 8: return launch_gemv<F, 8>(st, warps_k, splits / warps_k, a);
    case 16: return launch_tc<F, 16>(st, splits, a);
    case 64: return launch_tc<F, 64>(st, splits, a);
    case 128: return launch_tc<F, 128>(st, splits, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x bf16 [M,K] contiguous, 16-byte aligned; data uint8 in the format's
// layout (for the 5-bit formats the K/2 nibble rows then the K/8 bit-plane
// rows); scales fp16 [K/BS,N]; zeros fp16 [K/BS,N] (asym formats, else
// null); table fp32 [16] (nf4, fp4, else null); out bf16 or fp32 [M,N];
// tile the rows of x per block (the wrapper's tile_rows).  GEMV (tile 1, 2,
// 4 or 8): splits = warps_k x the cluster size (at most 8), qb_per_split
// the quant blocks of each warp, one launch.  Tiled (tile 16, 64 or 128):
// splits over gridDim.z, each qb_per_split quant blocks of whole 64-row
// steps, then, when splits > 1, the reduce of partial fp32
// [splits,M,N]; warps_k is not read.  vec16 != 0 when N % 16 == 0 and the
// planes are 16-byte aligned (16-byte copies; else 4-byte); format one of
// the Format ids.  Returns the launch's error or cudaGetLastError() after
// the launches (cudaErrorInvalidValue for an unknown format or tile, or a
// GEMV split that is not warps_k x a cluster of 1 to 8).
extern "C" int qmatmul(int format, const void* x, const void* data,
                       const void* scales, const void* zeros,
                       const void* table, void* out, int out_f32,
                       void* partial, int M, int N, int K, int splits,
                       int qb_per_split, int tile, int vec16, int warps_k,
                       void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool gemv = tile <= 8;
  if (gemv && (warps_k < 1 || kGemvWarps % warps_k || splits % warps_k ||
               splits / warps_k < 1 || splits / warps_k > 8))
    return (int)cudaErrorInvalidValue;
  const bool reduce = !gemv && splits > 1;
  const auto* wp = static_cast<const uint8_t*>(data);
  Args a{static_cast<const __nv_bfloat16*>(x), wp,
         wp + (size_t)(K / 2) * N,
         static_cast<const __half*>(scales),
         static_cast<const __half*>(zeros),
         static_cast<const float*>(table),
         reduce ? static_cast<float*>(partial) : nullptr,
         (!reduce && !out_f32) ? static_cast<__nv_bfloat16*>(out) : nullptr,
         (!reduce && out_f32) ? static_cast<float*>(out) : nullptr,
         M, N, K, qb_per_split, vec16};
  int err;
  switch (format) {
#define QMM_FORMAT(FID) \
    case FID: err = launch_format<FID>(tile, st, splits, warps_k, a); break;
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
  if (reduce) {
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
