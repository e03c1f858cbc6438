// Expert-grouped block dequant-matmul for Hopper (B2e), in all ten block
// formats: y[p] = x[p] @ dequant(W[e(p)]) for P rows sorted by expert.
// This file holds its tiled instance and the inputs every instance takes;
// csrc/qmatmul_experts_gemv.cu (decode) and csrc/qmatmul_experts_wgmma.cu
// (prefill) hold the other two, each with its own design note.  The
// wrapper (ops/cuda/qmatmul_experts.py::plan) picks one from static
// shapes and a static bound on the rows any expert holds.
//
// Replaces the TPU kernel ipex_llm_tpu/ops/pallas/qmatmul.py::qmatmul_pallas
// as the reference's sparse MoE dispatch reaches it: under jax.vmap, one
// product per (token, expert) pair indexed into an [E, ...] stack of
// packed planes (ipex_llm_tpu/ops/moe.py::moe_gather -> ops/linear.py).
// It also takes the place of the reference's other route, moe_ragged,
// which dequantizes the whole stack to bf16 and runs lax.ragged_dot: at
// the published MoE widths that writes and reads E/k times the bytes of
// the touched experts' packed planes (PERF.md).
//
// Inputs: x bf16 [P, K] (K the stack's padded contraction width), the
// rows of expert e at [seg[e], seg[e+1]) (seg int32 [E+1], computed on the
// device: no host read finds the work), and the stack's planes, each
// expert's at a fixed stride ([E, rows, N] data; [E, K/BS, N] scales and
// zeros).  y is bf16 (the gather route) or fp32 (the ragged route), its
// rows in x's order.
//
// The tiled instance takes what neither of the others does: more than 8
// rows an expert may hold, and fewer than 64 an expert on the mean (the
// verify forward's 32 tokens, a small prefill).  What bounds it there: the
// touched experts' packed planes against a few dozen rows each, so the
// memory rate and the decode of each weight.  The design: the grid is
// (row-tile slots, 128-column tiles), with ceil(P / BM) + E slots, an
// upper bound on the row tiles of any split of P rows among E experts;
// each block finds its (expert, row tile) from seg with one warp scan over
// the experts' tile counts and exits if its slot is past the last tile.  A
// row tile of one expert runs B2's tiled tile (csrc/qmatmul_tile.cuh:
// cp.async ring, decode of each weight to bf16 once per tile, mma.sync),
// so the formats decode bitwise as B2 decodes them.  BM is 16 rows up to
// a mean of 16 rows an expert, else 64; the row tiles of one expert run in
// the same wave (slots are the grid's fast axis), so its planes come from
// device memory about once and from L2 after that.  It has no K split and
// no atomics: each output is summed over K in one fixed order, the same
// every run.
#include "qmatmul_tile.cuh"

namespace {

template <int F, int BM>
__global__ void __launch_bounds__(TileShape<BM>::kThreads,
                                  TileShape<BM>::kMinBlocks)
qmm_experts_kernel(const __nv_bfloat16* __restrict__ x,
                   const uint8_t* __restrict__ w,
                   const __half* __restrict__ s,
                   const __half* __restrict__ z,
                   const float* __restrict__ table,
                   const int* __restrict__ seg,
                   __nv_bfloat16* __restrict__ out_bf16,
                   float* __restrict__ out_f32,
                   int E, int N, int K, long long data_stride,
                   long long scale_stride, int vec16) {
  using T = Traits<F>;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int tile_e, tile_r0, tile_r1;
  if (threadIdx.x < 32) {
    // the slot's (expert, row tile): an inclusive scan of the experts'
    // tile counts, 32 experts at a time
    const int lane = threadIdx.x;
    const int slot = blockIdx.x;
    int base = 0, found = -1, r0 = 0, r1 = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      const int lo = e < E ? seg[e] : 0;
      const int hi = e < E ? seg[e + 1] : 0;
      const int nt = (hi - lo + BM - 1) / BM;
      int inc = nt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      const int first = base + inc - nt;
      if (nt > 0 && slot >= first && slot < base + inc) {
        found = e;
        r0 = lo + (slot - first) * BM;
        r1 = hi;
      }
      base += __shfl_sync(0xffffffffu, inc, 31);
    }
    const unsigned hit = __ballot_sync(0xffffffffu, found >= 0);
    if (lane == 0 && hit == 0u) tile_e = -1;
    if (found >= 0) {           // one lane at most: the tiles are disjoint
      tile_e = found;
      tile_r0 = r0;
      tile_r1 = r1;
    }
  }
  __syncthreads();
  const int e = tile_e;
  if (e < 0) return;            // every thread of the block
  const uint8_t* we = w + (size_t)e * data_stride;
  const __half* se = s + (size_t)e * scale_stride;
  const __half* ze = T::kZeros ? z + (size_t)e * scale_stride : nullptr;
  qmm_tc_tile<F, BM>(smem, x, we, we + (size_t)(K / 2) * N, se, ze, table,
                     nullptr, out_bf16, out_f32, tile_r0, blockIdx.y * kTN,
                     0, tile_r1, N, K, K / T::kBS, vec16);
}

template <int F, int BM>
int launch(cudaStream_t st, int slots, const __nv_bfloat16* x,
           const uint8_t* w, const __half* s, const __half* z,
           const float* table, const int* seg, __nv_bfloat16* ob, float* of,
           int E, int N, int K, long long data_stride, long long scale_stride,
           int vec16) {
  constexpr int smem = tc_smem_bytes<Traits<F>, BM>();
  cudaError_t e = cudaFuncSetAttribute(
      qmm_experts_kernel<F, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(slots, (N + kTN - 1) / kTN, 1);
  qmm_experts_kernel<F, BM><<<grid, TileShape<BM>::kThreads, smem, st>>>(
      x, w, s, z, table, seg, ob, of, E, N, K, data_stride, scale_stride,
      vec16);
  return 0;
}

template <int F>
int launch_format(int tile, cudaStream_t st, int slots,
                  const __nv_bfloat16* x, const uint8_t* w, const __half* s,
                  const __half* z, const float* table, const int* seg,
                  __nv_bfloat16* ob, float* of, int E, int N, int K,
                  long long ds, long long ss, int vec16) {
  switch (tile) {
    case 16:
      return launch<F, 16>(st, slots, x, w, s, z, table, seg, ob, of, E, N, K,
                           ds, ss, vec16);
    case 64:
      return launch<F, 64>(st, slots, x, w, s, z, table, seg, ob, of, E, N, K,
                           ds, ss, vec16);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x bf16 [P, K] contiguous, 16-byte aligned, its rows sorted by expert;
// seg int32 [E + 1] on the device (expert e's rows [seg[e], seg[e+1]),
// seg[0] = 0, seg[E] = P); data uint8 [E, rows, N] in the format's layout
// (5-bit: each expert's K/2 nibble rows then its K/8 bit-plane rows),
// data_stride = rows * N bytes; scales (and zeros, asym formats, else
// null) fp16 [E, K/BS, N], scale_stride = K/BS * N elements; table fp32
// [16] (nf4, fp4, else null); out bf16 or fp32 [P, N]; tile the rows of a
// row tile (16 or 64); slots the row-tile slots of the grid (at least
// ceil(P / tile) + E); vec16 != 0 when N % 16 == 0 and the planes are
// 16-byte aligned.  Returns the launch's error or cudaGetLastError().
extern "C" int qmatmul_experts(int format, const void* x, const void* data,
                               const void* scales, const void* zeros,
                               const void* table, const void* seg, void* out,
                               int out_f32, int E, int N, int K,
                               long long data_stride, long long scale_stride,
                               int tile, int slots, int vec16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (slots <= 0) return 0;
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint8_t*>(data);
  const auto* sp = static_cast<const __half*>(scales);
  const auto* zp = static_cast<const __half*>(zeros);
  const auto* tp = static_cast<const float*>(table);
  const auto* gp = static_cast<const int*>(seg);
  auto* ob = out_f32 ? nullptr : static_cast<__nv_bfloat16*>(out);
  auto* of = out_f32 ? static_cast<float*>(out) : nullptr;
  int err;
  switch (format) {
#define QMME_FORMAT(FID)                                                    \
    case FID:                                                               \
      err = launch_format<FID>(tile, st, slots, xp, wp, sp, zp, tp, gp, ob, \
                               of, E, N, K, data_stride, scale_stride,     \
                               vec16);                                      \
      break;
    QMME_FORMAT(kSymInt4)
    QMME_FORMAT(kAsymInt4)
    QMME_FORMAT(kNF4)
    QMME_FORMAT(kFP4)
    QMME_FORMAT(kSymInt5)
    QMME_FORMAT(kAsymInt5)
    QMME_FORMAT(kSymInt8)
    QMME_FORMAT(kFP6)
    QMME_FORMAT(kFP8E4M3)
    QMME_FORMAT(kFP8E5M2)
#undef QMME_FORMAT
    default: err = (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
