// Expert-grouped block dequant-matmul for Hopper (B2e), its GEMV instance,
// in all ten block formats: y[p] = x[p] @ dequant(W[e(p)]) for P rows
// sorted by expert when no expert holds more than a few rows (decode).
//
// Replaces, with csrc/qmatmul_experts.cu (whose head comment names the
// inputs and the TPU kernel) and csrc/qmatmul_experts_wgmma.cu, the TPU
// kernel ipex_llm_tpu/ops/pallas/qmatmul.py::qmatmul_pallas as the
// reference's MoE dispatch reaches it under jax.vmap
// (ipex_llm_tpu/ops/moe.py::moe_gather).
//
// What bounds it: the touched experts' packed planes, 0.53 to 1.06 bytes a
// weight against a few rows of x an expert (Mixtral-8x7B's decode tick: 16
// rows over 8 experts; Qwen3-30B-A3B's: 64 over 128), so the card's memory
// rate.  The 16-row tile of csrc/qmatmul_experts.cu spends most of that
// time elsewhere: it decodes every weight into a bf16 tile in shared memory
// and reads it back by ldmatrix, it has no K split (Mixtral's down
// projection puts 224 blocks of 224 K steps on 132 SMs), and its grid of
// ceil(P / 16) + E row-tile slots leaves most blocks with nothing to do.
//
// The design: B2's GEMV block (csrc/qmatmul_gemv.cuh), which decodes each
// lane's own 16-byte chunks of packed planes straight into mma.sync A
// fragments, streams them through a cp.async ring per warp, and splits K
// over the warps of a block and the blocks of a cluster (at most 8), the
// fp32 partial sums meeting in distributed shared memory and added in
// split order, in one launch.  An expert's rows of x (at most 8 at a time)
// are the B fragment.  The grid is (cluster ranks, column blocks, expert
// slots) with min(E, P) slots, since no more experts than that can hold
// rows: block z finds the z-th expert that holds rows with one warp scan
// of seg, and exits, with its whole cluster (its blocks share the slot),
// past the last.  An expert with more than 8 rows is walked in chunks of 8,
// each a pass over its planes (from L2 after the first), so the instance is
// right for any split of the rows; the wrapper takes it only when a static
// bound (the forward's token count: a token's k experts are distinct)
// keeps every expert at 8 rows or fewer.  The formats decode bitwise as
// B2's and B2e's other instances decode them; each output is summed in one
// fixed order, no atomics.
#include "qmatmul_gemv.cuh"

namespace {

constexpr int kRows = 8;    // rows of x a block takes at once (mma n8)

// The slot-th expert that holds rows, in expert order: (e, its first row,
// its segment end), e = -1 past the last.  One warp; every lane returns it.
__device__ __forceinline__ int3 nth_expert(const int* __restrict__ seg,
                                           int E, int slot, int lane) {
  int base = 0;
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int e = e0 + lane;
    const int lo = e < E ? seg[e] : 0;
    const int hi = e < E ? seg[e + 1] : 0;
    const int live = hi > lo ? 1 : 0;
    int inc = live;                 // inclusive scan of the live flags
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += v;
    }
    const unsigned hit =
        __ballot_sync(0xffffffffu, live && base + inc - 1 == slot);
    if (hit != 0u) {
      const int src = __ffs(hit) - 1;
      return make_int3(e0 + src, __shfl_sync(0xffffffffu, lo, src),
                       __shfl_sync(0xffffffffu, hi, src));
    }
    base += __shfl_sync(0xffffffffu, inc, 31);
  }
  return make_int3(-1, 0, 0);
}

// Block (rank, column block, slot): the GEMV block over the slot's expert,
// 8 of its rows at a time.
template <int F, bool VEC16>
__global__ void __launch_bounds__(kGemvThreads)
qmm_experts_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                        const uint8_t* __restrict__ w,
                        const __half* __restrict__ s,
                        const __half* __restrict__ z,
                        const float* __restrict__ table,
                        const int* __restrict__ seg,
                        __nv_bfloat16* __restrict__ out_bf16,
                        float* __restrict__ out_f32, int E, int N, int K,
                        long long data_stride, long long scale_stride,
                        int warps_k, int qb_per_warp) {
  using T = Traits<F>;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int3 found;
  if (threadIdx.x < 32) {
    const int3 r = nth_expert(seg, E, blockIdx.z, threadIdx.x);
    if (threadIdx.x == 0) found = r;
  }
  __syncthreads();
  if (found.x < 0) return;        // every block of the cluster: one slot
  // only m0 lives across the chunks: the expert is read back from shared
  // memory (volatile: not kept in registers) and its pointers recomputed,
  // so the GEMV block has the registers it has in B2's instance
  const volatile int3* fv = &found;
  for (int m0 = fv->y; m0 < fv->z; m0 += kRows) {
    const int e = fv->x, end = fv->z;
    const uint8_t* we = w + (size_t)e * data_stride;
    qmm_gemv_block<F, kRows, VEC16>(
        smem, x + (size_t)m0 * K, we, we + (size_t)(K / 2) * N,
        s + (size_t)e * scale_stride,
        T::kZeros ? z + (size_t)e * scale_stride : nullptr, table,
        out_bf16 != nullptr ? out_bf16 + (size_t)m0 * N : nullptr,
        out_f32 != nullptr ? out_f32 + (size_t)m0 * N : nullptr,
        min(kRows, end - m0), N, K, warps_k, qb_per_warp, blockIdx.y,
        gridDim.x, (int)hopper::cluster_rank());
    // the partials stay until every rank has read them, and the next
    // chunk's copies into the same shared memory wait for that too
    if (gridDim.x > 1)            // the cluster spans grid x
      hopper::cluster_sync();
    else
      __syncthreads();
  }
}

struct Args {
  const __nv_bfloat16* x;
  const uint8_t* w;
  const __half* s;
  const __half* z;
  const float* table;
  const int* seg;
  __nv_bfloat16* ob;
  float* of;
  int E, N, K;
  long long ds, ss;
  int slots, warps_k, cluster, qbpw;
};

template <int F, bool VEC16>
int launch(cudaStream_t st, const Args& a) {
  using T = Traits<F>;
  const int smem = gemv_smem_bytes<T, kRows>(a.warps_k * a.qbpw * T::kBS);
  cudaError_t e = cudaFuncSetAttribute(
      qmm_experts_gemv_kernel<F, VEC16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int cols = kGemvWarps / a.warps_k * kGemvCols;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, (a.N + cols - 1) / cols, a.slots);
  cfg.blockDim = dim3(kGemvThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, qmm_experts_gemv_kernel<F, VEC16>,
                                 a.x, a.w, a.s, a.z, a.table, a.seg, a.ob,
                                 a.of, a.E, a.N, a.K, a.ds, a.ss, a.warps_k,
                                 a.qbpw);
}

}  // namespace

// x bf16 [P, K] contiguous, 16-byte aligned, its rows sorted by expert;
// seg int32 [E + 1] on the device; data, scales, zeros, table, out and the
// strides as csrc/qmatmul_experts.cu takes them.  slots: the grid's expert
// slots (min(E, P)); warps_k (1, 2 or 4) of a block's 4 warps split K, and
// `cluster` blocks (1 to 8) split it further, split s = rank * warps_k +
// warp holding quantization blocks [s * qb_per_warp, (s + 1) *
// qb_per_warp); vec16 != 0 when N % 16 == 0 and the planes are 16-byte
// aligned.  Returns the launch's error or cudaGetLastError()
// (cudaErrorInvalidValue for an unknown format or a split out of range).
extern "C" int qmatmul_experts_gemv(int format, const void* x,
                                    const void* data, const void* scales,
                                    const void* zeros, const void* table,
                                    const void* seg, void* out, int out_f32,
                                    int E, int N, int K,
                                    long long data_stride,
                                    long long scale_stride, int slots,
                                    int warps_k, int cluster,
                                    int qb_per_warp, int vec16,
                                    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (slots <= 0) return 0;
  if (warps_k < 1 || kGemvWarps % warps_k || cluster < 1 || cluster > 8)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const __nv_bfloat16*>(x),
         static_cast<const uint8_t*>(data),
         static_cast<const __half*>(scales),
         static_cast<const __half*>(zeros),
         static_cast<const float*>(table),
         static_cast<const int*>(seg),
         out_f32 ? nullptr : static_cast<__nv_bfloat16*>(out),
         out_f32 ? static_cast<float*>(out) : nullptr,
         E, N, K, data_stride, scale_stride, slots, warps_k, cluster,
         qb_per_warp};
  int err;
  switch (format) {
#define QMMG_FORMAT(FID)                                          \
    case FID:                                                     \
      err = vec16 ? launch<FID, true>(st, a) : launch<FID, false>(st, a); \
      break;
    QMMG_FORMAT(kSymInt4)
    QMMG_FORMAT(kAsymInt4)
    QMMG_FORMAT(kNF4)
    QMMG_FORMAT(kFP4)
    QMMG_FORMAT(kSymInt5)
    QMMG_FORMAT(kAsymInt5)
    QMMG_FORMAT(kSymInt8)
    QMMG_FORMAT(kFP6)
    QMMG_FORMAT(kFP8E4M3)
    QMMG_FORMAT(kFP8E5M2)
#undef QMMG_FORMAT
    default: err = (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
