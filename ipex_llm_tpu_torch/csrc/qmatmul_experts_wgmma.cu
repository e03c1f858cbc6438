// Expert-grouped block dequant-matmul for Hopper (B2e), its wgmma
// instance, in all ten block formats: y[p] = x[p] @ dequant(W[e(p)]) for P
// rows sorted by expert when the experts hold many rows each (prefill).
//
// Replaces, with csrc/qmatmul_experts.cu (whose head comment names the
// inputs and the TPU kernel) and csrc/qmatmul_experts_gemv.cu, the TPU
// kernel ipex_llm_tpu/ops/pallas/qmatmul.py::qmatmul_pallas as the
// reference's MoE dispatch reaches it (ipex_llm_tpu/ops/moe.py), and the
// reference's ragged route (lax.ragged_dot over the dequantized stack).
//
// What bounds it: at a prefill chunk's hundreds of rows an expert, the
// multiply-adds (2 P K N operations against 0.53 to 1.06 bytes a weight),
// so the bf16 tensor cores -- as long as the decode of each weight, on the
// CUDA cores, keeps up with them.  The 128-row mma.sync tile of
// csrc/qmatmul_experts.cu runs the decode of step s + 1 in the same warps
// as the products of step s and reaches about a quarter of the tensor
// cores' rate.
//
// The design.  A block is three warpgroups and owns, in turn, work items
// of (expert, 128-row tile of its rows, 256-column tile): a persistent
// grid of one block an SM walks the items in order (item t of block b is
// b + i * gridDim.x; its row tile is t % tiles in expert order, found from
// seg by a warp scan, its column tile t / tiles), so the row tiles of one
// expert and column tile run side by side and share its planes through L2,
// and a block's next item's copies and decode start while its last item's
// epilogue runs.  With warp specialisation:
//   - the producer warpgroup streams the step's packed planes (data, fifth
//     bits, scales, zeros; 64 contraction rows x 256 columns) into a ring
//     of four stages with 16-byte cp.async (4-byte where N % 16 != 0), and
//     decodes each step into a bf16 [64 x 256] weight tile (bitwise the
//     weights the plain version uses, rounded to bf16 once, two at a time;
//     the integer formats with B2's GEMV arithmetic, one byte permute and
//     one fused multiply-add a weight) laid out as wgmma reads an MN-major
//     B operand: four 64-column blocks of 64 rows of 128 bytes, 128-byte
//     swizzled, so the planes, N-contiguous as stored, are never repacked;
//   - each of the two consumer warpgroups owns 64 rows: it streams its rows
//     of x (64 x 64 bf16 a step, K-major, 128-byte swizzled) through a ring
//     of four stages of its own and runs, per step, four wgmma m64n256k16
//     with A (x) and B (the weight tile) from shared memory and fp32
//     accumulators in registers (64 x 256: 128 a thread), keeping one
//     step's products in flight while it issues the next.
// Two weight tiles alternate: the producer decodes step s + 1 while the
// consumers multiply step s; named barriers hand a tile over (FULL: the
// producer's arrival after its decode and a proxy fence) and back (EMPTY:
// the consumers' arrival once its products completed).  Rows past the
// segment end read zeros from x, are computed and never stored; a
// warpgroup whose 64 rows are all past it skips its products.  Each
// output is summed over K in one fixed order (the same every run, no
// atomics) and written as bf16 or fp32.
//
// What holds it back (PERF.md, scripts/torch_experts_parts.py): the
// producer's decode and the consumers' products each take about half of
// the kernel's time alone and overlap by less than half of the shorter,
// whatever the depth of the rings; the next form decodes in the consumer
// warps, into wgmma A fragments, with the product transposed (ROADMAP
// queue 2, item 10).  The persistent walk leaves a tail where the items
// are few: Mixtral-8x7B's down projection has 256 items for 132 blocks.
#include "qmatmul_formats.cuh"

namespace {

constexpr int kBM = 128;            // rows of a tile (two consumers of 64)
constexpr int kBN = 256;            // columns of a tile
constexpr int kBK = 64;             // contraction rows a step
constexpr int kThreads = 384;       // producer + two consumer warpgroups
constexpr int kPStages = 4;         // packed-plane ring (the producer's)
constexpr int kXStages = 4;         // x ring of each consumer
constexpr int kWSlots = 2;          // bf16 weight tiles (decoded steps)
constexpr int kNBlock = 64 * 128;   // one 64-column block of a weight tile
constexpr int kWBytes = kBK * kBN * 2;
constexpr int kXBytes = 64 * kBK * 2;
// named barriers: the producer's own, each consumer's own, and the weight
// tiles' hand-over (FULL + slot, EMPTY + slot) between all 384 threads
constexpr int kBarProducer = 1;
constexpr int kBarConsumer = 2;
constexpr int kBarFull = 4;
constexpr int kBarEmpty = kBarFull + kWSlots;
static_assert(kBarEmpty + kWSlots <= 16, "16 named barriers");

// bytes of one step's packed planes in a stage of the producer's ring
template <class T>
struct StageBytes {
  static constexpr int kDataRows = T::kLayout == Layout::kByte ? kBK : kBK / 2;
  static constexpr int kData = kDataRows * kBN;
  static constexpr int kHbits = T::kLayout == Layout::kBit5 ? kBK / 8 * kBN : 0;
  static constexpr int kScaleRows = T::kBS >= kBK ? 1 : kBK / T::kBS;
  static constexpr int kScales = kScaleRows * kBN * 2;
  static constexpr int kZeros = T::kZeros ? kScales : 0;
  static constexpr int kBytes = kData + kHbits + kScales + kZeros;
};

// dynamic shared memory: the two weight tiles, the consumers' x rings and
// the producer's ring, from a 1024-byte aligned base (the swizzle)
template <class T>
__host__ __device__ constexpr int wgmma_smem_bytes() {
  return kWSlots * kWBytes + 2 * kXStages * kXBytes +
         kPStages * StageBytes<T>::kBytes + 1024;
}

// The count of 128-row tiles over the experts' segments.  One warp; every
// lane returns it.
__device__ __forceinline__ int row_tiles(const int* __restrict__ seg, int E,
                                         int lane) {
  int total = 0;
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int e = e0 + lane;
    const int nt = e < E ? (seg[e + 1] - seg[e] + kBM - 1) / kBM : 0;
    total += __reduce_add_sync(0xffffffffu, nt);
  }
  return total;
}

// The slot-th 128-row tile in expert order: (expert, first row, segment
// end).  One warp; every lane returns it.
__device__ __forceinline__ int3 row_tile(const int* __restrict__ seg, int E,
                                         int slot, int lane) {
  int base = 0;
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int e = e0 + lane;
    const int lo = e < E ? seg[e] : 0;
    const int hi = e < E ? seg[e + 1] : 0;
    const int nt = (hi - lo + kBM - 1) / kBM;
    int inc = nt;                   // inclusive scan of the tile counts
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += v;
    }
    const int first = base + inc - nt;
    const unsigned hit = __ballot_sync(
        0xffffffffu, nt > 0 && slot >= first && slot < base + inc);
    if (hit != 0u) {
      const int src = __ffs(hit) - 1;
      const int f = __shfl_sync(0xffffffffu, first, src);
      return make_int3(e0 + src,
                       __shfl_sync(0xffffffffu, lo, src) + (slot - f) * kBM,
                       __shfl_sync(0xffffffffu, hi, src));
    }
    base += __shfl_sync(0xffffffffu, inc, 31);
  }
  return make_int3(-1, 0, 0);
}

// A warp's view of its block's work items: item(i) is the block's i-th,
// (expert, first row, segment end, first column), looked up once and kept
struct Walk {
  const int* seg;
  int E, tiles, lane;
  int cached;
  int4 it;

  __device__ __forceinline__ int4 item(int i) {
    if (i != cached) {
      const int t = blockIdx.x + i * gridDim.x;
      const int3 r = row_tile(seg, E, t % tiles, lane);
      it = make_int4(r.x, r.y, r.z, (t / tiles) * kBN);
      cached = i;
    }
    return it;
  }
};

// rows [r0, r0 + rows) of a row-major [*, N] plane of ELEM-byte elements,
// columns [n0, n0 + 256), into `dst` (rows x 256 elements) by the
// producer's 128 threads; rows at or past r_end and columns at or past N
// are zero-filled
template <int ELEM, int CHUNK>
__device__ __forceinline__ void stage_rows(uint8_t* dst, const uint8_t* base,
                                           int r0, int rows, int r_end,
                                           int n0, int N, int tid) {
  constexpr int kRowBytes = kBN * ELEM;
  constexpr int kChunks = kRowBytes / CHUNK;
  for (int i = tid; i < rows * kChunks; i += 128) {
    const int r = i / kChunks, c = i - r * kChunks;
    const int col = n0 + c * (CHUNK / ELEM);
    const bool ok = r0 + r < r_end && col < N;
    const uint8_t* src =
        ok ? base + ((size_t)(r0 + r) * N + col) * ELEM : base;
    hopper::cp_async<CHUNK>(dst + r * kRowBytes + c * CHUNK, src, ok);
  }
}

// one step's packed planes (contraction rows [k0, k0 + 64) of one expert,
// columns [n0, n0 + 256)) into the stage `pl`
template <class T, int CHUNK>
__device__ __forceinline__ void stage_planes(uint8_t* pl, const uint8_t* w,
                                             const uint8_t* hbits,
                                             const uint8_t* s,
                                             const uint8_t* z, int k0,
                                             int n0, int N, int K, int tid) {
  using P = StageBytes<T>;
  const bool byte = T::kLayout == Layout::kByte;
  stage_rows<1, CHUNK>(pl, w, byte ? k0 : k0 / 2, P::kDataRows,
                       byte ? K : K / 2, n0, N, tid);
  if constexpr (T::kLayout == Layout::kBit5)
    stage_rows<1, CHUNK>(pl + P::kData, hbits, k0 / 8, kBK / 8, K / 8, n0, N,
                         tid);
  stage_rows<2, CHUNK>(pl + P::kData + P::kHbits, s, k0 / T::kBS,
                       P::kScaleRows, K / T::kBS, n0, N, tid);
  if constexpr (T::kZeros)
    stage_rows<2, CHUNK>(pl + P::kData + P::kHbits + P::kScales, z,
                         k0 / T::kBS, P::kScaleRows, K / T::kBS, n0, N, tid);
}

// 8 columns (one 16-byte chunk) of weight row k into the weight tile: the
// chunk's 64-column block, then chunk (cg % 8) ^ (k % 8) of row k
__device__ __forceinline__ void put8(uint8_t* wt, int k, int cg,
                                     const float* v) {
  uint4 o;
  o.x = hopper::pack_bf16(v[0], v[1]);
  o.y = hopper::pack_bf16(v[2], v[3]);
  o.z = hopper::pack_bf16(v[4], v[5]);
  o.w = hopper::pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(wt + (cg >> 3) * kNBlock +
                            hopper::sw128_offset(k, cg & 7)) = o;
}

__device__ __forceinline__ void scales8(const uint8_t* plane, int row, int cg,
                                        float* out) {
  const uint4 raw =
      *reinterpret_cast<const uint4*>(plane + (row * kBN + cg * 8) * 2);
  const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    out[2 * e] = __low2float(h[e]);
    out[2 * e + 1] = __high2float(h[e]);
  }
}

// Decode the stage `pl` into the weight tile `wt` (the producer's 128
// threads).  A thread keeps one group of 8 columns (cg = tid % 32) and
// walks rows tid / 32, + 4, ...: its scales and zeros are converted once a
// step, and the block row of each of its rows is known at compile time.
// The codes are taken four columns to a 32-bit word (one byte each: the
// byte layout's rows as stored, the nibble layouts' low or high nibbles
// masked out of a data row, with the fifth bit at bit 4), and the integer
// formats decode as B2's GEMV decodes them, one byte permute and one
// fused multiply-add a weight (int_weight(): bitwise weight_unrounded());
// the others through weight_unrounded().
template <class T>
__device__ __forceinline__ void decode_step(const uint8_t* pl, uint8_t* wt,
                                            const float* tab, int tid) {
  using P = StageBytes<T>;
  constexpr int kRowStep = 4;
  static_assert(kRowStep <= T::kBS / 2, "a step of rows stays in a block");
  const uint8_t* ps = pl + P::kData + P::kHbits;
  const uint8_t* pz = ps + P::kScales;
  const int cg = tid & 31, r0 = tid >> 5;
  // per scale row and column: the integer formats' a and b of
  // int_weight(), the others' scale and zero
  float ca[P::kScaleRows][8], cb[P::kScaleRows][8];
#pragma unroll
  for (int r = 0; r < P::kScaleRows; ++r) {
    float sv[8], zv[8];
    scales8(ps, r, cg, sv);
    if constexpr (T::kZeros) {
      scales8(pz, r, cg, zv);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) zv[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if constexpr (T::kIntBias >= 0) {
        ca[r][e] = __fmul_rn(sv[e], 32768.f);
        cb[r][e] = T::kZeros ? zv[e]
                             : __fmul_rn(sv[e], -(32768.f + T::kIntBias));
      } else {
        ca[r][e] = sv[e];
        cb[r][e] = zv[e];
      }
    }
  }
  // the weights of words w[0] (columns 0-3) and w[1] (4-7) at scale row sr
  auto put = [&](int k, const uint32_t* w, int sr) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t word = w[e >> 2];
      if constexpr (T::kIntBias >= 0)
        v[e] = int_weight<T>(code_float(word, e & 3), ca[sr][e], cb[sr][e]);
      else
        v[e] = weight_unrounded<T>((word >> (8 * (e & 3))) & 0xFF,
                                   ca[sr][e], cb[sr][e], tab);
    }
    put8(wt, k, cg, v);
  };
  if constexpr (T::kLayout == Layout::kByte) {
#pragma unroll
    for (int i = 0; i < kBK / kRowStep; ++i) {
      const int k = r0 + i * kRowStep;
      const uint2 raw =
          *reinterpret_cast<const uint2*>(pl + k * kBN + cg * 8);
      const uint32_t w[2] = {raw.x, raw.y};
      put(k, w, P::kScaleRows == 1 ? 0 : (i * kRowStep) / T::kBS);
    }
  } else {
    constexpr int kHalf = T::kBS / 2;
#pragma unroll
    for (int i = 0; i < (kBK / 2) / kRowStep; ++i) {
      const int dr = r0 + i * kRowStep;
      const int b = (i * kRowStep) / kHalf;     // dr / kHalf
      const int klo = dr + b * kHalf, khi = klo + kHalf;
      const uint2 raw =
          *reinterpret_cast<const uint2*>(pl + dr * kBN + cg * 8);
      uint32_t lo[2] = {raw.x & 0x0F0F0F0Fu, raw.y & 0x0F0F0F0Fu};
      uint32_t hi[2] = {(raw.x >> 4) & 0x0F0F0F0Fu,
                        (raw.y >> 4) & 0x0F0F0F0Fu};
      if constexpr (T::kLayout == Layout::kBit5) {
        const uint8_t* ph = pl + P::kData;
        const uint2 hl =
            *reinterpret_cast<const uint2*>(ph + (klo >> 3) * kBN + cg * 8);
        const uint2 hh =
            *reinterpret_cast<const uint2*>(ph + (khi >> 3) * kBN + cg * 8);
        lo[0] |= ((hl.x >> (klo & 7)) & 0x01010101u) << 4;
        lo[1] |= ((hl.y >> (klo & 7)) & 0x01010101u) << 4;
        hi[0] |= ((hh.x >> (khi & 7)) & 0x01010101u) << 4;
        hi[1] |= ((hh.y >> (khi & 7)) & 0x01010101u) << 4;
      }
      put(klo, lo, b);
      put(khi, hi, b);
    }
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads, 1)
qmm_experts_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                         const uint8_t* __restrict__ w,
                         const __half* __restrict__ s,
                         const __half* __restrict__ z,
                         const float* __restrict__ table,
                         const int* __restrict__ seg,
                         __nv_bfloat16* __restrict__ out_bf16,
                         float* __restrict__ out_f32, int E, int N, int K,
                         long long data_stride, long long scale_stride,
                         int vec16) {
  using T = Traits<F>;
  using P = StageBytes<T>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  __shared__ float tab[16];
  uint8_t* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* wts = smem;                               // 2 weight tiles
  uint8_t* xring = wts + kWSlots * kWBytes;          // 2 x kXStages
  uint8_t* pring = xring + 2 * kXStages * kXBytes;   // kPStages
  if constexpr (T::kTable) {
    if (threadIdx.x < 16) tab[threadIdx.x] = table[threadIdx.x];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x >> 7;                   // 0 producer, 1, 2
  const int tid = threadIdx.x & 127;                 // in the warpgroup
  const int tiles = row_tiles(seg, E, lane);
  const int items = tiles * ((N + kBN - 1) / kBN);
  const int mine = items > (int)blockIdx.x
                       ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int nsteps = (K + kBK - 1) / kBK;
  const int total = mine * nsteps;                   // the block's steps
  Walk ahead{seg, E, tiles, lane, -1, make_int4(0, 0, 0, 0)};
  Walk now = ahead;

  if (wg == 0) {
    // -- the producer: packed planes in, bf16 weight tiles out ----------
    auto issue = [&](int g) {
      if (g < total) {
        const int4 it = ahead.item(g / nsteps);
        const int k0 = (g % nsteps) * kBK;
        const uint8_t* we = w + (size_t)it.x * data_stride;
        const uint8_t* se = reinterpret_cast<const uint8_t*>(
            s + (size_t)it.x * scale_stride);
        const uint8_t* ze = T::kZeros ? reinterpret_cast<const uint8_t*>(
                                            z + (size_t)it.x * scale_stride)
                                      : nullptr;
        uint8_t* pl = pring + (g % kPStages) * P::kBytes;
        const uint8_t* hb = we + (size_t)(K / 2) * N;
        if (vec16)
          stage_planes<T, 16>(pl, we, hb, se, ze, k0, it.w, N, K, tid);
        else
          stage_planes<T, 4>(pl, we, hb, se, ze, k0, it.w, N, K, tid);
      }
      hopper::cp_async_commit();
    };
#pragma unroll
    for (int g = 0; g < kPStages - 1; ++g) issue(g);
    for (int g = 0; g < total; ++g) {
      hopper::cp_async_wait<kPStages - 2>();   // step g's planes (mine)
      // everyone's; and every producer thread is done decoding step g - 1,
      // whose ring stage the next copies refill
      hopper::bar_sync(kBarProducer, 128);
      issue(g + kPStages - 1);
      if (g >= kWSlots)
        hopper::bar_sync(kBarEmpty + g % kWSlots, kThreads);
      decode_step<T>(pring + (g % kPStages) * P::kBytes,
                     wts + (g % kWSlots) * kWBytes, tab, tid);
      hopper::fence_proxy_async();             // visible to wgmma
      hopper::bar_arrive(kBarFull + g % kWSlots, kThreads);
    }
    // the consumers' last two hand-backs
    for (int g = max(0, total - kWSlots); g < total; ++g)
      hopper::bar_sync(kBarEmpty + g % kWSlots, kThreads);
    hopper::cp_async_wait<0>();
    return;
  }

  // -- the consumers: warpgroup c holds rows 64c .. 64c + 63 of each tile --
  const int c = wg - 1;
  const int warp = tid >> 5;                     // in the warpgroup
  uint8_t* xs = xring + c * kXStages * kXBytes;
  auto issue_x = [&](int g) {
    if (g < total) {
      const int4 it = ahead.item(g / nsteps);
      const int k0 = (g % nsteps) * kBK;
      uint8_t* dst = xs + (g % kXStages) * kXBytes;
      // 64 rows x 8 chunks of 16 bytes, K-major, swizzled
#pragma unroll
      for (int i = tid; i < 64 * 8; i += 128) {
        const int row = i >> 3, ch = i & 7;
        const int gr = it.y + 64 * c + row, gk = k0 + ch * 8;
        const bool ok = gr < it.z && gk < K;
        hopper::cp_async<16>(dst + hopper::sw128_offset(row, ch),
                             ok ? x + (size_t)gr * K + gk : x, ok);
      }
    }
    hopper::cp_async_commit();
  };
#pragma unroll
  for (int g = 0; g < kXStages - 2; ++g) issue_x(g);
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  // the step whose weight tile this warpgroup still owes back (its
  // products may be in flight), or -1
  int owed = -1;
  for (int g = 0; g < total; ++g) {
    const int st = g % nsteps;
    const int4 it = now.item(g / nsteps);
    const bool live = it.y + 64 * c < it.z;      // the warpgroup's rows
    const bool last = st == nsteps - 1;
    hopper::cp_async_wait<kXStages - 3>();      // step g's x (mine)
    hopper::fence_proxy_async();
    // everyone's in the warpgroup; and every warp has seen the products of
    // step g - 2 complete, so their x stage can be refilled
    hopper::bar_sync(kBarConsumer + c, 128);
    issue_x(g + kXStages - 2);
    hopper::bar_sync(kBarFull + g % kWSlots, kThreads);
    if (live) {
      const uint8_t* xg = xs + (g % kXStages) * kXBytes;
      const uint8_t* wt = wts + (g % kWSlots) * kWBytes;
      hopper::fence_regs<128>(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        hopper::wgmma_m64n256k16_ss<1>(
            acc, hopper::sw128_desc(xg + kk * 32, 16, 1024),
            hopper::sw128_desc(wt + kk * 16 * 128, kNBlock, 1024),
            (st > 0 || kk > 0) ? 1 : 0);
      hopper::wgmma_commit();
    }
    // step g - 1's products are done (a tile's last step waits for its
    // own, for the epilogue): its weight tile goes back to the producer
    if (last || !live)
      hopper::wgmma_wait<0>();
    else
      hopper::wgmma_wait<1>();
    hopper::fence_regs<128>(acc);
    if (owed >= 0) hopper::bar_arrive(kBarEmpty + owed % kWSlots, kThreads);
    owed = g;
    if (last || !live) {
      hopper::bar_arrive(kBarEmpty + g % kWSlots, kThreads);
      owed = -1;
    }
    if (last && live) {
      // the warp's 16 rows: rows lane / 4 and + 8, columns 2 (lane % 4)
      // of each n8 block; N % 4 == 0, so an even column below N has its
      // neighbour below N too
      const int row0 = it.y + 64 * c + 16 * warp + (lane >> 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = it.w + 128 * h + 8 * j + 2 * (lane & 3);
          if (col >= N) continue;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int row = row0 + 8 * rr;
            if (row >= it.z) continue;
            const float v0 = acc[64 * h + 4 * j + 2 * rr];
            const float v1 = acc[64 * h + 4 * j + 2 * rr + 1];
            if (out_f32 != nullptr)
              *reinterpret_cast<float2*>(out_f32 + (size_t)row * N + col) =
                  make_float2(v0, v1);
            else
              *reinterpret_cast<uint32_t*>(out_bf16 + (size_t)row * N +
                                           col) = hopper::pack_bf16(v0, v1);
          }
        }
      }
    }
  }
  hopper::cp_async_wait<0>();
}

template <int F>
int launch(cudaStream_t st, int grid, const __nv_bfloat16* x,
           const uint8_t* w, const __half* s, const __half* z,
           const float* table, const int* seg, __nv_bfloat16* ob, float* of,
           int E, int N, int K, long long ds, long long ss, int vec16) {
  constexpr int smem = wgmma_smem_bytes<Traits<F>>();
  static_assert(smem <= 232448, "exceeds a block's shared memory");
  cudaError_t e = cudaFuncSetAttribute(
      qmm_experts_wgmma_kernel<F>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  qmm_experts_wgmma_kernel<F><<<grid, kThreads, smem, st>>>(
      x, w, s, z, table, seg, ob, of, E, N, K, ds, ss, vec16);
  return 0;
}

}  // namespace

// x bf16 [P, K] contiguous, 16-byte aligned, its rows sorted by expert;
// seg int32 [E + 1] on the device; data, scales, zeros, table, out and the
// strides as csrc/qmatmul_experts.cu takes them.  grid: the persistent
// blocks (one an SM at most; any count covers every item); vec16 != 0
// when N % 16 == 0 and the planes are 16-byte aligned.  Returns the
// launch's error or cudaGetLastError() (cudaErrorInvalidValue for an
// unknown format).
extern "C" int qmatmul_experts_wgmma(int format, const void* x,
                                     const void* data, const void* scales,
                                     const void* zeros, const void* table,
                                     const void* seg, void* out, int out_f32,
                                     int E, int N, int K,
                                     long long data_stride,
                                     long long scale_stride, int grid,
                                     int vec16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (grid <= 0) return 0;
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
#define QMMW_FORMAT(FID)                                                  \
    case FID:                                                             \
      err = launch<FID>(st, grid, xp, wp, sp, zp, tp, gp, ob, of, E, N, K, \
                        data_stride, scale_stride, vec16);                \
      break;
    QMMW_FORMAT(kSymInt4)
    QMMW_FORMAT(kAsymInt4)
    QMMW_FORMAT(kNF4)
    QMMW_FORMAT(kFP4)
    QMMW_FORMAT(kSymInt5)
    QMMW_FORMAT(kAsymInt5)
    QMMW_FORMAT(kSymInt8)
    QMMW_FORMAT(kFP6)
    QMMW_FORMAT(kFP8E4M3)
    QMMW_FORMAT(kFP8E5M2)
#undef QMMW_FORMAT
    default: err = (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
