// The GEMV block of the dequant-matmul (M <= 8 rows of x): the decode of
// each lane's packed planes straight into mma.sync A fragments, a cp.async
// ring per warp, and the K split over the warps of a block and the blocks
// of a thread-block cluster, summed in (distributed) shared memory in split
// order.  B2's GEMV instance (csrc/qmatmul.cu, whose head comment describes
// the design and its bound) and the expert-grouped kernel's GEMV instance
// (B2e, csrc/qmatmul_experts_gemv.cu) both run it; each picks its block's
// rows of x, weight planes and output rows and calls qmm_gemv_block().
#pragma once

#include "qmatmul_formats.cuh"

namespace {

constexpr int kGemvWarps = 4;
constexpr int kGemvThreads = 32 * kGemvWarps;
constexpr int kGemvCols = 128;      // output columns per warp
constexpr int kGemvStages = 4;      // k-steps in a warp's ring
constexpr int kLaneChunk = 16;      // bytes a lane copies per ring chunk
constexpr int kWarpChunk = 32 * kLaneChunk;

// A k-step is 16 contraction rows.  The 16-byte chunks one lane copies for
// a k-step: its packed data rows (2 nibble rows or 4 byte rows) and its two
// fifth-bit rows (5-bit formats); and for a quantization block, on the
// block's first k-step, the block's scales and zeros of its 16 columns (2
// chunks each), into a slot of their own.  A warp's ring holds kGemvStages
// k-steps and kBlockSlots blocks' scales: enough that a block's slot is
// refilled only after its first k-step has read it.
template <class T>
struct GemvStage {
  static constexpr int kSteps = T::kBS / 16;       // k-steps per quant block
  static constexpr int kData = T::kLayout == Layout::kByte ? 4 : 2;
  static constexpr int kBits = T::kLayout == Layout::kBit5 ? 2 : 0;
  static constexpr int kStepChunks = kData + kBits;
  static constexpr int kBlockChunks = T::kZeros ? 4 : 2;
  static constexpr int kBlockSlots = (kGemvStages - 1) / kSteps + 1;
  static constexpr int kBlockBase = kGemvStages * kStepChunks * kWarpChunk;
  static constexpr int kWarpBytes =
      kBlockBase + kBlockSlots * kBlockChunks * kWarpChunk;
  // x rows are padded so that the lanes' B-fragment reads (4 bytes at
  // stride 2t for the nibble layouts, 8 bytes at 4t for the byte layout)
  // fall in distinct banks across the 8 rows
  static constexpr int kXPad = T::kLayout == Layout::kByte ? 16 : 8;
};

// dynamic shared memory of one block: the warps' rings, x (MT rows of
// x_rows contraction rows, bf16) and the 16-entry code table
template <class T, int MT>
__host__ __device__ constexpr int gemv_smem_bytes(int x_rows) {
  return kGemvWarps * GemvStage<T>::kWarpBytes +
         MT * (x_rows + GemvStage<T>::kXPad) * 2 + 16 * 4;
}

// The products are mma.sync m16n8k16 with the decoded weights as A (16
// output columns x 16 contraction rows) and x as B (16 rows x 8, rows of
// x past M zero).  Lane l (g = l / 4, t = l % 4) of a warp owns the 16
// neighbouring columns n0 + 16g .. n0 + 16g + 15 of the warp's 128, and in
// each of the warp's 8 A tiles T the two columns 16g + 2T (A row g) and
// 16g + 2T + 1 (A row g + 8); the k index of each A row is a permutation
// of the k-step's 16 rows chosen so that the lane reads whole 16-byte
// chunks of its own columns:
//   byte layout:   rows 4t .. 4t+3 of the k-step; A k (2t, 2t+1) is rows
//                  4t, 4t+1 and A k (2t+8, 2t+9) rows 4t+2, 4t+3;
//   nibble layouts: k-step s of a block reads data rows 8s + 2t and
//                  8s + 2t + 1; their low nibbles (block rows 8s + 2t, +1)
//                  are A k (2t, 2t+1), their high nibbles (block rows
//                  BS/2 + 8s + 2t, +1) A k (2t+8, 2t+9).
// x's B fragment follows the same permutation, so each lane reads its two
// registers of row m = g from shared memory in one 8-byte or two 4-byte
// loads.  D tile T holds out[2t][16g + 2T], out[2t + 1][16g + 2T] and the
// same two rows at column 16g + 2T + 1.
//
// One block of a grid of (cluster ranks, column blocks): the block of
// cluster rank `rank` (of `cs`) at column block `col_block`.  A block is 4
// warps, warps_k along K and 4 / warps_k along N (128 columns each); its
// MT rows of x (rows past M zero) are x's first rows, row stride K, and
// its outputs out's first M rows, row stride N.  Split s = rank * warps_k +
// wk owns quantization blocks [s * qb_per_warp, (s + 1) * qb_per_warp).
// Each warp keeps a ring of kGemvStages k-steps, filled with 16-byte (or
// 4-byte, where N % 16 != 0) cp.async that each lane reads back itself, so
// the ring needs no barrier.  At the end the warps' fp32 D tiles meet in
// shared memory; after a cluster barrier, rank r sums its share of the
// column block's outputs over every (rank, warp) in split order, reading
// the other blocks' shared memory (distributed shared memory), and writes
// them.  The caller's second cluster barrier (or, with cs == 1, a block
// barrier before the shared memory is reused) keeps each block resident
// until its partials have been read.
template <int F, int MT, bool VEC16>
__device__ __forceinline__ void qmm_gemv_block(
    uint8_t* smem, const __nv_bfloat16* __restrict__ x,
    const uint8_t* __restrict__ w, const uint8_t* __restrict__ hbits,
    const __half* __restrict__ s, const __half* __restrict__ z,
    const float* __restrict__ table, __nv_bfloat16* __restrict__ out_bf16,
    float* __restrict__ out_f32, int M, int N, int K, int warps_k,
    int qb_per_warp, int col_block, int cs, int rank) {
  using T = Traits<F>;
  using G = GemvStage<T>;
  constexpr int kBS = T::kBS;
  constexpr int kSteps = G::kSteps;
  constexpr int kHalf = kBS / 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int warps_n = kGemvWarps / warps_k;
  const int wn = warp % warps_n, wk = warp / warps_n;
  const int nqb = K / kBS;
  // the block's contraction rows (its x stage) and the warp's blocks
  const int qb_block = rank * warps_k * qb_per_warp;
  const int x_rows = warps_k * qb_per_warp * kBS;
  const int kx0 = qb_block * kBS;
  const int kx1 = min(K, kx0 + x_rows);
  const int qb0 = qb_block + wk * qb_per_warp;
  const int qb1 = min(nqb, qb0 + qb_per_warp);
  const int n_warp = (col_block * warps_n + wn) * kGemvCols;
  const int n_lane = n_warp + 16 * g;         // the lane's first column
  const int nsteps = (qb1 > qb0 && n_warp < N) ? (qb1 - qb0) * kSteps : 0;
  const int xs_stride = x_rows + G::kXPad;
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(smem + kGemvWarps * G::kWarpBytes);
  float* tab = reinterpret_cast<float*>(xs + MT * xs_stride);

  // x: MT rows of the block's contraction rows, bf16, rows past M zero
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    for (int c = tid; c < x_rows / 8; c += kGemvThreads) {
      const int k = kx0 + c * 8;
      const bool ok = m < M && k < kx1;
      hopper::cp_async<16>(xs + m * xs_stride + c * 8,
                           ok ? x + (size_t)m * K + k : x, ok);
    }
  }
  hopper::cp_async_commit();
  if constexpr (T::kTable) {
    if (tid < 16) tab[tid] = table[tid];
  }

  // the lane's ring chunks as shared-window addresses: chunk c of step
  // slot i at step_s + (i * kStepChunks + c) * kWarpChunk, of block slot i
  // at block_s + (i * kBlockChunks + c) * kWarpChunk
  const uint32_t step_s =
      hopper::smem_addr(smem + warp * G::kWarpBytes) + lane * kLaneChunk;
  const uint32_t block_s = step_s + G::kBlockBase;
  const bool col_ok = n_lane < N;
  // 16 bytes of a row-major [*, N] plane of ELEM-byte elements at `src`
  // (row start + the lane's column col0) into the chunk at `dst`
  auto copy = [&](uint32_t dst, const uint8_t* src, int col0, int elem) {
    if constexpr (VEC16) {
      hopper::cp_async_s<16>(dst, col_ok ? src : w, col_ok);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const bool ok = col0 + p * (4 / elem) < N;
        hopper::cp_async_s<4>(dst + 4 * p, ok ? src + 4 * p : w, ok);
      }
    }
  };
  // the lane's sources, advanced as steps are issued in order: its first
  // data row (byte layout rows 16 st + 4t + d, nibble layouts data rows
  // 8 st + 2t + d, st counted from the warp's first block), its block's
  // fifth-bit rows and its block's scales (and zeros)
  constexpr int kRowsPerStep = T::kLayout == Layout::kByte ? 16 : 8;
  const size_t step_bytes = (size_t)kRowsPerStep * N;
  const uint8_t* wsrc =
      w + ((size_t)qb0 * kSteps * kRowsPerStep +
           (T::kLayout == Layout::kByte ? 4 : 2) * t) * N + n_lane;
  const uint8_t* hsrc = hbits + (size_t)qb0 * 4 * N + n_lane;
  const size_t soff = ((size_t)qb0 * N + n_lane) * 2;
  const uint8_t* ssrc = reinterpret_cast<const uint8_t*>(s) + soff;
  const uint8_t* zsrc = reinterpret_cast<const uint8_t*>(z) + soff;
  auto issue = [&](int st) {
    const uint32_t dst = step_s + (st % kGemvStages) * G::kStepChunks * kWarpChunk;
    const int si = st % kSteps;
#pragma unroll
    for (int d = 0; d < G::kData; ++d)
      copy(dst + d * kWarpChunk, wsrc + d * N, n_lane, 1);
    wsrc += step_bytes;
    if constexpr (T::kLayout == Layout::kBit5) {
      copy(dst + 2 * kWarpChunk, hsrc + si * N, n_lane, 1);
      copy(dst + 3 * kWarpChunk, hsrc + (2 + si) * N, n_lane, 1);
      if (si == kSteps - 1) hsrc += 4 * (size_t)N;
    }
    if (si == 0) {      // in the same commit group as the block's first step
      const uint32_t bdst = block_s + ((st / kSteps) % G::kBlockSlots) *
                                          G::kBlockChunks * kWarpChunk;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        copy(bdst + h * kWarpChunk, ssrc + 16 * h, n_lane + 8 * h, 2);
        if constexpr (T::kZeros)
          copy(bdst + (2 + h) * kWarpChunk, zsrc + 16 * h, n_lane + 8 * h, 2);
      }
      ssrc += 2 * (size_t)N;
      if constexpr (T::kZeros) zsrc += 2 * (size_t)N;
    }
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // per column of the lane: the integer formats' a and b of int_weight(),
  // the others' scale and zero
  float ca[16], cb[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) ca[c] = cb[c] = 0.f;

#pragma unroll
  for (int p = 0; p < kGemvStages - 1; ++p) {
    if (p < nsteps) issue(p);
    hopper::cp_async_commit();
  }
  hopper::cp_async_wait<kGemvStages - 1>();   // this thread's x copies
  __syncthreads();                            // every thread's, and the table
  // x's B column m = g: the step's rows from the warp's first block
  const uint32_t x_s = hopper::smem_addr(xs + g * xs_stride) +
                       2 * ((qb0 * kBS - kx0) +
                            (T::kLayout == Layout::kByte ? 4 : 2) * t);
  const bool x_ok = g < MT;

  for (int st = 0; st < nsteps; ++st) {
    hopper::cp_async_wait<kGemvStages - 2>();   // step st has landed
    const uint32_t slot =
        step_s + (st % kGemvStages) * G::kStepChunks * kWarpChunk;
    const int si = st % kSteps;
    uint4 dat[G::kData], bit[2];
#pragma unroll
    for (int d = 0; d < G::kData; ++d)
      dat[d] = hopper::lds128(slot + d * kWarpChunk);
    if constexpr (T::kLayout == Layout::kBit5) {
#pragma unroll
      for (int d = 0; d < 2; ++d)
        bit[d] = hopper::lds128(slot + (2 + d) * kWarpChunk);
    }
    if (si == 0) {                              // a new quant block
      const uint32_t bslot = block_s + ((st / kSteps) % G::kBlockSlots) *
                                           G::kBlockChunks * kWarpChunk;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 raw = hopper::lds128(bslot + h * kWarpChunk);
        const __half2* p = reinterpret_cast<const __half2*>(&raw);
        float zr[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if constexpr (T::kZeros) {
          const uint4 zraw = hopper::lds128(bslot + (2 + h) * kWarpChunk);
          const __half2* q = reinterpret_cast<const __half2*>(&zraw);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            zr[2 * e] = __low2float(q[e]);
            zr[2 * e + 1] = __high2float(q[e]);
          }
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int c = 8 * h + e;
          const float sv = (e & 1) ? __high2float(p[e >> 1])
                                   : __low2float(p[e >> 1]);
          if constexpr (T::kIntBias >= 0) {
            ca[c] = __fmul_rn(sv, 32768.f);
            cb[c] = T::kZeros ? zr[e]
                              : __fmul_rn(sv, -(32768.f + T::kIntBias));
          } else {
            ca[c] = sv;
            cb[c] = zr[e];
          }
        }
      }
    }
    // x's B fragment: the byte layout's rows 4t .. 4t+3 of the step in one
    // load; the nibble layouts' rows 2t, 2t+1 and the same + BS/2
    uint32_t b0 = 0u, b1 = 0u;
    if (x_ok) {
      const uint32_t xa =
          x_s + 2 * ((st / kSteps) * kBS + si * kRowsPerStep);
      if constexpr (T::kLayout == Layout::kByte) {
        const uint2 v = hopper::lds64(xa);
        b0 = v.x;
        b1 = v.y;
      } else {
        b0 = hopper::lds32(xa);
        b1 = hopper::lds32(xa + 2 * kHalf);
      }
    }
    __syncwarp();       // the slot refilled below was read a step earlier
    if (st + kGemvStages - 1 < nsteps) issue(st + kGemvStages - 1);
    hopper::cp_async_commit();

    // the step's codes as words of 4 columns: the byte layout's data rows
    // as stored; the nibble layouts' low and high nibbles of each data row
    // (with the fifth bit at bit 4 of each byte for the 5-bit formats)
    uint32_t wrd[4][4];                 // [A k pair][word of 4 columns]
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (T::kLayout == Layout::kByte) {
        const uint32_t v[4] = {dat[q].x, dat[q].y, dat[q].z, dat[q].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) wrd[q][i] = v[i];
      } else {
        const int d = q & 1, hi = q >> 1;     // data row d, high nibbles
        const uint32_t v[4] = {dat[d].x, dat[d].y, dat[d].z, dat[d].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t c = (hi ? v[i] >> 4 : v[i]) & 0x0F0F0F0Fu;
          if constexpr (T::kLayout == Layout::kBit5) {
            // block rows 8si + 2t + d (bit-plane row si) and 16 + the
            // same (row 2 + si): bit 2t + d of each column's byte
            const uint32_t bv[4] = {bit[hi].x, bit[hi].y, bit[hi].z,
                                    bit[hi].w};
            c |= ((bv[i] >> (2 * t + d)) & 0x01010101u) << 4;
          }
          wrd[q][i] = c;
        }
      }
    }
    // weight of column c (0..15) from k-pair word q: A k (2t, 2t+1) are
    // q = 0, 1 and A k (2t+8, 2t+9) q = 2, 3
    auto wt = [&](int q, int c) -> float {
      const uint32_t word = wrd[q][c >> 2];
      if constexpr (T::kIntBias >= 0)
        return int_weight<T>(code_float(word, c & 3), ca[c], cb[c]);
      else
        return weight_unrounded<T>((word >> (8 * (c & 3))) & 0xFF, ca[c],
                                   cb[c], tab);
    };
#pragma unroll
    for (int tile = 0; tile < 8; ++tile) {
      const int c0 = 2 * tile, c1 = c0 + 1;   // A rows g and g + 8
      const uint32_t a[4] = {hopper::pack_bf16(wt(0, c0), wt(1, c0)),
                             hopper::pack_bf16(wt(0, c1), wt(1, c1)),
                             hopper::pack_bf16(wt(2, c0), wt(3, c0)),
                             hopper::pack_bf16(wt(2, c1), wt(3, c1))};
      hopper::mma_bf16(acc[tile], a, b0, b1);
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();              // every warp is done with its ring

  // the warps' D tiles, [warp][tile][lane] float4, over the rings
  float4* red = reinterpret_cast<float4*>(smem);
#pragma unroll
  for (int tile = 0; tile < 8; ++tile)
    red[(warp * 8 + tile) * 32 + lane] =
        make_float4(acc[tile][0], acc[tile][1], acc[tile][2], acc[tile][3]);
  if (cs > 1)
    hopper::cluster_sync();
  else
    __syncthreads();
  // rank r sums its share of the column block's warps_n * 256 float4s over
  // the splits in order (rank, then the block's warps along K)
  const int total = warps_n * 256;
  const int share = (total + cs - 1) / cs;
  const int i_end = min(total, (rank + 1) * share);
  for (int i = rank * share + tid; i < i_end; i += kGemvThreads) {
    const int wn_i = i >> 8, rest = i & 255;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < cs; ++q) {
      for (int kk = 0; kk < warps_k; ++kk) {
        const float4* p = red + (kk * warps_n + wn_i) * 256 + rest;
        const float4 v =
            cs > 1 ? hopper::ld_cluster_f4(hopper::map_rank(p, q)) : *p;
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
    }
    const int tile = rest >> 5, ln = rest & 31;
    const int n =
        (col_block * warps_n + wn_i) * kGemvCols + 16 * (ln >> 2) + 2 * tile;
    const int m0 = 2 * (ln & 3);
    if (n >= N) continue;           // N % 4 == 0: n even, n + 1 < N too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + h;
      if (m >= M) break;
      const float v0 = h ? sum.y : sum.x;   // column n
      const float v1 = h ? sum.w : sum.z;   // column n + 1
      if (out_f32 != nullptr)
        *reinterpret_cast<float2*>(out_f32 + (size_t)m * N + n) =
            make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(out_bf16 + (size_t)m * N + n) =
            hopper::pack_bf16(v0, v1);
    }
  }
}

}  // namespace
