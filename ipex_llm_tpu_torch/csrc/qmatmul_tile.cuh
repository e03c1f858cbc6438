// The tiled tensor-core tile of the dequant-matmul: a cp.async ring of x
// and packed planes, the decode to a bf16 weight tile in shared memory, and
// mma.sync.  B2's tiled instance (csrc/qmatmul.cu, whose head comment
// describes the design and its bound) and the expert-grouped kernel B2e
// (csrc/qmatmul_experts.cu) both run it; each picks its block's tile, row
// limit and weight planes and calls qmm_tc_tile().
#pragma once

#include "qmatmul_formats.cuh"

namespace {

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

// one 16-byte chunk (8 columns) of weight row k into the swizzled bf16
// tile wt [kTK x kTN] (chunk cg of row k at chunk cg ^ (k % 8))
__device__ __forceinline__ void put_chunk(__nv_bfloat16* wt, int k, int cg,
                                          const float* v) {
  uint4 o;
  o.x = hopper::pack_bf16(v[0], v[1]);
  o.y = hopper::pack_bf16(v[2], v[3]);
  o.z = hopper::pack_bf16(v[4], v[5]);
  o.w = hopper::pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(wt + k * kTN + ((cg ^ (k & 7)) << 3)) = o;
}

// eight fp16 values of row `row`, columns 8cg..8cg+7, of a staged
// [*, kTN] plane, in fp32
__device__ __forceinline__ void scales8(const uint8_t* plane, int row, int cg,
                                        float* out) {
  const uint4 raw =
      *reinterpret_cast<const uint4*>(plane + (row * kTN + cg * 8) * 2);
  const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    out[2 * e] = __low2float(h[e]);
    out[2 * e + 1] = __high2float(h[e]);
  }
}

// Decode one step's staged packed planes `pl` (StagePlanes<T>'s layout:
// data, fifth bits, scales, zeros; kTK contraction rows x kTN columns)
// into the bf16 tile wt [kTK x kTN], swizzled as put_chunk() writes it,
// bitwise the weights the plain version uses; THR threads take part, tid
// being this one.  A thread keeps one group of 8 columns (cg) and walks
// rows r0, r0 + kRowStep, ...: its scales and zeros are converted once a
// step, the block row of each of its rows is known at compile time, and
// the rows are unrolled so that their shared-memory reads are in flight
// together.  B2's tiled instance (qmm_tc_tile below) and B2's input
// gradient (csrc/qmatmul_dx.cu) both decode through it.
template <class T, int THR>
__device__ __forceinline__ void decode_step(const uint8_t* pl,
                                            const float* tab,
                                            __nv_bfloat16* wt, int tid) {
  using P = StagePlanes<T>;
  constexpr int kRowStep = THR / 16;
  static_assert(kRowStep <= T::kBS / 2, "a step of rows stays in a block");
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
      put_chunk(wt, k, cg, v);
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
      put_chunk(wt, klo, cg, vl);
      put_chunk(wt, khi, cg, vh);
    }
  }
}

// One block's BM x 128 output tile: rows [m0, min(m0 + BM, M)) of x (row
// stride K) against columns [n0, n0 + 128) of the planes, over the
// contraction rows of K split `split` (qb_per_split quantization blocks
// each); the rows' outputs go to out (or to the split's fp32 partial).
// smem is the block's dynamic shared memory, tc_smem_bytes<T, BM>() bytes.
template <int F, int BM>
__device__ __forceinline__ void qmm_tc_tile(
    uint8_t* smem, const __nv_bfloat16* __restrict__ x,
    const uint8_t* __restrict__ w, const uint8_t* __restrict__ hbits,
    const __half* __restrict__ s, const __half* __restrict__ z,
    const float* __restrict__ table, float* __restrict__ partial,
    __nv_bfloat16* __restrict__ out_bf16, float* __restrict__ out_f32,
    int m0, int n0, int split, int M, int N, int K, int qb_per_split,
    int vec16) {
  using T = Traits<F>;
  using S = TileShape<BM>;
  using P = StagePlanes<T>;
  constexpr int kThr = S::kThreads;
  constexpr int kABytes = BM * kTK * 2;
  constexpr int kStage = tc_stage_bytes<T, BM>();
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

  // decode the packed planes of `slot` into the bf16 tile wt [64 x 128]
  auto decode = [&](int slot, __nv_bfloat16* wt) {
    decode_step<T, kThr>(smem + slot * kStage + kABytes, tab, wt, tid);
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

}  // namespace
