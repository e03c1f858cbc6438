// Decode-step (T=1) attention for Hopper over the dense head-major KV cache.
//
// Replaces the TPU kernel
// ipex_llm_tpu/ops/pallas/decode_attention.py::decode_sdpa (body _decode,
// _kernel).  Semantics kept exactly:
//   - q [B, 1, Hq, D] bf16, its query at slot kv_len[b] - 1; head
//     hkv*G + g reads kv head hkv (G = Hq / Hkv);
//   - k/v [B, Hkv, S, D] in storage dtype (bf16 or e5m2; e5m2 widens
//     exactly to bf16, as the TPU kernel's astype(bf16) does);
//   - key slot kpos is visible iff kv_start <= kpos < kv_len and, with the
//     window on for the row, kpos > kv_len - 1 - window;
//   - s = (q . k) * scale in fp32 from bf16 inputs, then softcap
//     tanh(s / c) * c, then the mask; online softmax in fp32; l sums the
//     fp32 p, the P.V product takes p rounded to bf16; one rounding of the
//     output; a row that sees no key gives 0 (l == 0 -> denominator 1).
//
// What bounds it: the bytes of the visible K/V slots (a decode step does
// ~2 operations per byte read), so the card's memory rate.  The design
// keeps many bytes in flight and reads each visible slot once.
//
// Design: the TPU grid walks S in order carrying (m, l, acc) in scratch;
// here each row's *visible* range [lo, kv_len) (lo = kv_start, or with the
// window on kv_len - window) splits over blocks.  The number of splits
// comes from shapes alone (ops/cuda/decode_attention.py::split_plan); each
// block computes its own sub-range from lo and kv_len on the device
// (split_bounds there mirrors it), so every split holds its share of the
// row's visible slots and none is empty while another holds more than one
// tile.  A block owns one (row, kv head, split).  Its K/V tiles of 64 keys
// (contiguous in the head-major layer) stream through a ring of shared
// memory with 16-byte cp.async in the storage type, all of a split's tiles
// in flight at once at the main path's shapes (three stages of 32 KiB for
// bf16; four raw stages of 16 KiB for e5m2, widened into one bf16 tile
// pair in shared memory).  Form chosen: the tensor cores, as B1's key-split
// instance (ragged_paged_attention.cu): the kv head's query rows, up to
// 16 of them padded to one 16-row tile (more: "Any GQA group" below), are
// mma.sync A fragments in registers; each of
// the 4 warps takes a 16-key slice of every tile, computes its scores with
// m16n8k16 (K by ldmatrix), its online softmax in base 2, and P.V with P's
// registers as A fragments (V by ldmatrix.trans).  The kernel is bound by
// bytes, not products: the tensor cores only take the score and value
// arithmetic off the dependent chain of one-key-per-lane loads, so the
// warps keep issuing copies.  The 4 warps' states merge in shared memory
// into the split's fp32 partial (m, l, acc); a second kernel merges a
// head's splits in split order (deterministic, no atomics), skipping
// splits with l = 0, and writes bf16.
//
// Instances of the head dim D at 128 and 256 (Gemma-2).  At 256 a tile
// pair is 64 KiB and the accumulator alone takes 128 registers a thread,
// so that instance keeps the 16 query rows in shared memory (8 KiB) and
// reads each step's A fragment with ldmatrix instead of holding all 16
// steps' fragments in registers, and its three bf16 stages (192 KiB; four
// raw e5m2 stages of 32 KiB and the widened pair) leave room for one
// block an SM instead of two; split_plan reads the resident count.
//
// A third instance, D = 96 (Phi-3-mini), keeps D = 128's shared-memory
// layout: a key's row is 128 columns (256 bytes) wide, so the 16-byte-chunk
// XOR swizzle stays within the row and conflict-free; the kernel stages
// the 96 columns the layer holds (12 chunks a key, the e5m2 rows as the
// 96 bytes stored) and never reads the other 32 (six 16-dim score steps,
// twelve 8-column output tiles), so they need no zeros and the layer in
// HBM is read as stored, unpadded.  Q's 6 steps stay in registers.
//
// A fourth instance reads K and V at different widths: DeepSeek's MLA, K
// at D = 192 (12 score steps, Q's fragments in registers) and V at Dv =
// 128 (16 output tiles).  A K row is 24 chunks (three 128-byte lines: the
// swizzle stays in the row and conflict-free), a V row 16; a stage holds
// a 24 KiB K tile beside a 16 KiB V tile.  So that two blocks still fit an
// SM, that instance keeps one stage fewer than the others (two bf16
// stages, 80 KiB; three raw e5m2 stages of 20 KiB and the widened pair,
// 100 KiB).  The other instances read both at one width, as before.
//
// A fifth instance, D = 80 (Phi-2 and phixtral: 2560 / 32), is the 96 one
// at a narrower width: rows 128 columns wide in shared memory (the swizzle
// stays in the row), the 80 columns the layer holds staged (10 chunks a
// key, the e5m2 rows as the 80 bytes stored), five 16-dim score steps and
// ten 8-column output tiles; 48 of the 128 staged columns are never
// written or read (37.5% of the ring's bytes idle, none of HBM's).  Its
// merge runs 96 threads, three whole warps, the last 16 idle.
//
// Two more serve MiniCPM (and the 64-wide heads of Llama-3.2-1B and
// TinyLlama).  D = 64 (MiniCPM-2B): a 64-column row is eight 16-byte
// chunks, one period of the swizzle, so the rows are native 64-column
// rows (8 KiB a tile, three bf16 stages in 48 KiB); four score steps,
// eight output tiles, a 64-thread merge (two whole warps).  (96, 64)
// (MiniCPM3's MLA: K 64 nope + 32 rope columns, V 64): K rows the 96
// instance's 128-column rows, V rows native 64-column ones, and the
// narrow-V ring of (192, 128), one stage fewer (two bf16 stages of 24
// KiB pairs; three raw e5m2 stages of 12 KiB and the widened pair).
//
// Any GQA group.  A kv head's G query rows run as ceil(G / 16) row tiles
// of the one 16-row mma tile above (Falcon-7B's 71 query heads over one kv
// head: five tiles, rows [0, 16), ..., [64, 71)); each (row tile, split)
// is a block of its own, the tiles of a split adjacent in the grid
// (blockIdx.x = split * tiles + tile), so they are scheduled together and
// every tile after the first finds the split's K/V in L2.  split_plan
// counts the tiles in its wave.  The workspace keeps its [B, Hkv, splits,
// G, Dv] layout: a block writes rows [g0, g0 + 16) of it (clipped at G),
// and the merge, one block a query head, is unchanged.  The other form, a
// block looping over its kv head's tiles against one staged K/V tile,
// stages each visible slot once, but holds an accumulator and softmax
// state per row tile: at D = 128 one accumulator is 64 registers a
// thread, so five would spill.  This form keeps a block's registers as
// they were, and at G <= 16 its grid and plan too (one tile, blockIdx.x =
// split).  What it leaves idle: the last tile's rows past G (9 of 80 at
// G = 71: zero A fragments, never stored), and the L2-to-SM bandwidth of
// the repeated tile reads.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;            // 4 warps
constexpr int kKT = 64;                  // keys per staged tile
constexpr int kKW = kKT / 4;             // keys per warp per tile
constexpr int kRows = 16;                // query rows of the mma tile
constexpr int kMaxSplits = 64;           // decode_attention.py _MAX_SPLITS
constexpr float kNegInf = -1e30f;        // the reference's NEG_INF
constexpr float kFloor = -1e29f;         // the reference's m clamp
constexpr float kLog2e = 1.4426950408889634f;

// blocks an SM holds: 2 of 96 KiB at D = 80, 96 and 128, of 48 (64) or
// 48 and 60 KiB (96, 64), of 80 or 100 KiB at (192, 128), 1 of 200 KiB at
// D = 256
// (decode_attention.py::ring_plan)
template <int D>
constexpr int kResident = D <= 192 ? 2 : 1;

// the columns of a key's row in shared memory: D, or 128 at D = 80, 96
// (at 64 a row is eight chunks, one period of the swizzle)
template <int D>
constexpr int kRowD = D == 64 ? 64 : D < 128 ? 128 : D;

template <typename KV, int D, int Dv>
struct Ring {
  // bf16: 3 stages of (K, V) tiles; e5m2: 4 raw stages (half a bf16 tile
  // each of K and V), then the widened bf16 K/V pair; at D = 256 the 16
  // query rows (bf16, swizzled) after them; one stage fewer at Dv < D
  static constexpr int kTileK = kKT * kRowD<D> * 2;   // one bf16 K tile
  static constexpr int kTileV = kKT * kRowD<Dv> * 2;  // one bf16 V tile
  static constexpr bool kFp8 = sizeof(KV) == 1;
  static constexpr bool kQSmem = D > 192;
  static constexpr int kStages = (kFp8 ? 4 : 3) - (Dv < D ? 1 : 0);
  static constexpr int kStageBytes =
      kFp8 ? (kTileK + kTileV) / 2 : kTileK + kTileV;
  static constexpr int kVOff = kFp8 ? kTileK / 2 : kTileK;  // V after K
  static constexpr int kWiden = kStages * kStageBytes;
  static constexpr int kQOff = kWiden + (kFp8 ? kTileK + kTileV : 0);
  static constexpr int kSmem = kQOff + (kQSmem ? kRows * D * 2 : 0);
};

template <int D>
__device__ __forceinline__ int kv_chunk(int key, int c) {
  // swizzled 16-byte chunk index
  return key * (kRowD<D> / 8) + (c ^ (key & 7));
}

// stage the keys [k0, k0 + 64) of one kv head (as stored: bf16 swizzled,
// e5m2 plain); keys at or past k_end are zeros.  A V row narrower than
// K's (Dv < D) takes the first of each key's chunks
template <typename KV, int D, int Dv>
__device__ __forceinline__ void stage_tile(uint8_t* kd, uint8_t* vd,
                                           const KV* __restrict__ kh,
                                           const KV* __restrict__ vh, int k0,
                                           int k_end) {
  static_assert(Dv <= D, "V is at most K's width");
  constexpr int kChunks = D * (int)sizeof(KV) / 16;   // 16-byte chunks a key
  constexpr int kChunksV = Dv * (int)sizeof(KV) / 16;
  for (int i = threadIdx.x; i < kKT * kChunks; i += kThreads) {
    const int key = i / kChunks, c = i - key * kChunks;
    const int kpos = k0 + key;
    const bool ok = kpos < k_end;
    const size_t row = ok ? (size_t)kpos : 0;
    const int dst = sizeof(KV) == 2 ? kv_chunk<D>(key, c) * 16
                                    : key * (D * (int)sizeof(KV)) + c * 16;
    hopper::cp_async<16>(kd + dst, kh + (ok ? row * D + c * (16 / sizeof(KV))
                                            : 0), ok);
    if (Dv == D || c < kChunksV) {
      const int dst_v = sizeof(KV) == 2
                            ? kv_chunk<Dv>(key, c) * 16
                            : key * (Dv * (int)sizeof(KV)) + c * 16;
      hopper::cp_async<16>(vd + dst_v,
                           vh + (ok ? row * Dv + c * (16 / sizeof(KV)) : 0),
                           ok);
    }
  }
}

// widen an e5m2 tile pair (as stored) into bf16 swizzled tiles: an e5m2
// code is the top byte of an fp16, and every e5m2 value is a bf16 value
template <int D, int Dv>
__device__ __forceinline__ void widen_tile(const uint8_t* kraw,
                                           const uint8_t* vraw, uint8_t* kw,
                                           uint8_t* vw) {
  constexpr int kNK = kKT * (D / 16);        // 16-byte raw chunks of K
  for (int i = threadIdx.x; i < kNK + kKT * (Dv / 16); i += kThreads) {
    const int which = i >= kNK;
    const int rem = i - which * kNK;
    const int w16 = which ? Dv / 16 : D / 16;
    const int key = rem / w16, c = rem % w16;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        (which ? vraw + key * Dv : kraw + key * D) + c * 16);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t o[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // bytes b0..b3 -> fp16 pairs (b0, b1) and (b2, b3)
      const uint32_t lo = ((w[e] & 0xFFu) << 8) | ((w[e] & 0xFF00u) << 16);
      const uint32_t hi = ((w[e] >> 8) & 0xFF00u) | (w[e] & 0xFF000000u);
      const float2 flo = __half22float2(*reinterpret_cast<const __half2*>(&lo));
      const float2 fhi = __half22float2(*reinterpret_cast<const __half2*>(&hi));
      o[2 * e] = hopper::pack_bf16(flo.x, flo.y);
      o[2 * e + 1] = hopper::pack_bf16(fhi.x, fhi.y);
    }
    uint8_t* dst = which ? vw : kw;
    const int c0 = which ? kv_chunk<Dv>(key, 2 * c) : kv_chunk<D>(key, 2 * c);
    const int c1 = which ? kv_chunk<Dv>(key, 2 * c + 1)
                         : kv_chunk<D>(key, 2 * c + 1);
    *reinterpret_cast<uint4*>(dst + c0 * 16) =
        make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(dst + c1 * 16) =
        make_uint4(o[4], o[5], o[6], o[7]);
  }
}

template <typename KV, int D, int Dv, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads, kResident<D>)
decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                    const KV* __restrict__ k, const KV* __restrict__ v,
                    const int* __restrict__ kv_len_arr,
                    const int* __restrict__ kv_start_arr,
                    const int* __restrict__ won_arr,
                    float* __restrict__ ws_acc,    // [B,Hkv,splits,G,Dv]
                    float2* __restrict__ ws_ml,    // [B,Hkv,splits,G]
                    int Hkv, int G, int S, float scale, int window,
                    float softcap) {
  using R = Ring<KV, D, Dv>;
  extern __shared__ __align__(128) uint8_t smem[];

  // blockIdx.x = split * tiles + tile: the block's row tile takes the
  // group's query rows [g0, g0 + rows)
  const int tiles = (G + kRows - 1) / kRows;
  const int split = blockIdx.x / tiles;
  const int g0 = (blockIdx.x - split * tiles) * kRows;
  const int rows = min(kRows, G - g0);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int splits = gridDim.x / tiles;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wk = warp * kKW;                // the warp's key slice

  // the row's visible range and this split's share of it
  // (decode_attention.py::split_bounds)
  const int kv_len = kv_len_arr[b];
  int lo = max(kv_start_arr[b], 0);
  if (window > 0 && won_arr[b] != 0) lo = max(lo, kv_len - window);
  const int hi = min(kv_len, S);
  const int n = max(hi - lo, 0);
  const int per = (n + splits - 1) / splits;
  const int a = lo + split * per;
  const int e = min(hi, a + per);
  const int n_tiles = e > a ? (e - a + kKT - 1) / kKT : 0;

  const size_t head = ((size_t)b * Hkv + h) * (size_t)S;
  const KV* kh = k + head * D;
  const KV* vh = v + head * Dv;
  auto stage_k = [&](int slot) { return smem + slot * R::kStageBytes; };
  auto stage_v = [&](int slot) { return stage_k(slot) + R::kVOff; };
  const int r0 = lane >> 2;
  const size_t qrow = (size_t)b * Hkv * G + (size_t)h * G + g0;
  uint8_t* q_s = smem + R::kQOff;
  if constexpr (R::kQSmem) {
    // the query rows (swizzled like a K tile) join the first tile's group
    for (int i = threadIdx.x; i < kRows * (D / 8); i += kThreads) {
      const int row = i / (D / 8), c = i % (D / 8);
      const bool ok = row < rows;
      hopper::cp_async<16>(q_s + kv_chunk<D>(row, c) * 16,
                           q + (ok ? (qrow + row) * D + c * 8 : 0), ok);
    }
  }
#pragma unroll
  for (int s = 0; s < R::kStages - 1; ++s) {
    if (s < n_tiles)
      stage_tile<KV, D, Dv>(stage_k(s), stage_v(s), kh, vh, a + s * kKT, e);
    hopper::cp_async_commit();
  }

  // the tile's query rows (of 16) as A fragments; rows past G are zero.
  // D = 128: all steps' fragments in registers; D = 256: the rows in
  // shared memory (staged above with the first tile), a step's fragment
  // read with ldmatrix where it is used
  uint32_t qa[R::kQSmem ? 1 : D / 16][4];
  if constexpr (!R::kQSmem) {
    const bool ok0 = r0 < rows, ok1 = r0 + 8 < rows;
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(
        q + (ok0 ? (qrow + r0) * D : 0));
    const uint32_t* q1 = reinterpret_cast<const uint32_t*>(
        q + (ok1 ? (qrow + r0 + 8) * D : 0));
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const int d2 = (kc * 16 + (lane & 3) * 2) / 2;   // in bf16 pairs
      qa[kc][0] = ok0 ? __ldg(q0 + d2) : 0u;
      qa[kc][1] = ok1 ? __ldg(q1 + d2) : 0u;
      qa[kc][2] = ok0 ? __ldg(q0 + d2 + 4) : 0u;
      qa[kc][3] = ok1 ? __ldg(q1 + d2 + 4) : 0u;
    }
  }
  const float sl2 = scale * kLog2e;         // scores in base-2 units
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[Dv / 8][4];
#pragma unroll
  for (int i = 0; i < Dv / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = a + t * kKT;
    {
      const int tn = t + R::kStages - 1;
      if (tn < n_tiles)
        stage_tile<KV, D, Dv>(stage_k(tn % R::kStages),
                              stage_v(tn % R::kStages), kh, vh, a + tn * kKT,
                              e);
      hopper::cp_async_commit();
    }
    hopper::cp_async_wait<R::kStages - 1>();
    __syncthreads();
    const uint8_t* kt;
    const uint8_t* vt;
    if constexpr (R::kFp8) {
      uint8_t* kw = smem + R::kWiden;
      widen_tile<D, Dv>(stage_k(t % R::kStages), stage_v(t % R::kStages), kw,
                        kw + R::kTileK);
      __syncthreads();
      kt = kw;
      vt = kw + R::kTileK;
    } else {
      kt = stage_k(t % R::kStages);
      vt = stage_v(t % R::kStages);
    }
    // warp-uniform: a slice wholly past the split's end changes nothing
    if (k0 + wk < e) {
      float s[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const int key = wk + (lane >> 4) * 8 + (lane & 7);
        const int c = kc * 2 + ((lane >> 3) & 1);
        uint32_t b0, b1, b2, b3;
        hopper::ldsm_x4(b0, b1, b2, b3, kt + kv_chunk<D>(key, c) * 16);
        const uint32_t* af = qa[R::kQSmem ? 0 : kc];
        if constexpr (R::kQSmem) {
          // rows lane % 16, dims 16kc + 8(lane / 16): the m16n8k16 A tile
          hopper::ldsm_x4(qa[0][0], qa[0][1], qa[0][2], qa[0][3],
                          q_s + kv_chunk<D>(lane & 15, kc * 2 + (lane >> 4))
                                    * 16);
        }
        hopper::mma_bf16(s[0], af, b0, b1);
        hopper::mma_bf16(s[1], af, b2, b3);
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kpos = k0 + wk + nt * 8 + (lane & 3) * 2 + (c & 1);
          float x;
          if constexpr (SOFTCAP) {
            x = tanhf(s[nt][c] * scale / softcap) * softcap * kLog2e;
          } else {
            x = s[nt][c] * sl2;
          }
          x = kpos < e ? x : kNegInf;
          s[nt][c] = x;
          mx[c >> 1] = fmaxf(mx[c >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
        mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
        const float m_new = fmaxf(m[row], mx[row]);
        const float m_safe = fmaxf(m_new, kFloor);
        alpha[row] = exp2f(fmaxf(m[row], kFloor) - m_safe);
        m[row] = m_new;
        mx[row] = m_safe;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = exp2f(s[nt][c] - mx[c >> 1]);
          s[nt][c] = p;
          sum[c >> 1] += p;
        }
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        sum[row] += __shfl_xor_sync(0xffffffffu, sum[row], 1);
        sum[row] += __shfl_xor_sync(0xffffffffu, sum[row], 2);
        l[row] = l[row] * alpha[row] + sum[row];
      }
#pragma unroll
      for (int dn = 0; dn < Dv / 8; ++dn) {
        acc[dn][0] *= alpha[0];
        acc[dn][1] *= alpha[0];
        acc[dn][2] *= alpha[1];
        acc[dn][3] *= alpha[1];
      }
      // P.V over the slice's 16 keys, p rounded to bf16
      const uint32_t pa[4] = {hopper::pack_bf16(s[0][0], s[0][1]),
                              hopper::pack_bf16(s[0][2], s[0][3]),
                              hopper::pack_bf16(s[1][0], s[1][1]),
                              hopper::pack_bf16(s[1][2], s[1][3])};
      const int key = wk + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int dn = 0; dn < Dv / 8; dn += 2) {
        uint32_t b0, b1, b2, b3;
        hopper::ldsm_x4_trans(b0, b1, b2, b3,
                              vt + kv_chunk<Dv>(key, dn + (lane >> 4)) * 16);
        hopper::mma_bf16(acc[dn], pa, b0, b1);
        hopper::mma_bf16(acc[dn + 1], pa, b2, b3);
      }
    }
    __syncthreads();       // the tile's slot is refilled next iteration
  }
  hopper::cp_async_wait<0>();

  // merge the four warps' key slices in warp order, in shared memory
  float* acc_s = reinterpret_cast<float*>(smem);          // [4][16][Dv]
  float2* ml_s = reinterpret_cast<float2*>(smem + 4 * kRows * Dv * 4);
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int i = r0 + 8 * row;
    if (i >= rows) continue;
    float* dst = acc_s + (warp * kRows + i) * Dv;
#pragma unroll
    for (int dn = 0; dn < Dv / 8; ++dn) {
      const int d = dn * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(dst + d) =
          make_float2(acc[dn][2 * row], acc[dn][2 * row + 1]);
    }
    if ((lane & 3) == 0) ml_s[warp * kRows + i] = make_float2(m[row], l[row]);
  }
  __syncthreads();
  const size_t ws_row = (((size_t)b * Hkv + h) * splits + split) * G + g0;
  for (int i = 0; i < rows; ++i) {
    float m_all = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 ml = ml_s[w * kRows + i];
      if (ml.y > 0.f) m_all = fmaxf(m_all, ml.x);
    }
    const float m_ref = fmaxf(m_all, kFloor);
#pragma unroll
    for (int dd = 0; dd < (Dv + kThreads - 1) / kThreads; ++dd) {
      const int d = threadIdx.x + dd * kThreads;
      if (Dv % kThreads != 0 && d >= Dv) break;
      float lsum = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float2 ml = ml_s[w * kRows + i];
        if (!(ml.y > 0.f)) continue;
        const float wt = exp2f(fmaxf(ml.x, kFloor) - m_ref);
        lsum = fmaf(ml.y, wt, lsum);
        o = fmaf(acc_s[(w * kRows + i) * Dv + d], wt, o);
      }
      ws_acc[(ws_row + i) * Dv + d] = o;
      if (d == 0) ws_ml[ws_row + i] = make_float2(m_all, lsum);
    }
  }
}

// whole warps of D threads or more (96 at D = 80)
template <int D>
constexpr int kMergeThreads = (D + 31) / 32 * 32;

// one block of kMergeThreads<D> threads per (q head, row): merges the
// head's splits in split order and writes bf16.  Thread s < splits reads
// split s's (m, l) and sets its weight in shared memory (0 for a split
// that saw no visible key, l == 0); then thread d < D sums output dim d
// over the splits, its loads independent of each other.  m is in base-2
// units, as the split kernel keeps it.
template <int D>
__global__ void __launch_bounds__(kMergeThreads<D>)
decode_merge_kernel(const float* __restrict__ ws_acc,
                    const float2* __restrict__ ws_ml,
                    __nv_bfloat16* __restrict__ out, int Hkv, int G,
                    int splits) {
  __shared__ float wt_s[kMaxSplits], l_s[kMaxSplits], m_s[2];
  const int hq = blockIdx.x;
  const int b = blockIdx.y;
  const int h = hq / G, g = hq % G;
  const int d = threadIdx.x;
  const size_t base = ((size_t)b * Hkv + h) * splits * (size_t)G + g;
  float2 ml = make_float2(kNegInf, 0.f);
  if (d < splits) ml = ws_ml[base + (size_t)d * G];
  const bool live = ml.y > 0.f;
  float mv = live ? ml.x : kNegInf;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mv = fmaxf(mv, __shfl_xor_sync(0xffffffffu, mv, o));
  if ((d & 31) == 0 && d < 64) m_s[d >> 5] = mv;    // splits <= 64
  __syncthreads();
  const float m_ref = fmaxf(fmaxf(m_s[0], m_s[1]), kFloor);
  if (d < splits) {
    wt_s[d] = live ? exp2f(fmaxf(ml.x, kFloor) - m_ref) : 0.f;
    l_s[d] = live ? ml.y : 0.f;
  }
  __syncthreads();
  if (D % 32 != 0 && d >= D) return;
  float lt = 0.f, o = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) {
    const float w = wt_s[s];
    const float a = ws_acc[(base + (size_t)s * G) * D + d];
    if (w != 0.f) {
      lt = fmaf(l_s[s], w, lt);
      o = fmaf(a, w, o);
    }
  }
  out[((size_t)b * Hkv * G + hq) * D + d] =
      __float2bfloat16_rn(o / (lt == 0.f ? 1.f : lt));
}

template <typename KV, int D, int Dv, bool SOFTCAP>
int launch(dim3 grid, cudaStream_t st, const void* q, const void* k,
           const void* v, const void* kv_len, const void* kv_start,
           const void* won, void* ws_acc, void* ws_ml, int Hkv, int G, int S,
           float scale, int window, float softcap) {
  constexpr int kSmem = Ring<KV, D, Dv>::kSmem;
  static_assert(kSmem <= 232448, "the ring exceeds a block's shared memory");
  static_assert(kResident<D> * (kSmem + 1024) <= 233472,
                "the resident blocks fit an SM");
  static_assert(4 * kRows * Dv * 4 + 4 * kRows * 8 <= kSmem,
                "the warp merge fits the ring's bytes");
  cudaError_t e = cudaFuncSetAttribute(
      decode_split_kernel<KV, D, Dv, SOFTCAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  decode_split_kernel<KV, D, Dv, SOFTCAP><<<grid, kThreads, kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const int*>(kv_len),
      static_cast<const int*>(kv_start), static_cast<const int*>(won),
      static_cast<float*>(ws_acc), static_cast<float2*>(ws_ml), Hkv, G, S,
      scale, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// q bf16 [B,1,Hq,D]; k [B,Hkv,S,D] and v [B,Hkv,S,Dv] bf16 (kv_fp8=0) or
// e5m2 (kv_fp8=1), contiguous, 16-byte aligned; kv_len, kv_start, won
// int32 [B]; out bf16 [B,1,Hq,Dv]; ws_acc fp32 [B,Hkv,splits,G,Dv] and
// ws_ml fp32 [B,Hkv,splits,G,2] scratch.  (D, Dv) = (64, 64), (80, 80),
// (96, 64), (96, 96), (128, 128), (192, 128) or (256, 256), any G =
// Hq/Hkv, splits <= 64; window <= 0 means none, softcap <= 0 none.
// Launches the split kernel over (splits * ceil(G / 16), Hkv, B) blocks
// and the merge kernel; returns the first non-zero cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported pair or split count).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* kv_len, const void* kv_start,
                                const void* won, void* out, void* ws_acc,
                                void* ws_ml, int B, int Hq, int Hkv, int S,
                                int D, int Dv, int splits, int kv_fp8, float scale,
                                int window, float softcap, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool pair = D == Dv ? (D == 64 || D == 80 || D == 96 || D == 128 ||
                               D == 256)
                            : ((D == 192 && Dv == 128) ||
                               (D == 96 && Dv == 64));
  if (!pair || Hkv < 1 || Hq % Hkv || splits < 1 || splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const dim3 grid(splits * ((G + kRows - 1) / kRows), Hkv, B);
  const bool cap = softcap > 0.f;
  int err;
#define DECODE_LAUNCH(KV, HD, HDV, CAP)                                     \
  launch<KV, HD, HDV, CAP>(grid, st, q, k, v, kv_len, kv_start, won, ws_acc,     \
                      ws_ml, Hkv, G, S, scale, window, softcap)
#define DECODE_LAUNCH_D(HD, HDV)                                            \
  (kv_fp8 ? (cap ? DECODE_LAUNCH(uint8_t, HD, HDV, true)                    \
                 : DECODE_LAUNCH(uint8_t, HD, HDV, false))                  \
          : (cap ? DECODE_LAUNCH(uint16_t, HD, HDV, true)                   \
                 : DECODE_LAUNCH(uint16_t, HD, HDV, false)))
  err = D == 128   ? DECODE_LAUNCH_D(128, 128)
        : D == 256 ? DECODE_LAUNCH_D(256, 256)
        : D == 192 ? DECODE_LAUNCH_D(192, 128)
        : D == 96  ? (Dv == 64 ? DECODE_LAUNCH_D(96, 64)
                               : DECODE_LAUNCH_D(96, 96))
        : D == 64  ? DECODE_LAUNCH_D(64, 64)
                   : DECODE_LAUNCH_D(80, 80);
#undef DECODE_LAUNCH_D
#undef DECODE_LAUNCH
  if (err) return err;
  const dim3 mgrid(Hq, B);
#define DECODE_MERGE(HDV)                                                   \
  decode_merge_kernel<HDV><<<mgrid, kMergeThreads<HDV>, 0, st>>>(           \
      static_cast<const float*>(ws_acc), static_cast<const float2*>(ws_ml), \
      static_cast<__nv_bfloat16*>(out), Hkv, G, splits)
  if (Dv == 64)
    DECODE_MERGE(64);
  else if (Dv == 80)
    DECODE_MERGE(80);
  else if (Dv == 96)
    DECODE_MERGE(96);
  else if (Dv == 128)
    DECODE_MERGE(128);
  else
    DECODE_MERGE(256);
#undef DECODE_MERGE
  return (int)cudaGetLastError();
}
