// Ragged paged attention for Hopper: ONE kernel for every row shape of an
// engine tick (decode rows, right-padded prefill chunks, idle rows), reading
// K/V straight off the paged pool through each row's block table.
//
// Replaces the TPU kernel
// ipex_llm_tpu/ops/pallas/ragged_paged_attention.py::ragged_paged_sdpa
// (body _ragged, _kernel).  Semantics kept exactly:
//   - q [R, C, Hq, D] bf16; the query at chunk index c of row r sits at slot
//     kv_len[r] - chunk_len[r] + c; head hq reads kv head hq / (Hq/Hkv); a
//     block's query rows are the GQA group x chunk flattened chunk-minor
//     (flat row j is head h*G + j/C at chunk index j%C);
//   - key slot kpos is visible iff kpos <= qpos && kpos < kv_len[r];
//   - pad queries (c >= chunk_len) are dropped by the caller; here they see
//     no key and come out as zeros;
//   - chunk_len == 0 (idle row) writes exact zeros and walks no pages; its
//     kv_len may be a sentinel past the table width, so the walk is bounded
//     by the table (maxp * ps slots), never by kv_len alone;
//   - table entries of -1 clip to page 0 (the engine's scratch page);
//   - a query with no visible key (l == 0) returns 0;
//   - e5m2 pools widen in the kernel, exactly (e5m2 is a subset of bf16);
//     scores, m, l and the accumulator are fp32, and p is rounded to bf16
//     before the P.V product, as the reference rounds it (its compute
//     dtype), while l sums the unrounded p.
//
// What bounds it: reading each row's live K/V slots once (decode and the
// verify chunks of speculative decoding: ~2 bytes per key element per
// layer for bf16, 1 for e5m2), so the card's memory rate; at C = 128 the
// score and value products, 4 D operations per visible (query, key) pair,
// so the tensor cores.
//
// Design.  K/V stream through shared memory in tiles of 64 keys, double
// buffered with 16-byte cp.async in the pool's storage type (each key looks
// up its own page, so any page size works); an e5m2 tile is widened to bf16
// in shared memory.  K/V rows are XOR-swizzled by 16-byte chunk so ldmatrix
// reads are free of bank conflicts.  Each warp keeps 16 query rows as
// mma.sync A fragments in registers, computes S = Q.K^T with mma.sync
// m16n8k16 (bf16 in, fp32 out; K fragments by ldmatrix), masks and scales
// S, runs the FlashAttention-2 online softmax in registers (row max and sum
// over the quad that holds a row), rounds P to bf16 and reuses its
// registers as the A fragments of P.V against V (ldmatrix.trans).  Two
// instances, chosen from shapes alone:
//   - query tiles (G*C > 16): a block owns 64 query rows (4 warps x 16) of
//     one (row, kv head) and walks the row's keys up to the block's last
//     visible slot; a warp skips a tile wholly in its rows' future, which is
//     exact (it would change neither m, l nor acc); the block writes bf16;
//   - key split (G*C <= 16: decode, the verify chunks of speculation): a
//     block owns the row's whole group x chunk (16 rows) and one split of
//     consecutive pages; its four warps take a quarter of each 64-key tile
//     each and merge their (m, l, acc) in shared memory at the end; the
//     block writes fp32 partials (m, l, acc) to scratch, and a second
//     kernel merges a query row's splits in split order (deterministic, no
//     atomics).  A split past the row's live pages writes l = 0, which the
//     merge skips.
//
// Two instances of the head dim D, 128 and 256 (Gemma, and Gemma-3's full
// layers), each with both of the above.  At 256 a K/V tile pair is 64 KiB,
// so the four staged tiles take 128 KiB, and the fp32 accumulator of a
// warp's 16 rows alone takes 128 registers a thread.  That instance takes
// B3's answer at 256 (decode_attention.cu): the block's query rows (64, or
// 16 in the split) sit in shared memory, swizzled like a K tile and staged
// with the first tile, and each 16-dim step's A fragment is read with
// ldmatrix where it is used instead of holding all 16 steps' fragments in
// registers; its 136 or 160 KiB of shared memory leave room for one block
// an SM.  Its query-tile instance also takes each warp's 64 keys of a tile
// in two parts of 32 through the online softmax, which halves the score
// registers (in one part it used 255 registers and spilled over e5m2).
// (B4's answer, O in two 128-column halves, would walk the keys twice and
// read each K/V tile from HBM twice.)  The 128 instance is the same code
// with D = 128: Q in registers, one part, 64 KiB.
//
// K and V may differ in width: DeepSeek's MLA reads K at D = 192 (128 nope
// + 64 rope columns) and V at Dv = 128 (the (192, 128) instance, at G = 1:
// one kv head a query head).  Q.K^T reduces over twelve k16 steps and P.V
// writes 128 columns, so a tile pair is a 192-column K tile (24 KiB, 24
// chunks a key: the XOR swizzle flips the low three bits of the chunk
// index, which stays inside the row, and a key's row is three 128-byte
// lines, so eight consecutive keys still hit eight distinct bank groups)
// beside a 128-column V tile (16 KiB).  Q's twelve steps and the 64
// accumulator registers of the 128 V columns fit in registers, so that
// instance keeps D = 128's plan: Q in registers, one part, the two staged
// pairs in 80 KiB.  The other instances are (D, D): their K and V offsets,
// loops and shared-memory layout are those of one width, as before.
//
// A fifth pair, (80, 80) (Phi-2 and phixtral: 2560 / 32), takes B3's
// answer at 96 and 80 (decode_attention.cu): a key's row in shared memory
// is 128 columns wide (a row of 80 columns is ten 16-byte chunks, and the
// XOR swizzle, which flips a chunk index's low three bits, would carry
// chunks 8 and 9 out of a ten-chunk row), the kernel stages the 80 columns
// the pool holds (ten chunks a key, an e5m2 row as its 80 bytes) and never
// reads or writes the other 48 (37.5% of the staged bytes idle; the pool
// in HBM is read as stored).  Q.K^T is five k16 steps, P.V ten n8 tiles;
// Q's five fragments and the 40 accumulator registers stay in registers,
// so both instances keep D = 128's plan (64 KiB a block).
//
// Three more pairs serve MiniCPM and the Llama-3.2-1B/TinyLlama width.
// (64, 64) (MiniCPM-2B: 2304 / 36): a 64-column row is eight 16-byte
// chunks, exactly one period of the XOR swizzle, so its rows are native
// 64-column rows in shared memory (8 KiB a tile, none idle); Q.K^T is four
// k16 steps, P.V eight n8 tiles, 32 KiB a block.  (96, 64) (MiniCPM3's
// MLA: K 64 nope + 32 rope, V 64): K rows the 96 instance's 128-column
// rows (96 staged and read), V rows native 64-column ones; six k16 score
// steps, eight n8 output tiles.  (96, 96): the 80 instance at 96 (rows
// 128 columns wide, twelve chunks staged).  The split's merges at Dv = 64
// and 96 run 64 and 96 threads, whole warps, and no shuffle.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kKT = 64;                 // keys per staged tile
constexpr int kThreads = 128;           // 4 warps
constexpr float kNegInf = -1e30f;       // the reference's NEG_INF
constexpr float kFloor = -1e29f;        // the reference's m clamp

// the instance of K width D and V width Dv
// (ragged_paged_attention.py::smem_plan): two staged K/V tile pairs, the
// block's last visible slot, and at D = 256 the block's query rows
// (kQRows: 64 for the query tiles, 16 for the key split)
// the columns of a key's row in shared memory: D, or 128 at D = 80 and
// 96 (at 64 a row is eight chunks, one period of the swizzle)
template <int D>
constexpr int kRowD = D == 64 ? 64 : D < 128 ? 128 : D;

template <int D, int Dv>
struct Plan {
  static constexpr int kTileK = kKT * kRowD<D> * 2;  // one bf16 K tile
  static constexpr int kTileV = kKT * kRowD<Dv> * 2; // one bf16 V tile
  static constexpr int kPair = kTileK + kTileV;      // a staged pair
  static constexpr bool kQSmem = D > 192;
  static constexpr int kQOff = 2 * kPair + 128;
  template <bool SPLIT>
  static constexpr int smem() {
    return kQSmem ? kQOff + (SPLIT ? 16 : 64) * D * 2
                  : 2 * kPair + 16;                  // pairs + q_hi
  }
};

template <int D>
__device__ __forceinline__ int kv_chunk(int key, int c) {
  // swizzled 16-byte chunk index
  return key * (kRowD<D> / 8) + (c ^ (key & 7));
}

// stage the keys [k0, k0 + 64) of (row r, kv head h) into `kd`/`vd`: bf16
// pools swizzled, e5m2 pools as stored; keys at or past k_hi are zeros.  A
// V row narrower than K's (Dv < D) takes the first of each key's chunks
template <typename KV, int kD, int kDv>
__device__ __forceinline__ void stage_tile(
    uint8_t* kd, uint8_t* vd, const KV* __restrict__ kpool,
    const KV* __restrict__ vpool, const int* __restrict__ table_row, int k0,
    int k_hi, int h, int Hkv, int ps, int n_pages) {
  static_assert(kDv <= kD, "V is at most K's width");
  constexpr int kChunks = kD * (int)sizeof(KV) / 16;   // 16 or 8 per key
  constexpr int kChunksV = kDv * (int)sizeof(KV) / 16;
  for (int i = threadIdx.x; i < kKT * kChunks; i += kThreads) {
    const int key = i / kChunks, c = i - key * kChunks;
    const int kpos = k0 + key;
    const bool ok = kpos < k_hi;
    size_t row = 0;
    if (ok) {
      const int pid = min(max(__ldg(table_row + kpos / ps), 0), n_pages - 1);
      row = ((size_t)pid * Hkv + h) * ps + kpos % ps;
    }
    const int dst = sizeof(KV) == 2 ? kv_chunk<kD>(key, c) * 16
                                    : key * (kD * (int)sizeof(KV)) + c * 16;
    hopper::cp_async<16>(kd + dst, kpool + (row * kD + c * (16 / sizeof(KV))),
                         ok);
    if (kDv == kD || c < kChunksV) {
      const int dst_v = sizeof(KV) == 2
                            ? kv_chunk<kDv>(key, c) * 16
                            : key * (kDv * (int)sizeof(KV)) + c * 16;
      hopper::cp_async<16>(vd + dst_v,
                           vpool + (row * kDv + c * (16 / sizeof(KV))), ok);
    }
  }
}

// widen an e5m2 tile pair (as stored) into bf16 swizzled tiles: an e5m2
// code is the top byte of an fp16, and every e5m2 value is a bf16 value
template <int kD, int kDv>
__device__ __forceinline__ void widen_tile(const uint8_t* kraw,
                                           const uint8_t* vraw, uint8_t* kw,
                                           uint8_t* vw) {
  constexpr int kNK = kKT * (kD / 16);       // 16-byte raw chunks of K
  for (int i = threadIdx.x; i < kNK + kKT * (kDv / 16); i += kThreads) {
    const int which = i >= kNK;
    const int rem = i - which * kNK;
    const int w16 = which ? kDv / 16 : kD / 16;
    const int key = rem / w16, c = rem % w16;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        (which ? vraw + key * kDv : kraw + key * kD) + c * 16);
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
    const int c0 = which ? kv_chunk<kDv>(key, 2 * c) : kv_chunk<kD>(key, 2 * c);
    const int c1 = which ? kv_chunk<kDv>(key, 2 * c + 1)
                         : kv_chunk<kD>(key, 2 * c + 1);
    *reinterpret_cast<uint4*>(dst + c0 * 16) =
        make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(dst + c1 * 16) =
        make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// SPLIT == false: the query-tile instance (64 rows a block, 4 warps along
// the rows, writes bf16 out).  SPLIT == true: the key-split instance (16
// rows a block, 4 warps along the keys, writes fp32 partials for the merge)
template <typename KV, int kD, int kDv, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
ragged_attn_kernel(const __nv_bfloat16* __restrict__ q,
                   const KV* __restrict__ kpool,
                   const KV* __restrict__ vpool,
                   const int* __restrict__ tables,
                   const int* __restrict__ kv_len_arr,
                   const int* __restrict__ chunk_arr,
                   __nv_bfloat16* __restrict__ out,
                   float* __restrict__ ws_acc, float2* __restrict__ ws_ml,
                   int C, int Hq, int Hkv, int ps, int n_pages, int maxp,
                   int n_qtiles, int n_splits, int pps, float scale) {
  constexpr int kQRows = SPLIT ? 16 : 64;        // query rows per block
  constexpr int kKW = SPLIT ? kKT / 4 : kKT;     // keys per warp per tile
  constexpr int kSN = kKW / 8;                   // n8 score tiles per warp
  constexpr int kParts = (kDv > 128 && !SPLIT) ? 2 : 1;
  constexpr int kPN = kSN / kParts;              // ... in one part
  constexpr bool kFp8 = sizeof(KV) == 1;
  using P = Plan<kD, kDv>;
  extern __shared__ __align__(128) uint8_t smem[];
  int* q_hi_s = reinterpret_cast<int*>(smem + 2 * P::kPair);
  uint8_t* q_s = smem + P::kQOff;               // at D = 256: the Q rows

  const int qt = blockIdx.x % n_qtiles;
  const int split = blockIdx.x / n_qtiles;
  const int h = blockIdx.y;
  const int r = blockIdx.z;
  const int G = Hq / Hkv;
  const int GC = G * C;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kv_len = kv_len_arr[r];
  const int chunk = chunk_arr[r];
  const int j0 = qt * kQRows;
  const int jw = j0 + (SPLIT ? 0 : warp * 16);   // the warp's first row
  const int wk = SPLIT ? warp * kKW : 0;         // the warp's key slice

  // flat row j: its q (and, times Dv / D, out) offset and its slot (-1: a
  // pad or missing row, which sees no key)
  auto q_head = [&](int j) -> size_t {
    const int g = j / C, c = j - (j / C) * C;
    return ((size_t)r * C + c) * Hq + (size_t)h * G + g;
  };
  auto q_off = [&](int j) -> size_t { return q_head(j) * kD; };
  auto qpos_of = [&](int j) -> int {
    const int c = j % C;
    return (j < GC && c < chunk && chunk > 0) ? kv_len - chunk + c : -1;
  };

  // the block's and the warp's last visible slot
  if (threadIdx.x == 0) *q_hi_s = -1;
  __syncthreads();
  if (threadIdx.x < kQRows) atomicMax(q_hi_s, qpos_of(j0 + threadIdx.x));
  const int warp_q_hi = __reduce_max_sync(
      0xffffffffu, lane < 16 ? qpos_of(jw + lane) : -1);
  __syncthreads();
  const int q_hi = *q_hi_s;
  const int kv_end = min(kv_len, maxp * ps);     // slots the table holds
  int k_lo = 0, k_hi = min(kv_end, q_hi + 1);
  if (SPLIT) {
    k_lo = split * pps * ps;
    k_hi = min(k_hi, (split + 1) * pps * ps);
  }
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kKT - 1) / kKT : 0;

  // the warp's 16 query rows as A fragments: rows lane/4 and lane/4 + 8.
  // D = 128: all steps' fragments in registers; D = 256: the block's rows
  // in shared memory (staged below with the first tile), a step's
  // fragment read with ldmatrix where it is used
  const int r0 = lane >> 2;
  const int qp[2] = {qpos_of(jw + r0), qpos_of(jw + r0 + 8)};
  uint32_t qa[P::kQSmem ? 1 : kD / 16][4];
  if constexpr (P::kQSmem) {
    for (int i = threadIdx.x; i < kQRows * (kD / 8); i += kThreads) {
      const int row = i / (kD / 8), c = i % (kD / 8);
      const bool ok = j0 + row < GC;
      hopper::cp_async<16>(q_s + kv_chunk<kD>(row, c) * 16,
                           q + (ok ? q_off(j0 + row) + c * 8 : 0), ok);
    }
  } else {
    const bool ok0 = jw + r0 < GC, ok1 = jw + r0 + 8 < GC;
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(
        q + (ok0 ? q_off(jw + r0) : 0));
    const uint32_t* q1 = reinterpret_cast<const uint32_t*>(
        q + (ok1 ? q_off(jw + r0 + 8) : 0));
#pragma unroll
    for (int kc = 0; kc < kD / 16; ++kc) {
      const int d2 = (kc * 16 + (lane & 3) * 2) / 2;   // in bf16 pairs
      qa[kc][0] = ok0 ? __ldg(q0 + d2) : 0u;
      qa[kc][1] = ok1 ? __ldg(q1 + d2) : 0u;
      qa[kc][2] = ok0 ? __ldg(q0 + d2 + 4) : 0u;
      qa[kc][3] = ok1 ? __ldg(q1 + d2 + 4) : 0u;
    }
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kDv / 8][4];
#pragma unroll
  for (int i = 0; i < kDv / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  const int* table_row = tables + (size_t)r * maxp;
  // bf16: the two stages are the two pairs (K, then V); e5m2: raw stages
  // in the first pair's bytes, the widened K/V in the second pair's
  auto stage_k = [&](int slot) -> uint8_t* {
    return smem + (kFp8 ? slot * (P::kPair / 2) : slot * P::kPair);
  };
  auto stage_v = [&](int slot) -> uint8_t* {
    return stage_k(slot) + (kFp8 ? P::kTileK / 2 : P::kTileK);
  };
  if (n_tiles > 0)
    stage_tile<KV, kD, kDv>(stage_k(0), stage_v(0), kpool, vpool, table_row,
                            k_lo, k_hi, h, Hkv, ps, n_pages);
  hopper::cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_lo + t * kKT;
    if (t + 1 < n_tiles)
      stage_tile<KV, kD, kDv>(stage_k((t + 1) & 1), stage_v((t + 1) & 1),
                              kpool, vpool, table_row, k0 + kKT, k_hi, h,
                              Hkv, ps, n_pages);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    const uint8_t* kt;
    const uint8_t* vt;
    if constexpr (kFp8) {
      widen_tile<kD, kDv>(stage_k(t & 1), stage_v(t & 1), smem + P::kPair,
                          smem + P::kPair + P::kTileK);
      __syncthreads();
      kt = smem + P::kPair;
      vt = smem + P::kPair + P::kTileK;
    } else {
      kt = stage_k(t & 1);
      vt = stage_v(t & 1);
    }
    // the warp's keys of the tile in kParts parts, each through the
    // online softmax in turn (two at D = 256 in the query tiles, which
    // halves the score registers); warp-uniform: a part wholly past the
    // warp's last visible slot changes none of its rows' m, l or acc
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      const int wp = wk + part * (kKW / kParts);
      if (k0 + wp > warp_q_hi) continue;
      float s[kPN][4];
#pragma unroll
      for (int i = 0; i < kPN; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kD / 16; ++kc) {
        if constexpr (P::kQSmem) {
          // rows lane % 16 of the warp's, dims 16kc + 8(lane / 16): the
          // m16n8k16 A tile
          hopper::ldsm_x4(
              qa[0][0], qa[0][1], qa[0][2], qa[0][3],
              q_s + kv_chunk<kD>((SPLIT ? 0 : warp * 16) + (lane & 15),
                                 kc * 2 + (lane >> 4)) * 16);
        }
        const uint32_t* af = qa[P::kQSmem ? 0 : kc];
#pragma unroll
        for (int np = 0; np < kPN; np += 2) {
          const int key = wp + np * 8 + (lane >> 4) * 8 + (lane & 7);
          const int c = kc * 2 + ((lane >> 3) & 1);
          uint32_t b0, b1, b2, b3;
          hopper::ldsm_x4(b0, b1, b2, b3, kt + kv_chunk<kD>(key, c) * 16);
          hopper::mma_bf16(s[np], af, b0, b1);
          hopper::mma_bf16(s[np + 1], af, b2, b3);
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < kPN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + wp + nt * 8 + (lane & 3) * 2 + (e & 1);
          const int row = e >> 1;
          const float v = (kpos < k_hi && kpos <= qp[row] && kpos < kv_len)
                              ? s[nt][e] * scale
                              : kNegInf;
          s[nt][e] = v;
          mx[row] = fmaxf(mx[row], v);
        }
      float alpha[2];
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
        mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
        const float m_new = fmaxf(m[row], mx[row]);
        const float m_safe = fmaxf(m_new, kFloor);
        alpha[row] = expf(fmaxf(m[row], kFloor) - m_safe);
        m[row] = m_new;
        mx[row] = m_safe;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < kPN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[nt][e] - mx[e >> 1]);
          s[nt][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        sum[row] += __shfl_xor_sync(0xffffffffu, sum[row], 1);
        sum[row] += __shfl_xor_sync(0xffffffffu, sum[row], 2);
        l[row] = l[row] * alpha[row] + sum[row];
      }
#pragma unroll
      for (int dn = 0; dn < kDv / 8; ++dn) {
        acc[dn][0] *= alpha[0];
        acc[dn][1] *= alpha[0];
        acc[dn][2] *= alpha[1];
        acc[dn][3] *= alpha[1];
      }
      // P.V: the score tiles (2kk, 2kk + 1) are the A fragment of keys
      // [16kk, 16kk + 16), p rounded to bf16
#pragma unroll
      for (int kk = 0; kk < kPN / 2; ++kk) {
        const uint32_t pa[4] = {
            hopper::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            hopper::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            hopper::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            hopper::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const int key = wp + kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
        for (int dn = 0; dn < kDv / 8; dn += 2) {
          uint32_t b0, b1, b2, b3;
          hopper::ldsm_x4_trans(
              b0, b1, b2, b3, vt + kv_chunk<kDv>(key, dn + (lane >> 4)) * 16);
          hopper::mma_bf16(acc[dn], pa, b0, b1);
          hopper::mma_bf16(acc[dn + 1], pa, b2, b3);
        }
      }
    }
    __syncthreads();       // the tile's slot is refilled next iteration
  }
  hopper::cp_async_wait<0>();

  if constexpr (!SPLIT) {
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const int j = jw + r0 + 8 * row;
      if (j >= GC) continue;
      const float denom = l[row] == 0.f ? 1.f : l[row];
      __nv_bfloat16* o = out + q_head(j) * kDv;
#pragma unroll
      for (int dn = 0; dn < kDv / 8; ++dn) {
        const int d = dn * 8 + (lane & 3) * 2;
        *reinterpret_cast<uint32_t*>(o + d) = hopper::pack_bf16(
            acc[dn][2 * row] / denom, acc[dn][2 * row + 1] / denom);
      }
    }
  } else {
    // merge the four warps' key slices in warp order, in shared memory
    __syncthreads();
    float* acc_s = reinterpret_cast<float*>(smem);          // [4][16][Dv]
    float2* ml_s = reinterpret_cast<float2*>(smem + 4 * 16 * kDv * 4);
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const int i = r0 + 8 * row;
      float* a = acc_s + (warp * 16 + i) * kDv;
#pragma unroll
      for (int dn = 0; dn < kDv / 8; ++dn) {
        const int d = dn * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(a + d) =
            make_float2(acc[dn][2 * row], acc[dn][2 * row + 1]);
      }
      if ((lane & 3) == 0) ml_s[warp * 16 + i] = make_float2(m[row], l[row]);
    }
    __syncthreads();
    const size_t ws_row =
        (((size_t)r * Hkv + h) * n_splits + split) * (size_t)GC;
    for (int i = 0; i < kQRows && i < GC; ++i) {
      float m_all = kNegInf;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float2 ml = ml_s[w * 16 + i];
        if (ml.y > 0.f) m_all = fmaxf(m_all, ml.x);
      }
      const float m_ref = fmaxf(m_all, kFloor);
#pragma unroll
      for (int dd = 0; dd < (kDv + kThreads - 1) / kThreads; ++dd) {
        const int d = threadIdx.x + dd * kThreads;
        if (kDv % kThreads != 0 && d >= kDv) break;
        float lsum = 0.f, o = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 ml = ml_s[w * 16 + i];
          if (!(ml.y > 0.f)) continue;
          const float wt = expf(fmaxf(ml.x, kFloor) - m_ref);
          lsum = fmaf(ml.y, wt, lsum);
          o = fmaf(acc_s[(w * 16 + i) * kDv + d], wt, o);
        }
        ws_acc[(ws_row + i) * kDv + d] = o;
        if (d == 0) ws_ml[ws_row + i] = make_float2(m_all, lsum);
      }
    }
  }
}

// one block of kDv threads per (query row, kv head, row): thread d merges
// output dim d of the row's splits in split order; a split that saw no
// visible key (l == 0) contributes nothing
template <int kDv>
__global__ void __launch_bounds__(kDv)
ragged_merge_kernel(const float* __restrict__ ws_acc,
                    const float2* __restrict__ ws_ml,
                    __nv_bfloat16* __restrict__ out, int C, int Hq, int Hkv,
                    int n_splits) {
  const int j = blockIdx.x;
  const int h = blockIdx.y;
  const int r = blockIdx.z;
  const int G = Hq / Hkv;
  const int GC = G * C;
  const size_t base = ((size_t)r * Hkv + h) * n_splits * (size_t)GC + j;
  float m_all = kNegInf;
  for (int s = 0; s < n_splits; ++s) {
    const float2 ml = ws_ml[base + (size_t)s * GC];
    if (ml.y > 0.f) m_all = fmaxf(m_all, ml.x);
  }
  const float m_ref = fmaxf(m_all, kFloor);
  float l = 0.f, o = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float2 ml = ws_ml[base + (size_t)s * GC];
    if (!(ml.y > 0.f)) continue;
    const float w = expf(fmaxf(ml.x, kFloor) - m_ref);
    l = fmaf(ml.y, w, l);
    o = fmaf(ws_acc[(base + (size_t)s * GC) * kDv + threadIdx.x], w, o);
  }
  const int g = j / C, c = j % C;
  const size_t off = (((size_t)r * C + c) * Hq + (size_t)h * G + g) * kDv;
  out[off + threadIdx.x] = __float2bfloat16(o / (l == 0.f ? 1.f : l));
}

template <typename KV, int kD, int kDv, bool SPLIT>
int launch(dim3 grid, cudaStream_t st, const void* q, const void* kpool,
           const void* vpool, const void* tables, const void* kv_len,
           const void* chunk_len, void* out, void* ws_acc, void* ws_ml,
           int C, int Hq, int Hkv, int ps, int n_pages, int maxp,
           int n_qtiles, int n_splits, int pps, float scale) {
  constexpr int kSmem = Plan<kD, kDv>::template smem<SPLIT>();
  static_assert(kSmem <= 232448, "exceeds a block's shared memory");
  static_assert(!SPLIT || 4 * 16 * kDv * 4 + 4 * 16 * 8 <= kSmem,
                "the split's warp merge fits the staged tiles' bytes");
  cudaError_t e = cudaFuncSetAttribute(
      ragged_attn_kernel<KV, kD, kDv, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  ragged_attn_kernel<KV, kD, kDv, SPLIT><<<grid, kThreads, kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(kpool),
      static_cast<const KV*>(vpool), static_cast<const int*>(tables),
      static_cast<const int*>(kv_len), static_cast<const int*>(chunk_len),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws_acc),
      static_cast<float2*>(ws_ml), C, Hq, Hkv, ps, n_pages, maxp, n_qtiles,
      n_splits, pps, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q bf16 [R,C,Hq,D] (4-byte aligned); pools [P,Hkv,ps,D] (K) and
// [P,Hkv,ps,Dv] (V) bf16 (kv_fp8=0) or e5m2 (kv_fp8=1), 16-byte aligned;
// tables int32 [R,maxp]; kv_len, chunk_len int32 [R]; out bf16
// [R,C,Hq,Dv].  Given scratch ws_acc fp32 [R,Hkv,n_splits,G*C,Dv] and ws_ml
// fp32 [R,Hkv,n_splits,G*C,2] (G = Hq/Hkv, G*C <= 16), the key-split
// instance runs over n_splits splits of pps pages and then the merge;
// without (null), the query-tile instance (n_splits 1).  (D, Dv) is (64,
// 64), (80, 80), (96, 64), (96, 96), (128, 128), (192, 128) or (256,
// 256).  Returns the first non-zero
// cudaGetLastError(), or cudaErrorInvalidValue for another pair or a split
// of more than 16 rows.
extern "C" int ragged_paged_attention(const void* q, const void* kpool,
                                      const void* vpool, const void* tables,
                                      const void* kv_len,
                                      const void* chunk_len, void* out,
                                      void* ws_acc, void* ws_ml, int R,
                                      int C, int Hq, int Hkv, int D, int Dv,
                                      int ps,
                                      int n_pages, int maxp, int n_splits,
                                      int pps, int kv_fp8, float scale,
                                      void* stream) {
  if (!((D == 64 && Dv == 64) || (D == 80 && Dv == 80) ||
        (D == 96 && Dv == 64) || (D == 96 && Dv == 96) ||
        (D == 128 && Dv == 128) || (D == 192 && Dv == 128) ||
        (D == 256 && Dv == 256)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int gc = (Hq / Hkv) * C;
  const bool split = ws_acc != nullptr;
  if (split ? gc > 16 : n_splits != 1) return (int)cudaErrorInvalidValue;
  const int n_qtiles = split ? 1 : (gc + 63) / 64;
  const dim3 grid(n_qtiles * n_splits, Hkv, R);
  int err;
#define RPA_LAUNCH(KV, HD, HDV, SPLIT)                                      \
  launch<KV, HD, HDV, SPLIT>(grid, st, q, kpool, vpool, tables, kv_len,     \
                        chunk_len, out, ws_acc, ws_ml, C, Hq, Hkv, ps,      \
                        n_pages, maxp, n_qtiles, n_splits, pps, scale)
#define RPA_LAUNCH_D(HD, HDV)                                               \
  (kv_fp8 ? (split ? RPA_LAUNCH(uint8_t, HD, HDV, true)                     \
                   : RPA_LAUNCH(uint8_t, HD, HDV, false))                   \
          : (split ? RPA_LAUNCH(uint16_t, HD, HDV, true)                    \
                   : RPA_LAUNCH(uint16_t, HD, HDV, false)))
  err = D == 128   ? RPA_LAUNCH_D(128, 128)
        : D == 192 ? RPA_LAUNCH_D(192, 128)
        : D == 256 ? RPA_LAUNCH_D(256, 256)
        : D == 64  ? RPA_LAUNCH_D(64, 64)
        : D == 96  ? (Dv == 64 ? RPA_LAUNCH_D(96, 64) : RPA_LAUNCH_D(96, 96))
                   : RPA_LAUNCH_D(80, 80);
#undef RPA_LAUNCH_D
#undef RPA_LAUNCH
  if (err || !split) return err;
  const dim3 mgrid(gc, Hkv, R);
#define RPA_MERGE(HDV)                                                      \
  ragged_merge_kernel<HDV><<<mgrid, HDV, 0, st>>>(                          \
      static_cast<const float*>(ws_acc), static_cast<const float2*>(ws_ml), \
      static_cast<__nv_bfloat16*>(out), C, Hq, Hkv, n_splits)
  if (Dv == 64)
    RPA_MERGE(64);
  else if (Dv == 80)
    RPA_MERGE(80);
  else if (Dv == 96)
    RPA_MERGE(96);
  else if (Dv == 128)
    RPA_MERGE(128);
  else
    RPA_MERGE(256);
#undef RPA_MERGE
  return (int)cudaGetLastError();
}
