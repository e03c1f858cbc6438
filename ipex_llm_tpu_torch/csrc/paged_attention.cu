// Split paged attention for Hopper: decode (C = 1) and uniform chunks of C
// causal queries over the paged KV pool, split along each row's pages
// ("flash-decoding"), then merged.
//
// Replaces the TPU kernel
// ipex_llm_tpu/ops/pallas/paged_attention.py::paged_decode_sdpa and
// ::paged_prefill_sdpa (body _paged, _kernel).  Semantics kept exactly:
//   - q [R, C, Hq, D] bf16; the query at chunk index c of row r sits at slot
//     kv_len[r] - C + c and sees key slots kpos <= that slot (decode: every
//     slot below kv_len); head hq reads kv head hq / (Hq/Hkv);
//   - a row walks only its pages below ceil(kv_len/ps) (and below the table
//     width); a -1 table entry clips to page 0 (the engine's scratch page),
//     whose slots the mask hides;
//   - a query with no visible key (slot < 0, or kv_len == 0) returns exact
//     zeros (the reference's l == 0 -> denominator 1);
//   - e5m2 pools widen exactly (an e5m2 code is the top byte of an fp16,
//     and every e5m2 value is a bf16 value: the reference's e5m2 -> bf16);
//     scores, m, l and the accumulator are fp32; p is rounded to bf16
//     before the P.V product, as the reference rounds it (its compute
//     dtype), while l sums the unrounded p.
//   The TPU's padding of the group to 8 rows and of D to 128 lanes is layout,
//   not semantics, and is not carried over.
//
// What bounds it: reading each row's live K/V pages once (decode, and the
// verify chunks of speculative decoding: ~2 bytes per key element per layer
// for bf16, 1 for e5m2), so the card's memory rate; at C = 128 also the
// score and value products (4 D operations per visible (query, key) pair)
// and the split's fp32 partials.
//
// Design.  A decomposition of its own, unlike B1's (whose tiles of more
// than 16 query rows walk a row's keys whole, and whose few-query rows
// deal each key tile to four warps): the pass-1 grid is (query tile x page
// split, kv head, row) for every C, the splits planned from shapes.  A
// block owns one split of consecutive pages and a query tile of the
// (row, kv head)'s GQA group x chunk rows (chunk-minor): 64 rows, four
// warps of 16 that share each key tile, when G*C > 16 (C = 128); one warp
// of 16 rows when G*C <= 16 (decode, the verify chunks), where the split
// supplies the parallelism and each block streams its pages alone.  K/V
// tiles (64 keys for the 64-row blocks, 16 for the single-warp ones; one
// table read where a tile lies in one page) are double buffered in shared
// memory with 16-byte cp.async in the pool's storage type; an e5m2
// tile is widened to bf16 in shared memory.  Rows are XOR-swizzled by
// 16-byte chunk so ldmatrix reads are free of bank conflicts.  A warp
// keeps its 16 query rows as mma.sync A fragments, computes S = Q.K^T
// with mma.sync m16n8k16 (K fragments by ldmatrix), runs the online
// softmax in registers (row max and sum over the quad that holds a row),
// rounds P to bf16 and reuses its registers as the A fragments of P.V
// against V (ldmatrix.trans).  The block's walk ends at its rows' last
// visible slot; a warp skips a tile wholly past its rows' last slot and
// compares slots only on tiles that cross a boundary (a row's slot, the
// split's end, kv_len).  Each block writes fp32 partials (m, l, acc) to a
// workspace; pass 2 merges a query row's splits in split order, rescaling
// by exp(m_s - M) and skipping splits with l == 0, and writes bf16.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kD = 128;                  // head dim (the only instance)
constexpr float kNegInf = -1e30f;        // the reference's NEG_INF
constexpr float kFloor = -1e29f;         // the reference's m clamp
constexpr int kMergeThreads = kD;
// keys per staged tile: 64 for the four-warp 64-row blocks; 16 for the
// single-warp blocks, whose 16 KiB of shared memory lets many of them
// share an SM (the streams of short splits need many in flight)
template <int WARPS>
__host__ __device__ constexpr int key_tile() {
  return WARPS == 4 ? 64 : 16;
}

template <int KT>
__host__ __device__ constexpr int smem_bytes() {
  return 4 * KT * kD * 2;      // K and V, two stages
}

__device__ __forceinline__ int kv_chunk(int key, int c) {
  return key * (kD / 8) + (c ^ (key & 7));   // swizzled 16-byte chunk index
}

// stage keys [k0, k0 + KT) of (row, kv head h): bf16 pools swizzled, e5m2
// pools as stored; keys at or past k_hi are zeros.  Tiles start at
// multiples of KT from a page boundary, so where KT divides the page size
// a tile lies in one page: one table read, then KT contiguous key rows;
// else (64-key tiles over 32-slot pages) each key looks up its page.
template <typename KV, int THREADS, int KT>
__device__ __forceinline__ void stage_tile(
    uint8_t* kd, uint8_t* vd, const KV* __restrict__ kpool,
    const KV* __restrict__ vpool, const int* __restrict__ table_row, int k0,
    int k_hi, int h, int Hkv, int ps, int n_pages) {
  constexpr int kChunks = kD * (int)sizeof(KV) / 16;   // 16 or 8 per key
  const bool one_page = ps % KT == 0;
  size_t tile_off = 0;
  if (one_page) {
    const int pid = min(max(__ldg(table_row + k0 / ps), 0), n_pages - 1);
    tile_off = (((size_t)pid * Hkv + h) * ps + k0 % ps) * kD;
  }
  for (int i = threadIdx.x; i < KT * kChunks; i += THREADS) {
    const int key = i / kChunks, c = i - key * kChunks;
    const int kpos = k0 + key;
    const bool ok = kpos < k_hi;
    size_t off = 0;
    if (ok) {
      if (one_page) {
        off = tile_off + (size_t)key * kD;
      } else {
        const int pid =
            min(max(__ldg(table_row + kpos / ps), 0), n_pages - 1);
        off = (((size_t)pid * Hkv + h) * ps + kpos % ps) * kD;
      }
      off += c * (16 / sizeof(KV));
    }
    const int dst = sizeof(KV) == 2 ? kv_chunk(key, c) * 16
                                    : key * (kD * (int)sizeof(KV)) + c * 16;
    hopper::cp_async<16>(kd + dst, kpool + off, ok);
    hopper::cp_async<16>(vd + dst, vpool + off, ok);
  }
}

// widen an e5m2 tile pair (as stored) into bf16 swizzled tiles: e5m2 byte
// b is the fp16 with bits b << 8, exact in bf16
template <int THREADS, int KT>
__device__ __forceinline__ void widen_tile(const uint8_t* kraw,
                                           const uint8_t* vraw, uint8_t* kw,
                                           uint8_t* vw) {
  for (int i = threadIdx.x; i < 2 * KT * (kD / 16); i += THREADS) {
    const int which = i / (KT * (kD / 16));
    const int rem = i - which * (KT * (kD / 16));
    const int key = rem / (kD / 16), c = rem % (kD / 16);
    const uint4 raw = *reinterpret_cast<const uint4*>(
        (which ? vraw : kraw) + key * kD + c * 16);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t o[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t lo = ((w[e] & 0xFFu) << 8) | ((w[e] & 0xFF00u) << 16);
      const uint32_t hi = ((w[e] >> 8) & 0xFF00u) | (w[e] & 0xFF000000u);
      const float2 flo = __half22float2(*reinterpret_cast<const __half2*>(&lo));
      const float2 fhi = __half22float2(*reinterpret_cast<const __half2*>(&hi));
      o[2 * e] = hopper::pack_bf16(flo.x, flo.y);
      o[2 * e + 1] = hopper::pack_bf16(fhi.x, fhi.y);
    }
    uint8_t* dst = which ? vw : kw;
    *reinterpret_cast<uint4*>(dst + kv_chunk(key, 2 * c) * 16) =
        make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(dst + kv_chunk(key, 2 * c + 1) * 16) =
        make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// WARPS warps of 16 query rows each (4: 64-row tiles for G*C > 16; 1: one
// 16-row fragment for G*C <= 16); every block writes fp32 partials for the
// merge
template <typename KV, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
paged_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const KV* __restrict__ kpool, const KV* __restrict__ vpool,
                   const int* __restrict__ tables,
                   const int* __restrict__ kv_len_arr,
                   float* __restrict__ ws_acc, float2* __restrict__ ws_ml,
                   int C, int Hq, int Hkv, int ps, int n_pages, int maxp,
                   int n_qtiles, int n_splits, int pps, float scale) {
  constexpr int kThreads = 32 * WARPS;
  constexpr int kQRows = 16 * WARPS;
  constexpr int kKT = key_tile<WARPS>();
  constexpr int kTileBytes = kKT * kD * 2;       // one bf16 K or V tile
  constexpr bool kFp8 = sizeof(KV) == 1;
  extern __shared__ __align__(128) uint8_t smem[];

  const int qt = blockIdx.x % n_qtiles;
  const int split = blockIdx.x / n_qtiles;
  const int h = blockIdx.y;
  const int r = blockIdx.z;
  const int G = Hq / Hkv;
  const int GC = G * C;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kv_len = kv_len_arr[r];
  const int j0 = qt * kQRows;
  const int jw = j0 + warp * 16;                // the warp's first row

  // flat row j (GQA group x chunk, chunk-minor): its q offset and its slot
  auto q_off = [&](int j) -> size_t {
    const int g = j / C, c = j - (j / C) * C;
    return (((size_t)r * C + c) * Hq + (size_t)h * G + g) * kD;
  };
  auto qpos_of = [&](int j) -> int { return kv_len - C + j % C; };

  // the rows' last visible slots: the block's and the warp's latest, and
  // the warp's earliest (rows past GC do not exist and bound nothing)
  const int nb = min(kQRows, GC - j0);
  const int c_hi = (j0 % C) + nb > C ? C - 1 : (j0 + nb - 1) % C;
  const int q_hi = kv_len - C + c_hi;
  const int my_q = jw + (lane & 15) < GC ? qpos_of(jw + (lane & 15)) : -1;
  const int warp_q_hi = __reduce_max_sync(0xffffffffu, my_q);
  const int warp_q_lo = __reduce_min_sync(
      0xffffffffu, jw + (lane & 15) < GC ? my_q : 0x7fffffff);
  const int live_keys = min(kv_len, maxp * ps);   // the table's pages
  const int k_lo = split * pps * ps;
  const int k_hi = min(min(live_keys, (split + 1) * pps * ps), q_hi + 1);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kKT - 1) / kKT : 0;

  // the warp's 16 query rows as A fragments: rows lane/4 and lane/4 + 8
  const int r0 = lane >> 2;
  const bool ok0 = jw + r0 < GC, ok1 = jw + r0 + 8 < GC;
  const int qp[2] = {ok0 ? qpos_of(jw + r0) : -1,
                     ok1 ? qpos_of(jw + r0 + 8) : -1};
  uint32_t qa[kD / 16][4];
  {
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
  float acc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  const int* table_row = tables + (size_t)r * maxp;
  // bf16: stages at tiles [0, 2) and [2, 4) (K, V each); e5m2: raw stages
  // in the first two tiles' bytes, the widened K/V in tiles 2 and 3
  auto stage_k = [&](int slot) -> uint8_t* {
    return smem + (kFp8 ? slot * kTileBytes : slot * 2 * kTileBytes);
  };
  auto stage_v = [&](int slot) -> uint8_t* {
    return stage_k(slot) + (kFp8 ? kTileBytes / 2 : kTileBytes);
  };
  if (n_tiles > 0)
    stage_tile<KV, kThreads, kKT>(stage_k(0), stage_v(0), kpool, vpool,
                                  table_row, k_lo, k_hi, h, Hkv, ps, n_pages);
  hopper::cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_lo + t * kKT;
    if (t + 1 < n_tiles)
      stage_tile<KV, kThreads, kKT>(stage_k((t + 1) & 1),
                                    stage_v((t + 1) & 1), kpool, vpool,
                                    table_row, k0 + kKT, k_hi, h, Hkv, ps,
                                    n_pages);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    const uint8_t* kt;
    const uint8_t* vt;
    if constexpr (kFp8) {
      widen_tile<kThreads, kKT>(stage_k(t & 1), stage_v(t & 1),
                           smem + 2 * kTileBytes, smem + 3 * kTileBytes);
      __syncthreads();
      kt = smem + 2 * kTileBytes;
      vt = smem + 3 * kTileBytes;
    } else {
      kt = stage_k(t & 1);
      vt = stage_v(t & 1);
    }
    // warp-uniform: a tile wholly past the warp's last visible slot
    // changes none of its rows' m, l or acc; a tile every one of whose
    // keys each row sees needs no mask
    if (k0 <= warp_q_hi) {
      const bool masked = k0 + kKT - 1 > warp_q_lo || k0 + kKT > k_hi;
      float s[kKT / 8][4];
#pragma unroll
      for (int i = 0; i < kKT / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kD / 16; ++kc) {
#pragma unroll
        for (int np = 0; np < kKT / 8; np += 2) {
          const int key = np * 8 + (lane >> 4) * 8 + (lane & 7);
          const int c = kc * 2 + ((lane >> 3) & 1);
          uint32_t b0, b1, b2, b3;
          hopper::ldsm_x4(b0, b1, b2, b3, kt + kv_chunk(key, c) * 16);
          hopper::mma_bf16(s[np], qa[kc], b0, b1);
          hopper::mma_bf16(s[np + 1], qa[kc], b2, b3);
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < kKT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e >> 1;
          float v = s[nt][e] * scale;
          if (masked) {
            const int kpos = k0 + nt * 8 + (lane & 3) * 2 + (e & 1);
            if (!(kpos < k_hi && kpos <= qp[row])) v = kNegInf;
          }
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
      for (int nt = 0; nt < kKT / 8; ++nt)
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
      for (int dn = 0; dn < kD / 8; ++dn) {
        acc[dn][0] *= alpha[0];
        acc[dn][1] *= alpha[0];
        acc[dn][2] *= alpha[1];
        acc[dn][3] *= alpha[1];
      }
      // P.V: score tiles (2kk, 2kk + 1) are the A fragment of keys
      // [16kk, 16kk + 16), p rounded to bf16
#pragma unroll
      for (int kk = 0; kk < kKT / 16; ++kk) {
        const uint32_t pa[4] = {
            hopper::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            hopper::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            hopper::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            hopper::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const int key = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
        for (int dn = 0; dn < kD / 8; dn += 2) {
          uint32_t b0, b1, b2, b3;
          hopper::ldsm_x4_trans(b0, b1, b2, b3,
                                vt + kv_chunk(key, dn + (lane >> 4)) * 16);
          hopper::mma_bf16(acc[dn], pa, b0, b1);
          hopper::mma_bf16(acc[dn + 1], pa, b2, b3);
        }
      }
    }
    __syncthreads();       // the tile's slot is refilled next iteration
  }
  hopper::cp_async_wait<0>();

  // this split's fp32 partials of the warp's rows: (m, l) and the
  // unnormalised accumulator
  const size_t ws_row =
      (((size_t)r * Hkv + h) * n_splits + split) * (size_t)GC;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int j = jw + r0 + 8 * row;
    if (j >= GC) continue;
    float* a = ws_acc + (ws_row + j) * kD;
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      const int d = dn * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(a + d) =
          make_float2(acc[dn][2 * row], acc[dn][2 * row + 1]);
    }
    if ((lane & 3) == 0) ws_ml[ws_row + j] = make_float2(m[row], l[row]);
  }
}

// a warp per query row (four rows a block, grid (ceil(GC/4), kv head,
// row)): lane l merges output dims 4l .. 4l+3 of the row's splits in split
// order; a split that saw no visible key (l == 0) contributes nothing
__global__ void __launch_bounds__(kMergeThreads)
paged_merge_kernel(const float* __restrict__ ws_acc,
                   const float2* __restrict__ ws_ml,
                   __nv_bfloat16* __restrict__ out, int C, int Hq, int Hkv,
                   int n_splits) {
  const int G = Hq / Hkv;
  const int GC = G * C;
  const int j = blockIdx.x * (kMergeThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.y;
  const int r = blockIdx.z;
  if (j >= GC) return;
  const size_t base = ((size_t)r * Hkv + h) * n_splits * (size_t)GC + j;
  float m_all = kNegInf;
  for (int s = 0; s < n_splits; ++s) {
    const float2 ml = ws_ml[base + (size_t)s * GC];
    if (ml.y > 0.f) m_all = fmaxf(m_all, ml.x);
  }
  const float m_ref = fmaxf(m_all, kFloor);
  float l = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < n_splits; ++s) {
    const float2 ml = ws_ml[base + (size_t)s * GC];
    if (!(ml.y > 0.f)) continue;
    const float w = expf(fmaxf(ml.x, kFloor) - m_ref);
    l = fmaf(ml.y, w, l);
    const float4 a = *reinterpret_cast<const float4*>(
        ws_acc + (base + (size_t)s * GC) * kD + 4 * lane);
    o.x = fmaf(a.x, w, o.x);
    o.y = fmaf(a.y, w, o.y);
    o.z = fmaf(a.z, w, o.z);
    o.w = fmaf(a.w, w, o.w);
  }
  const float inv = l == 0.f ? 1.f : l;
  const int g = j / C, c = j % C;
  const size_t off = (((size_t)r * C + c) * Hq + (size_t)h * G + g) * kD;
  *reinterpret_cast<uint2*>(out + off + 4 * lane) =
      make_uint2(hopper::pack_bf16(o.x / inv, o.y / inv),
                 hopper::pack_bf16(o.z / inv, o.w / inv));
}

template <typename KV, int WARPS>
int launch_split(dim3 grid, cudaStream_t st, const void* q,
                 const void* kpool, const void* vpool, const void* tables,
                 const void* kv_len, float* acc, float2* ml, int C, int Hq,
                 int Hkv, int ps, int n_pages, int maxp, int n_qtiles,
                 int n_splits, int pps, float scale) {
  constexpr int smem = smem_bytes<key_tile<WARPS>()>();
  cudaError_t e = cudaFuncSetAttribute(
      paged_split_kernel<KV, WARPS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  paged_split_kernel<KV, WARPS><<<grid, 32 * WARPS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(kpool),
      static_cast<const KV*>(vpool), static_cast<const int*>(tables),
      static_cast<const int*>(kv_len), acc, ml, C, Hq, Hkv, ps, n_pages,
      maxp, n_qtiles, n_splits, pps, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q bf16 [R,C,Hq,D] (4-byte aligned); pools [P,Hkv,ps,D] bf16 (kv_fp8=0)
// or e5m2 (kv_fp8=1), 16-byte aligned; tables int32 [R,maxp]; kv_len int32
// [R]; ws_acc fp32 [R,Hkv,n_splits,GC,D] and ws_ml fp32
// [R,Hkv,n_splits,GC,2] (GC = Hq/Hkv*C) are scratch the caller allocates;
// out bf16 [R,C,Hq,D].  D is 128, ps a multiple of 32 (pages cut no 16-byte
// chunk); q_rows the query rows of a block: 64 (four warps) or 16 (one).
// Launches pass 1 (n_splits splits of pps pages) then pass 2 on `stream`;
// returns the first non-zero cudaGetLastError() of the two, or
// cudaErrorInvalidValue for another D, page size or q_rows.
extern "C" int paged_attention(const void* q, const void* kpool,
                               const void* vpool, const void* tables,
                               const void* kv_len, void* ws_acc, void* ws_ml,
                               void* out, int R, int C, int Hq, int Hkv,
                               int D, int ps, int n_pages, int maxp,
                               int n_splits, int pps, int q_rows, int kv_fp8,
                               float scale, void* stream) {
  if (D != kD || ps % 32 || (q_rows != 16 && q_rows != 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int gc = (Hq / Hkv) * C;
  const int n_qtiles = (gc + q_rows - 1) / q_rows;
  const dim3 grid(n_qtiles * n_splits, Hkv, R);
  float* acc = static_cast<float*>(ws_acc);
  float2* ml = static_cast<float2*>(ws_ml);
  int err;
#define B5_LAUNCH(KV, WARPS)                                                 \
  launch_split<KV, WARPS>(grid, st, q, kpool, vpool, tables, kv_len, acc,   \
                          ml, C, Hq, Hkv, ps, n_pages, maxp, n_qtiles,       \
                          n_splits, pps, scale)
  if (kv_fp8)
    err = q_rows == 64 ? B5_LAUNCH(uint8_t, 4) : B5_LAUNCH(uint8_t, 1);
  else
    err = q_rows == 64 ? B5_LAUNCH(uint16_t, 4) : B5_LAUNCH(uint16_t, 1);
#undef B5_LAUNCH
  if (err) return err;
  paged_merge_kernel<<<dim3((gc + 3) / 4, Hkv, R), kMergeThreads, 0, st>>>(
      acc, ml, static_cast<__nv_bfloat16*>(out), C, Hq, Hkv, n_splits);
  return (int)cudaGetLastError();
}
