// Flash attention for Hopper: tiled online-softmax SDPA for prefill, on the
// tensor cores.
//
// Replaces the TPU kernel ipex_llm_tpu/ops/pallas/flash_attention.py::
// flash_sdpa (body _flash, _kernel).  Semantics kept exactly:
//   - q [B, T, Hq, D] bf16; k/v [B, S, Hkv, D] bf16 given by strides, so
//     the dense cache's head-major [B, Hkv, S, D] layer is read in place;
//     q head h reads kv head h / (Hq / Hkv);
//   - key slot kpos is visible iff kv_start <= kpos < kv_len and, when
//     causal, kpos <= qpos (the query's absolute slot) and, with the window
//     on for the row, kpos > qpos - window; the non-causal form applies
//     only kv_start/kv_len (no window), as the TPU kernel does;
//   - s = (q . k) * scale in fp32 from bf16 inputs, then softcap
//     tanh(s / c) * c, then the mask; online softmax in fp32; l sums the
//     fp32 p, the P.V product takes p rounded to bf16; one rounding of the
//     output; a query that sees no key gives 0 (l == 0 -> denominator 1).
//
// What bounds it: the score and value products, 4 * D operations per
// visible (query, key) pair, so the bf16 tensor cores.
//
// Design (wgmma on the tensor cores).  A block is one warpgroup (4 warps)
// and owns 64 queries of one (row, q head); warp w holds rows 16w..16w+15,
// its Q as register A fragments.  The block walks 64-key tiles only from
// the first slot any of its queries can see (kv_start, or with the window
// on qpos_min - window + 1) to the last (kv_len, or qpos_max + 1 with
// causal masking): the pad slots of a left-padded bucket and the far past
// of a sliding window are never read.  K and V tiles (16 KiB each, bf16 as
// stored) stream through a ring of three stages of shared memory with
// 16-byte cp.async, two tiles in flight while one is computed, laid out
// with the 128-byte swizzle that wgmma's descriptors read (two 64-dim
// halves of 64 rows of 128 bytes); keys outside [kv_start, kv_len) are
// zero-filled, so no uninitialised slot can reach the sums.  S = Q.K^T is
// eight wgmma m64n64k16 (Q from registers, K K-major from shared memory);
// the online softmax runs in registers in base 2 (scale * log2(e) folded
// into the scores; row max and sum over the quad that holds a row); P is
// rounded to bf16 in the score registers, which are the A fragments of
// O += P.V, four wgmma m64n128k16 with V MN-major (transposed by the
// descriptor).  Each warp classifies each tile for its own 16 rows
// (warp-uniform): a tile it cannot see gives it P = 0 and no softmax
// work (exact: m, l and acc are unchanged), interior tiles skip the mask,
// and only tiles that cross kv_start, kv_len, the diagonal or the window
// edge compare slots (ops/cuda/flash_attention.py::tile_kind mirrors the
// rule).  The softcap is a template flag, so the common instance has no
// tanh.  Under causal masking the q tiles launch last first (grid z
// reversed, heads and rows fastest), so the tiles with the most keys start
// in the first wave.
//
// Two instances of the head dim D, 128 and 256 (Gemma-2).  At 256 the
// 64 x 256 fp32 accumulator takes 128 registers a thread, and Q's
// register fragments as many again, which does not fit under 255: that
// instance keeps the block's 64 query rows in shared memory (32 KiB, four
// 64-dim swizzled blocks, staged with the first tile) and reads them
// through a descriptor (wgmma with A from shared memory), runs O += P.V as
// two m64n128k16 per 16 keys (one on each 128-dim half of O), and holds
// two stages of 64 KiB K/V tile pairs (161 KiB in all, one block an SM).
//
// A third instance, D = 96 (Phi-3-mini), is the 128 one over a tile laid
// out at 128 columns: a 96-column row is one and a half 64-column swizzle
// atoms, so the kernel stages the 96 columns the layer holds into the
// 128-column swizzled tile (never padding a copy in HBM) and writes zeros
// once, before the first tile, into the 32 columns no copy fills, as the
// Pallas kernel pads to 128 in VMEM.  S = Q.K^T takes the six 16-dim
// steps of the 96 (Q's six fragments in registers, K's pad never read);
// O += P.V stays one m64n128k16 per 16 keys over the padded V, whose zero
// columns give the accumulator 32 columns the kernel does not write out
// (a quarter of the P.V products wasted, 64 accumulator registers).
//
// A fifth instance, D = 80 (Phi-2 and phixtral), is the 96 one at a
// narrower width: the 80 columns staged into the 128-column tile (the
// first 16 of the second 64-dim block), zeros written once into the 48 no
// copy fills; five 16-dim steps of S = Q.K^T (Q's five fragments in
// registers) and one m64n128k16 per 16 keys of O += P.V over the padded
// V, 48 of whose accumulator columns are never written out (37.5% of the
// P.V products wasted).
//
// A fourth instance reads K and V at different widths: DeepSeek's MLA, K
// at D = 192 (three 64-dim swizzled blocks a tile, 24 KiB: S = Q.K^T is
// twelve m64n64k16 steps, Q's twelve fragments in registers) and V at
// Dv = 128 (two blocks, 16 KiB: O += P.V stays one m64n128k16 per 16 keys,
// 64 accumulator registers).  K and V carry their own strides (a (D, D)
// instance reads V through K's).  So that
// two blocks still fit an SM, that instance rings two stages of its 40 KiB
// tile pairs (81 KiB in all).  The other instances read both at one
// width, with one set of strides passed twice, as before.
//
// Two more serve MiniCPM (and the 64-wide heads of Llama-3.2-1B and
// TinyLlama).  (64, 64) (MiniCPM-2B): a 64-column row is one 64-dim
// swizzled block, so the tiles are native (8 KiB each, three stages in
// 48 KiB, no pad): S = Q.K^T four m64n64k16 steps, O += P.V one
// m64n64k16 per 16 keys over V MN-major, no wasted column, 32
// accumulator registers.  (96, 64) (MiniCPM3's MLA: K 64 nope + 32
// rope, V 64): the K tile the 96 instance's (128 columns, 96 staged, six
// score steps), the V tile and O += P.V the 64 instance's; only K's pad
// is zeroed.
//
// The training forward (ops/attention.py's autograd Function) takes the
// LSE instance (head dim 128, no softcap): the same kernel that also
// writes each query's log-sum-exp of its scaled scores, lse = m + log l in
// natural units, to an fp32 [B, Hq, T] buffer (+inf for a query that sees
// no key), which the backward kernels (csrc/flash_attention_bwd.cu) read
// to rebuild P without a second pass over the keys.  The serving
// instances are compiled from the same source with the flag off.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;            // 4 warps
constexpr int kBQ = 64;                  // queries per block (4 warps x 16)
constexpr int kBK = 64;                  // keys per tile
constexpr int kSN = kBK / 8;             // n8 score tiles per warp
constexpr float kNegInf = -1e30f;        // the reference's NEG_INF
constexpr float kFloor = -1e29f;         // the reference's m clamp
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlockBytes = kBK * 128;   // 64 dims of 64 rows (swizzled)
constexpr int kBig = 0x3fffffff;

// the instance of K width D and V width Dv (flash_attention.py::smem_plan)
template <int D, int Dv>
struct Plan {
  // a tile row's columns: the width, but 128 at 80 and 96 (64 is one
  // 64-dim swizzled block)
  static constexpr int kPadD = D == 64 || D >= 128 ? D : 128;     // K's
  static constexpr int kPadDv = Dv == 64 || Dv >= 128 ? Dv : 128; // V's
  static constexpr int kTileK = kBK * kPadD * 2;      // one bf16 K tile
  static constexpr int kTileV = kBK * kPadDv * 2;     // one bf16 V tile
  static constexpr bool kQSmem = D > 192;             // Q from a descriptor
  static constexpr int kStages = D <= 128 ? 3 : 2;    // K/V ring depth
  static constexpr int kResident = D <= 192 ? 2 : 1;  // blocks an SM holds
  static constexpr int kQOff = kStages * (kTileK + kTileV);
  // the stages, Q's rows at D = 256, and the slack to align them to 1024
  // bytes (the swizzle): 96 KiB + 1 KiB at D = 96 and 128, 80 KiB + 1 KiB
  // at (192, 128), 160 KiB + 1 KiB at 256
  static constexpr int kSmem =
      kQOff + (kQSmem ? kBQ * D * 2 : 0) + 1024;
  static_assert(kSmem <= 232448, "exceeds a block's shared memory");
  static_assert(kResident * (kSmem + 1024) <= 233472,
                "the resident blocks fit an SM");
  static_assert(Dv == kPadDv || D == Dv, "only a (D, D) instance pads V");
};

// the tile kinds of one warp's 16 rows (flash_attention.py::tile_kind)
constexpr int kSkip = 0, kFree = 1, kMasked = 2;

__device__ __forceinline__ int tile_kind(int kt, int qmin, int qmax,
                                         bool live, int kvs, int kvl,
                                         bool causal, bool win, int window) {
  if (!live) return kSkip;
  if (causal && kt > qmax) return kSkip;
  if (win && kt + kBK - 1 <= qmin - window) return kSkip;
  if (kt + kBK <= kvs || kt >= kvl) return kSkip;
  const bool no_mask = kt >= kvs && kt + kBK <= kvl &&
                       (!causal || (kt + kBK - 1 <= qmin &&
                                    (!win || kt > qmax - window)));
  return no_mask ? kFree : kMasked;
}

// stage the keys [k0, k0 + 64) of one kv head into `kd`/`vd` (each D / 64
// 128-byte swizzled blocks: dims 0-63, then 64-127, ...; at D = 96 the
// first half of the second block); keys outside [kvs, kvl) are zeros.  A
// V row narrower than K's (Dv < D) takes the first Dv / 8 of each key's
// chunks, at V's own stride vss
template <int D, int Dv>
__device__ __forceinline__ void stage_tile(uint8_t* kd, uint8_t* vd,
                                           const __nv_bfloat16* kh,
                                           const __nv_bfloat16* vh,
                                           long long kss, long long vss,
                                           int k0, int kvs, int kvl) {
  static_assert(Dv <= D, "V is at most K's width");
  // unsigned: the chunk index splits with a shift and a mask
  for (unsigned i = threadIdx.x; i < kBK * (D / 8); i += kThreads) {
    const int key = i / (D / 8), c = i % (D / 8);
    const int kpos = k0 + key;
    const bool ok = kpos >= kvs && kpos < kvl;
    const int dst = (c >> 3) * kBlockBytes + hopper::sw128_offset(key, c & 7);
    hopper::cp_async<16>(kd + dst, kh + (ok ? (size_t)kpos * kss + c * 8 : 0),
                         ok);
    if (Dv == D || c < Dv / 8)
      hopper::cp_async<16>(vd + dst,
                           vh + (ok ? (size_t)kpos * vss + c * 8 : 0), ok);
  }
}

template <int D, int Dv, bool SOFTCAP, bool LSE>
__global__ void __launch_bounds__(kThreads, Plan<D, Dv>::kResident)
flash_attn_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ qpos_arr,   // [B, T]
                  const int* __restrict__ kv_len_arr,
                  const int* __restrict__ kv_start_arr,
                  const int* __restrict__ won_arr,
                  __nv_bfloat16* __restrict__ out,
                  float* __restrict__ lse_out,        // [B, Hq, T] (LSE)
                  int T, int Hq, int Hkv,
                  int S, long long ksb, long long kss, long long ksh,
                  long long vsb, long long vss, long long vsh,
                  float scale, int causal_i, int window, float softcap) {
  using P = Plan<D, Dv>;
  if constexpr (D == Dv) {
    // a (D, D) instance reads V through K's strides (the wrapper checks
    // that they are the same), so its addressing is one set's, as before
    vsb = ksb;
    vss = kss;
    vsh = ksh;
  }
  constexpr int kStages = P::kStages;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  __shared__ int qmin_s[4], qmax_s[4];
  uint8_t* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);

  const int hq = blockIdx.x;
  const int b = blockIdx.y;
  const bool causal = causal_i != 0;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * kBQ;
  const int hkv = hq / (Hq / Hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kvs = max(kv_start_arr[b], 0);
  const int kvl = min(kv_len_arr[b], S);
  const bool win = causal && window > 0 && won_arr[b] != 0;

  const __nv_bfloat16* kh = k + (size_t)b * ksb + (size_t)hkv * ksh;
  const __nv_bfloat16* vh = v + (size_t)b * vsb + (size_t)hkv * vsh;
  if constexpr (D != P::kPadD) {
    // the tile columns [D, kPadD) no copy fills: zeros, once (the fence
    // before each tile's first wgmma makes them visible to it); at (96,
    // 64) only K's, which S's six steps never read either
    constexpr int kPadChunks = (P::kPadD - D) / 8;
    constexpr int kTiles = Dv == D ? 2 : 1;     // K and V, or K alone
    for (int i = threadIdx.x; i < kStages * kTiles * kBK * kPadChunks;
         i += kThreads) {
      const int tile = i / (kBK * kPadChunks);
      const int rem = i % (kBK * kPadChunks);
      const int key = rem / kPadChunks, c = D / 8 + rem % kPadChunks;
      *reinterpret_cast<uint4*>(
          smem + (tile / kTiles) * (P::kTileK + P::kTileV) +
          (tile % kTiles) * P::kTileK + (c >> 3) * kBlockBytes +
          hopper::sw128_offset(key, c & 7)) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // the warp's rows' slot range (live rows only), then the block's
  const int jw = q0 + warp * 16;            // the warp's first query
  const int my_t = jw + (lane & 15);
  const bool my_live = lane < 16 && my_t < T;
  const int my_p = my_live ? qpos_arr[(size_t)b * T + my_t] : 0;
  const int wq_min = __reduce_min_sync(0xffffffffu, my_live ? my_p : kBig);
  const int wq_max = __reduce_max_sync(0xffffffffu, my_live ? my_p : -kBig);
  const bool w_live = jw < T;
  if (lane == 0) {
    qmin_s[warp] = wq_min;
    qmax_s[warp] = wq_max;
  }
  __syncthreads();
  const int bq_min = min(min(qmin_s[0], qmin_s[1]), min(qmin_s[2], qmin_s[3]));
  const int bq_max = max(max(qmax_s[0], qmax_s[1]), max(qmax_s[2], qmax_s[3]));
  int lo = kvs, hi = kvl;
  if (causal) hi = min(hi, bq_max + 1);
  if (win) lo = max(lo, bq_min - window + 1);
  const int kt0 = (lo / kBK) * kBK;
  const int n_tiles = hi > lo ? (hi - kt0 + kBK - 1) / kBK : 0;

  auto stage_k = [&](int slot) {
    return smem + slot * (P::kTileK + P::kTileV);
  };
  auto stage_v = [&](int slot) { return stage_k(slot) + P::kTileK; };
  uint8_t* q_s = smem + P::kQOff;
  if constexpr (P::kQSmem) {
    // the block's 64 query rows (a row past T is zeros), in D / 64 swizzled
    // blocks as a K tile, join the first tile's group
    for (int i = threadIdx.x; i < kBQ * (D / 8); i += kThreads) {
      const int row = i / (D / 8), c = i % (D / 8);
      const bool ok = q0 + row < T;
      hopper::cp_async<16>(
          q_s + (c >> 3) * kBlockBytes + hopper::sw128_offset(row, c & 7),
          q + (ok ? (((size_t)b * T + q0 + row) * Hq + hq) * D + c * 8 : 0),
          ok);
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles)
      stage_tile<D, Dv>(stage_k(s), stage_v(s), kh, vh, kss, vss,
                        kt0 + s * kBK, kvs, kvl);
    hopper::cp_async_commit();
  }

  // the warp's 16 query rows as A fragments: rows lane/4 and lane/4 + 8
  // (at D = 256 they stay in shared memory)
  const int r0 = lane >> 2;
  const int t_row[2] = {jw + r0, jw + r0 + 8};
  int qp[2];
  uint32_t qa[P::kQSmem ? 1 : D / 16][4];
  {
    const bool ok0 = t_row[0] < T, ok1 = t_row[1] < T;
    // a row past T sees no key
    qp[0] = ok0 ? qpos_arr[(size_t)b * T + t_row[0]] : -kBig;
    qp[1] = ok1 ? qpos_arr[(size_t)b * T + t_row[1]] : -kBig;
    if constexpr (!P::kQSmem) {
      const uint32_t* qr0 = reinterpret_cast<const uint32_t*>(
          q + (ok0 ? (((size_t)b * T + t_row[0]) * Hq + hq) * D : 0));
      const uint32_t* qr1 = reinterpret_cast<const uint32_t*>(
          q + (ok1 ? (((size_t)b * T + t_row[1]) * Hq + hq) * D : 0));
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const int d2 = (kc * 16 + (lane & 3) * 2) / 2;   // in bf16 pairs
        qa[kc][0] = ok0 ? __ldg(qr0 + d2) : 0u;
        qa[kc][1] = ok1 ? __ldg(qr1 + d2) : 0u;
        qa[kc][2] = ok0 ? __ldg(qr0 + d2 + 4) : 0u;
        qa[kc][3] = ok1 ? __ldg(qr1 + d2 + 4) : 0u;
      }
    }
  }
  const float sl2 = scale * kLog2e;         // scores in base-2 units
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  constexpr int kPadDv = P::kPadDv;
  float acc[kPadDv / 8][4];
#pragma unroll
  for (int i = 0; i < kPadDv / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kt = kt0 + t * kBK;
    {
      const int tn = t + kStages - 1;
      if (tn < n_tiles)
        stage_tile<D, Dv>(stage_k(tn % kStages), stage_v(tn % kStages), kh,
                          vh, kss, vss, kt0 + tn * kBK, kvs, kvl);
      hopper::cp_async_commit();
    }
    hopper::cp_async_wait<kStages - 1>();
    hopper::fence_proxy_async();     // the copies, visible to wgmma
    __syncthreads();
    const uint8_t* ks = stage_k(t % kStages);
    const uint8_t* vs = stage_v(t % kStages);
    const int kind = tile_kind(kt, wq_min, wq_max, w_live, kvs, kvl, causal,
                               win, window);
    // S = Q.K^T for the warpgroup's 64 rows: 8 steps of 16 dims
    float s[kSN][4];
#pragma unroll
    for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint64_t kdesc = hopper::sw128_desc(
          ks + (kc >> 2) * kBlockBytes + (kc & 3) * 32, 16, 1024);
      if constexpr (P::kQSmem)
        hopper::wgmma_m64n64k16_ss<0>(
            &s[0][0],
            hopper::sw128_desc(q_s + (kc >> 2) * kBlockBytes + (kc & 3) * 32,
                               16, 1024),
            kdesc, kc);
      else
        hopper::wgmma_m64n64k16_rs<0>(&s[0][0], qa[kc], kdesc, kc);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<kSN * 4>(&s[0][0]);
    if (kind == kSkip) {
#pragma unroll
      for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;    // P = 0
    } else {
#pragma unroll
      for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x;
          if constexpr (SOFTCAP) {
            x = tanhf(s[nt][e] * scale / softcap) * softcap * kLog2e;
          } else {
            x = s[nt][e] * sl2;
          }
          s[nt][e] = x;
        }
      if (kind == kMasked) {
#pragma unroll
        for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = kt + nt * 8 + (lane & 3) * 2 + (e & 1);
            const int p = qp[e >> 1];
            bool vis = kpos >= kvs && kpos < kvl;
            if (causal) {
              vis = vis && kpos <= p;
              if (win) vis = vis && kpos > p - window;
            }
            if (!vis) s[nt][e] = kNegInf;
          }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
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
      for (int nt = 0; nt < kSN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[nt][e] - mx[e >> 1]);
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
      for (int dn = 0; dn < kPadDv / 8; ++dn) {
        acc[dn][0] *= alpha[0];
        acc[dn][1] *= alpha[0];
        acc[dn][2] *= alpha[1];
        acc[dn][3] *= alpha[1];
      }
    }
    // O += P.V: the score blocks (2kk, 2kk + 1) are the A fragment of keys
    // [16kk, 16kk + 16), p rounded to bf16; 4 steps of 16 keys
    uint32_t pa[kSN / 2][4];
#pragma unroll
    for (int kk = 0; kk < kSN / 2; ++kk) {
      pa[kk][0] = hopper::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = hopper::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = hopper::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = hopper::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    hopper::fence_regs<kPadDv / 2>(&acc[0][0]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSN / 2; ++kk) {
      if constexpr (kPadDv == 64) {     // O is one 64-dim block
        hopper::wgmma_m64n64k16_rs<1>(
            &acc[0][0], pa[kk],
            hopper::sw128_desc(vs + kk * 16 * 128, kBlockBytes, 1024), 1);
      } else {
#pragma unroll
        for (int dh = 0; dh < kPadDv / 128; ++dh)   // 128-dim halves of O
          hopper::wgmma_m64n128k16_rs<1>(
              &acc[dh * 16][0], pa[kk],
              hopper::sw128_desc(vs + dh * 2 * kBlockBytes + kk * 16 * 128,
                                 kBlockBytes, 1024),
              1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<kPadDv / 2>(&acc[0][0]);
    __syncthreads();       // the tile's slot is refilled next iteration
  }
  hopper::cp_async_wait<0>();

#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int t = t_row[row];
    if (t >= T) continue;
    if constexpr (LSE) {
      // m is in base-2 units of the scaled scores (m > kFloor wherever
      // l > 0); a query with no visible key gets +inf, so P = 0 there
      if ((lane & 3) == 0)
        lse_out[((size_t)b * Hq + hq) * T + t] =
            l[row] > 0.f ? (m[row] + log2f(l[row])) * 0.6931471805599453f
                         : __int_as_float(0x7f800000);
    }
    const float inv = 1.f / (l[row] == 0.f ? 1.f : l[row]);
    __nv_bfloat16* o = out + (((size_t)b * T + t) * Hq + hq) * Dv;
#pragma unroll
    for (int dn = 0; dn < Dv / 8; ++dn) {
      const int d = dn * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(o + d) = hopper::pack_bf16(
          acc[dn][2 * row] * inv, acc[dn][2 * row + 1] * inv);
    }
  }
}

template <int D, int Dv, bool SOFTCAP, bool LSE = false>
int launch(dim3 grid, cudaStream_t st, const void* q, const void* k,
           const void* v, const void* qpos, const void* kv_len,
           const void* kv_start, const void* won, void* out, void* lse,
           int T, int Hq, int Hkv, int S, long long ksb, long long kss,
           long long ksh, long long vsb, long long vss, long long vsh,
           float scale, int causal, int window, float softcap) {
  constexpr int kSmem = Plan<D, Dv>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attn_kernel<D, Dv, SOFTCAP, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  flash_attn_kernel<D, Dv, SOFTCAP, LSE><<<grid, kThreads, kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kv_len), static_cast<const int*>(kv_start),
      static_cast<const int*>(won), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), T, Hq, Hkv, S, ksb, kss, ksh, vsb, vss, vsh,
      scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// q bf16 [B,T,Hq,D] contiguous; k bf16 [B,S,Hkv,D] with element strides
// (ksb, kss, ksh) and v bf16 [B,S,Hkv,Dv] with (vsb, vss, vsh) over (B, S,
// Hkv), multiples of 8, and a contiguous last dim, 16-byte aligned; qpos
// int32 [B,T]; kv_len, kv_start, won int32 [B]; out bf16 [B,T,Hq,Dv]; lse
// fp32 [B,Hq,T] or null (the LSE instance: D = Dv = 128, no softcap).
// (D, Dv) = (64, 64), (80, 80), (96, 64), (96, 96), (128, 128), (192,
// 128) or (256, 256); window <= 0
// means none, softcap <= 0 none.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for another pair, or an lse buffer outside the
// LSE instance).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* qpos, const void* kv_len,
                               const void* kv_start, const void* won,
                               void* out, int B, int T, int Hq, int Hkv,
                               int S, int D, int Dv, long long ksb,
                               long long kss, long long ksh, long long vsb,
                               long long vss, long long vsh, float scale,
                               int causal, int window, float softcap,
                               void* lse, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool pair = D == Dv ? (D == 64 || D == 80 || D == 96 || D == 128 ||
                               D == 256)
                            : ((D == 192 && Dv == 128) ||
                               (D == 96 && Dv == 64));
  if (!pair || Hq % Hkv) return (int)cudaErrorInvalidValue;
  const dim3 grid(Hq, B, (T + kBQ - 1) / kBQ);
  const bool cap = softcap > 0.f;
  if (lse != nullptr) {
    if (D != 128 || Dv != 128 || cap) return (int)cudaErrorInvalidValue;
    return launch<128, 128, false, true>(grid, st, q, k, v, qpos, kv_len,
                                         kv_start, won, out, lse, T, Hq, Hkv,
                                         S, ksb, kss, ksh, vsb, vss, vsh,
                                         scale, causal, window, softcap);
  }
#define FLASH_LAUNCH(HD, HDV, CAP)                                         \
  launch<HD, HDV, CAP>(grid, st, q, k, v, qpos, kv_len, kv_start, won,     \
                       out, nullptr, T, Hq, Hkv, S, ksb, kss, ksh, vsb,    \
                       vss, vsh, scale, causal, window, softcap)
#define FLASH_LAUNCH_D(HD, HDV)                                            \
  (cap ? FLASH_LAUNCH(HD, HDV, true) : FLASH_LAUNCH(HD, HDV, false))
  const int err = D == 128   ? FLASH_LAUNCH_D(128, 128)
                  : D == 256 ? FLASH_LAUNCH_D(256, 256)
                  : D == 192 ? FLASH_LAUNCH_D(192, 128)
                  : D == 96  ? (Dv == 64 ? FLASH_LAUNCH_D(96, 64)
                                         : FLASH_LAUNCH_D(96, 96))
                  : D == 64  ? FLASH_LAUNCH_D(64, 64)
                             : FLASH_LAUNCH_D(80, 80);
#undef FLASH_LAUNCH_D
#undef FLASH_LAUNCH
  return err;
}
