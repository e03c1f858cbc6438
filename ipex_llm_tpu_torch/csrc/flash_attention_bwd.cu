// Flash attention's backward for Hopper: dQ, dK and dV of causal SDPA from
// q, k, v, the output's gradient dO and the forward's row log-sum-exp
// (csrc/flash_attention.cu's LSE instance).
//
// Replaces no TPU kernel: the JAX package has no backward Pallas kernel,
// its gradient is XLA's autodiff of ops/attention.py::sdpa_reference.
// This kernel computes the same gradient, that of the forward B4 computes
// (ops/cuda/flash_attention.py::flash_sdpa_plain's contract):
//   - q [B, T, Hq, D] bf16 contiguous; k/v [B, S, Hkv, D] bf16 given by
//     strides (a contiguous D), as the forward reads them; q head h reads
//     kv head h / (Hq / Hkv); dq [B, T, Hq, D] and dk/dv [B, S, Hkv, D]
//     bf16 contiguous; head dim 128;
//   - key slot kpos is visible to a query at slot qpos iff kv_start <=
//     kpos < kv_len and, when causal, kpos <= qpos (no window, no
//     softcap: the wrapper refuses them under a gradient);
//   - P = exp(s - lse) with s = scale (q . k) in fp32 from bf16 inputs;
//     dV = P^T dO, dP = dO V^T, dS = P (dP - Delta) with Delta =
//     rowsum(dO O) = sum over keys of P dP, recomputed in fp32 from the
//     fp32 P and dP (not from the bf16 output o, whose rounding Delta
//     would carry into dP - Delta: at a query that sees two or three
//     keys the two nearly cancel and dQ lost 2% of its largest value),
//     dQ = scale dS K, dK = scale dS^T Q; P and dS
//     are rounded to bf16 as operands of the products (as the forward
//     rounds P before P.V), sums in fp32, one rounding of each gradient.
//     A query that sees no key has lse = +inf, so P = 0 and its gradients
//     are 0.
//
// What bounds it: the products, 10 D operations per visible (query, key)
// pair at the least (S and dP once, dV, dK and dQ: 2.5 times the
// forward's 4 D), so the bf16 tensor cores.
//
// Design (simple, deterministic; a faster form with wgmma is later work).
// Two kernels, no atomics, so that two runs of a step are bitwise equal:
//   1. dq: a block owns 64 queries of one (row, q head), four warps of 16
//      rows; it walks the 64-key tiles its queries can see (the forward's
//      walk) twice, recomputing S = Q K^T and dP = dO V^T each time: the
//      first pass sums Delta = sum P dP for its queries (each thread over
//      its fragment in a fixed order, then over the four threads of a
//      row) and writes it for kernel 2, the second sums dQ += dS K in
//      registers (two of the second pass's three products again: the dq
//      kernel's cost rises by two thirds);
//   2. dkdv: a block owns 64 keys of one (row, kv head), four warps of 16
//      keys; it walks the G query heads of its kv head and, for each, the
//      64-query tiles that can see a key of the tile (a tile whose queries
//      all sit before the block's first key is skipped under causal
//      masking), recomputing S^T = K Q^T and dP^T = V dO^T, and sums dV
//      += P^T dO and dK += dS^T Q in registers: a kv head's G query heads
//      meet inside one block, in head order.
// Operands sit in shared memory as row-major tiles of 64 rows x 128 dims,
// each row padded by 8 elements (272 bytes, so the fragment reads of 8
// rows fall in distinct banks); the products are mma.sync m16n8k16 (bf16
// in, fp32 accumulators), with A fragments and the B fragments of a
// transposed operand read with 32-bit loads, and the B fragments of a
// row-major [k][n] operand with ldmatrix.trans.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;              // 4 warps
constexpr int kBQ = 64;                    // queries per tile
constexpr int kBK = 64;                    // keys per tile
constexpr int kD = 128;                    // head dim
constexpr int kLd = kD + 8;                // padded tile row, in bf16
constexpr int kTileElems = 64 * kLd;
constexpr int kSmem = 4 * kTileElems * 2;  // four tiles: 69,632 bytes
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBig = 0x3fffffff;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// 64 rows of kD bf16 into a padded shared tile: row r is global row
// row0 + r of `base` (row stride `stride` elements), read where it lies in
// [lo, hi) and zeros elsewhere
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          long long stride, int row0, int lo,
                                          int hi) {
  for (int i = threadIdx.x; i < 64 * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8), c = i % (kD / 8);
    const int g = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (g >= lo && g < hi)
      v = __ldg(reinterpret_cast<const uint4*>(base + (size_t)g * stride +
                                               c * 8));
    *reinterpret_cast<uint4*>(dst + r * kLd + c * 8) = v;
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// mma.sync's A fragment of rows r0..r0+15, columns k0..k0+15 of a tile
__device__ __forceinline__ void frag_a(uint32_t a[4], const __nv_bfloat16* t,
                                       int r0, int k0, int lane) {
  const int g = lane >> 2, c = k0 + (lane & 3) * 2;
  a[0] = ld32(t + (r0 + g) * kLd + c);
  a[1] = ld32(t + (r0 + g + 8) * kLd + c);
  a[2] = ld32(t + (r0 + g) * kLd + c + 8);
  a[3] = ld32(t + (r0 + g + 8) * kLd + c + 8);
}

// the B fragment of B = t^T (t stored [n][k]): columns n0..n0+7, k rows
// k0..k0+15
__device__ __forceinline__ void frag_bt(uint32_t& b0, uint32_t& b1,
                                        const __nv_bfloat16* t, int n0,
                                        int k0, int lane) {
  const int g = lane >> 2, c = k0 + (lane & 3) * 2;
  b0 = ld32(t + (n0 + g) * kLd + c);
  b1 = ld32(t + (n0 + g) * kLd + c + 8);
}

// the B fragments of B = t (t stored [k][n]) for the n8 tiles at n0 and
// n0 + 8, k rows k0..k0+15: b[j][0..1] of tile j
__device__ __forceinline__ void frag_b2(uint32_t b[2][2],
                                        const __nv_bfloat16* t, int k0,
                                        int n0, int lane) {
  const int row = k0 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const int col = n0 + (lane >> 4) * 8;
  hopper::ldsm_x4_trans(b[0][0], b[0][1], b[1][0], b[1][1],
                        t + row * kLd + col);
}

// acc[D/8 n8 tiles] += x[16 x 64] . t[64 x D]: x the warp's 8 score blocks
// (mma.sync's accumulator layout), rounded to bf16 as A fragments (blocks
// 2kk and 2kk + 1 are k columns 16kk..16kk+15), t a row-major tile
__device__ __forceinline__ void acc_product(float (*acc)[4],
                                            float (*x)[4],
                                            const __nv_bfloat16* t,
                                            int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = hopper::pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = hopper::pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = hopper::pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = hopper::pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dn = 0; dn < kD / 8; dn += 2) {
      uint32_t b[2][2];
      frag_b2(b, t, kk * 16, dn * 8, lane);
      hopper::mma_bf16(acc[dn], a, b[0][0], b[0][1]);
      hopper::mma_bf16(acc[dn + 1], a, b[1][0], b[1][1]);
    }
  }
}

// s[8 n8 tiles] = a_t[rows r0..r0+15] . b_t^T over kD (both row-major
// tiles): the warp's 16 x 64 block of scores
__device__ __forceinline__ void scores(float (*s)[4],
                                       const __nv_bfloat16* a_t, int r0,
                                       const __nv_bfloat16* b_t, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
    uint32_t a[4];
    frag_a(a, a_t, r0, kc * 16, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t b0, b1;
      frag_bt(b0, b1, b_t, nt * 8, kc * 16, lane);
      hopper::mma_bf16(s[nt], a, b0, b1);
    }
  }
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int kvs, int kvl,
                                        bool causal) {
  return kpos >= kvs && kpos < kvl && (!causal || kpos <= qpos);
}

// kernel 1: Delta and dQ for 64 queries of one (row, q head)
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const int* __restrict__ qpos_arr,
                    const int* __restrict__ kv_len_arr,
                    const int* __restrict__ kv_start_arr,
                    const float* __restrict__ lse,
                    float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int T, int Hq, int Hkv,
                    int S, long long ksb, long long kss, long long ksh,
                    float scale, int causal_i) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + kTileElems;
  __nv_bfloat16* k_s = do_s + kTileElems;
  __nv_bfloat16* v_s = k_s + kTileElems;
  __shared__ float lse_s[kBQ], delta_s[kBQ];
  __shared__ int qpos_s[kBQ];

  const int hq = blockIdx.x, b = blockIdx.y;
  const bool causal = causal_i != 0;
  // the tiles with the most keys first, as the forward launches them
  const int q0 = (causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * kBQ;
  const int hkv = hq / (Hq / Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kvs = max(kv_start_arr[b], 0), kvl = min(kv_len_arr[b], S);
  const long long qrow = (long long)Hq * kD;   // row stride of q, dO
  const size_t qoff = ((size_t)b * T * Hq + hq) * kD;
  const size_t roff = ((size_t)b * Hq + hq) * T;   // lse / Delta rows

  load_tile(q_s, q + qoff, qrow, q0, 0, T);
  load_tile(do_s, dout + qoff, qrow, q0, 0, T);
  if (threadIdx.x < kBQ) {
    const int t = q0 + threadIdx.x;
    lse_s[threadIdx.x] = t < T ? lse[roff + t] * kLog2e : inf_f();
    qpos_s[threadIdx.x] = t < T ? qpos_arr[(size_t)b * T + t] : -kBig;
  }
  __syncthreads();

  // the block's live query slots, then the key tiles they can see
  int qmin = kBig, qmax = -kBig;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int p = qpos_s[lane + 32 * j];
    if (q0 + lane + 32 * j < T) {
      qmin = min(qmin, p);
      qmax = max(qmax, p);
    }
  }
  qmin = __reduce_min_sync(0xffffffffu, qmin);
  qmax = __reduce_max_sync(0xffffffffu, qmax);
  int lo = kvs, hi = kvl;
  if (causal) hi = min(hi, qmax + 1);
  const int kt0 = (lo / kBK) * kBK;
  const int n_tiles = hi > lo ? (hi - kt0 + kBK - 1) / kBK : 0;

  const int g = lane >> 2;
  const int rl[2] = {warp * 16 + g, warp * 16 + g + 8};
  const float sl2 = scale * kLog2e;
  float dq_acc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[i][e] = 0.f;

  const __nv_bfloat16* kh = k + (size_t)b * ksb + (size_t)hkv * ksh;
  const __nv_bfloat16* vh = v + (size_t)b * ksb + (size_t)hkv * ksh;
  {
    // pass 1: Delta = sum over visible keys of P dP, fp32
    float dsum[2] = {0.f, 0.f};
    for (int it = 0; it < n_tiles; ++it) {
      const int kt = kt0 + it * kBK;
      __syncthreads();
      load_tile(k_s, kh, kss, kt, kvs, kvl);
      load_tile(v_s, vh, kss, kt, kvs, kvl);
      __syncthreads();
      float s[8][4], dp[8][4];
      scores(s, q_s, warp * 16, k_s, lane);
      scores(dp, do_s, warp * 16, v_s, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = rl[e >> 1];
          const int kpos = kt + nt * 8 + (lane & 3) * 2 + (e & 1);
          if (visible(kpos, qpos_s[row], kvs, kvl, causal))
            dsum[e >> 1] = __fmaf_rn(
                exp2f(s[nt][e] * sl2 - lse_s[row]), dp[nt][e], dsum[e >> 1]);
        }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      dsum[j] += __shfl_xor_sync(0xffffffffu, dsum[j], 1);
      dsum[j] += __shfl_xor_sync(0xffffffffu, dsum[j], 2);
      const int t = q0 + rl[j];
      if ((lane & 3) == 0) {
        delta_s[rl[j]] = dsum[j];
        if (t < T) delta[roff + t] = dsum[j];
      }
    }
    __syncthreads();
  }
  // pass 2: dQ
  for (int it = 0; it < n_tiles; ++it) {
    const int kt = kt0 + it * kBK;
    __syncthreads();          // the previous tile's readers are done
    load_tile(k_s, kh, kss, kt, kvs, kvl);
    load_tile(v_s, vh, kss, kt, kvs, kvl);
    __syncthreads();
    float s[8][4], dp[8][4];
    scores(s, q_s, warp * 16, k_s, lane);     // S = Q K^T
    scores(dp, do_s, warp * 16, v_s, lane);   // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rl[e >> 1];
        const int kpos = kt + nt * 8 + (lane & 3) * 2 + (e & 1);
        const float p =
            visible(kpos, qpos_s[row], kvs, kvl, causal)
                ? exp2f(s[nt][e] * sl2 - lse_s[row])
                : 0.f;
        s[nt][e] = p * (dp[nt][e] - delta_s[row]);   // dS
      }
    acc_product(dq_acc, s, k_s, lane);          // dQ += dS K
  }

#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int t = q0 + rl[row];
    if (t >= T) continue;
    __nv_bfloat16* out = dq + qoff + (size_t)t * qrow;
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      const int d = dn * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(out + d) = hopper::pack_bf16(
          dq_acc[dn][2 * row] * scale, dq_acc[dn][2 * row + 1] * scale);
    }
  }
}

// kernel 2: dK and dV for 64 keys of one (row, kv head), over its G query
// heads
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const int* __restrict__ qpos_arr,
                      const int* __restrict__ kv_len_arr,
                      const int* __restrict__ kv_start_arr,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int T, int Hq,
                      int Hkv, int S, long long ksb, long long kss,
                      long long ksh, float scale, int causal_i) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kTileElems;
  __nv_bfloat16* q_s = v_s + kTileElems;
  __nv_bfloat16* do_s = q_s + kTileElems;
  __shared__ float lse_s[kBQ], delta_s[kBQ];
  __shared__ int qpos_s[kBQ];

  const int hkv = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kBK;
  const bool causal = causal_i != 0;
  const int group = Hq / Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kvs = max(kv_start_arr[b], 0), kvl = min(kv_len_arr[b], S);
  const long long qrow = (long long)Hq * kD;

  load_tile(k_s, k + (size_t)b * ksb + (size_t)hkv * ksh, kss, k0, kvs, kvl);
  load_tile(v_s, v + (size_t)b * ksb + (size_t)hkv * ksh, kss, k0, kvs, kvl);

  const int g = lane >> 2;
  const int kp[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const float sl2 = scale * kLog2e;
  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[i][e] = 0.f;
      dv_acc[i][e] = 0.f;
    }

  const bool live = k0 + kBK > kvs && k0 < kvl;   // block-uniform
  const int n_qt = live ? (T + kBQ - 1) / kBQ : 0;
  for (int h = 0; h < group; ++h) {
    const int hq = hkv * group + h;
    const size_t qoff = ((size_t)b * T * Hq + hq) * kD;
    const size_t roff = ((size_t)b * Hq + hq) * T;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();        // the previous tile's readers are done
      bool sees = false;
      if (threadIdx.x < kBQ) {
        const int t = q0 + threadIdx.x;
        const int p = t < T ? qpos_arr[(size_t)b * T + t] : -kBig;
        qpos_s[threadIdx.x] = p;
        lse_s[threadIdx.x] = t < T ? lse[roff + t] * kLog2e : inf_f();
        delta_s[threadIdx.x] = t < T ? delta[roff + t] : 0.f;
        // a query of the tile can see a key of the block's tile
        sees = t < T && (!causal || p >= k0);
      }
      if (!__syncthreads_or(sees)) continue;
      load_tile(q_s, q + qoff, qrow, q0, 0, T);
      load_tile(do_s, dout + qoff, qrow, q0, 0, T);
      __syncthreads();
      float st[8][4];
      scores(st, k_s, warp * 16, q_s, lane);      // S^T = K Q^T
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = nt * 8 + (lane & 3) * 2 + (e & 1);
          st[nt][e] = visible(kp[e >> 1], qpos_s[qi], kvs, kvl, causal)
                          ? exp2f(st[nt][e] * sl2 - lse_s[qi])
                          : 0.f;                // P^T
        }
      acc_product(dv_acc, st, do_s, lane);        // dV += P^T dO
      float dpt[8][4];
      scores(dpt, v_s, warp * 16, do_s, lane);    // dP^T = V dO^T
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = nt * 8 + (lane & 3) * 2 + (e & 1);
          dpt[nt][e] = st[nt][e] * (dpt[nt][e] - delta_s[qi]);   // dS^T
        }
      acc_product(dk_acc, dpt, q_s, lane);        // dK += dS^T Q
    }
  }

#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int key = kp[row];
    if (key >= S) continue;
    const size_t off = (((size_t)b * S + key) * Hkv + hkv) * kD;
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      const int d = dn * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(dk + off + d) = hopper::pack_bf16(
          dk_acc[dn][2 * row] * scale, dk_acc[dn][2 * row + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + d) =
          hopper::pack_bf16(dv_acc[dn][2 * row], dv_acc[dn][2 * row + 1]);
    }
  }
}

}  // namespace

// q, dout bf16 [B,T,Hq,D] contiguous; k/v bf16 with element strides
// (ksb, kss, ksh) over (B, S, Hkv), multiples of 8, and a contiguous D;
// all 16-byte aligned; qpos int32 [B,T]; kv_len, kv_start int32 [B]; lse
// fp32 [B,Hq,T] (the forward's); delta fp32 [B,Hq,T] scratch (written by
// the first kernel, read by the second); dq bf16 [B,T,Hq,D], dk/dv bf16
// [B,S,Hkv,D] contiguous.  D = 128.  Two launches on `stream`; returns
// the first launch error or cudaGetLastError() (cudaErrorInvalidValue for
// another D).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* qpos,
                                   const void* kv_len, const void* kv_start,
                                   const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int B, int T, int Hq,
                                   int Hkv, int S, int D, long long ksb,
                                   long long kss, long long ksh, float scale,
                                   int causal, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D != kD || Hq % Hkv) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmem);
  if (e != cudaSuccess) return (int)e;
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* dob = static_cast<const __nv_bfloat16*>(dout);
  const auto* qp = static_cast<const int*>(qpos);
  const auto* kl = static_cast<const int*>(kv_len);
  const auto* ks = static_cast<const int*>(kv_start);
  const auto* ls = static_cast<const float*>(lse);
  flash_bwd_dq_kernel<<<dim3(Hq, B, (T + kBQ - 1) / kBQ), kThreads, kSmem,
                        st>>>(
      qb, kb, vb, dob, qp, kl, ks, ls, static_cast<float*>(delta),
      static_cast<__nv_bfloat16*>(dq), T, Hq, Hkv, S, ksb, kss, ksh, scale,
      causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_kernel<<<dim3(Hkv, B, (S + kBK - 1) / kBK), kThreads, kSmem,
                          st>>>(
      qb, kb, vb, dob, qp, kl, ks, ls, static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), T, Hq,
      Hkv, S, ksb, kss, ksh, scale, causal);
  return (int)cudaGetLastError();
}
