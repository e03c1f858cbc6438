// Split paged attention for Hopper: decode (C = 1) and uniform chunks of C
// causal queries over the paged KV pool, split along the key axis
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
//   - e5m2 pools widen exactly (e5m2 -> fp16 -> fp32, the same values as the
//     reference's e5m2 -> bf16 -> fp32); scores, m, l and the accumulator
//     are fp32; p is rounded to bf16 before the P.V product, as the
//     reference rounds it (its compute dtype), while l sums the unrounded p.
//   The TPU's padding of the group to 8 rows and of D to 128 lanes is layout,
//   not semantics, and is not carried over.
//
// What bounds it: reading each row's live K/V pages once (decode, and the
// verify chunks of speculative decoding: ~2 bytes per key element per layer
// for bf16, 1 for e5m2), so the card's memory rate; at C = 128 the score and
// value products.
//
// Design (a decomposition of its own, unlike B1's per-row page walk): the
// pass-1 grid is (query tile x key split, kv head, row).  A block owns up to
// 16 query rows of one (row, kv head) -- the GQA group x chunk, chunk-minor
// -- and one split of consecutive pages, so a long row's walk spreads over
// many SMs even at batch 8.  For each 32-key tile it stages K/V (widened to
// fp32) and the tile's scores in shared memory: thread (warp w, lane t)
// scores key t for query rows w, w+4, ...; each warp then runs the online
// softmax of its query rows over the tile (warp max and sum); thread d
// accumulates output dim d of every query row from P and V.  Each block
// writes fp32 partial (m, l, acc) to a workspace; pass 2 merges a query
// row's splits in split order, rescaling by exp(m_s - M), and writes bf16.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 16;                  // query rows per block
constexpr int kKT = 32;                  // keys per shared tile
constexpr int kD = 128;                  // head dim (the only instance)
constexpr float kNegInf = -1e30f;        // the reference's NEG_INF
constexpr float kFloor = -1e29f;         // the reference's m clamp
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float widen(uint16_t b) {   // bf16 bits
  return __bfloat162float(__ushort_as_bfloat16(b));
}

__device__ __forceinline__ float widen(uint8_t c) {    // e5m2 code
  return __half2float(__ushort_as_half((unsigned short)(c) << 8));
}

// stage kKT keys of one page (kp/vp point at the tile's first key) as fp32;
// 16-byte vector loads, neighbouring threads on neighbouring addresses
template <typename KV>
__device__ __forceinline__ void stage_tile(const KV* __restrict__ kp,
                                           const KV* __restrict__ vp,
                                           float (*ks)[kD + 1],
                                           float (*vs)[kD]) {
  constexpr int kVec = 16 / sizeof(KV);
  for (int i = threadIdx.x; i < kKT * kD / kVec; i += kThreads) {
    const int e = i * kVec;
    const int t = e / kD, d = e % kD;
    const uint4 kr = __ldg(reinterpret_cast<const uint4*>(kp) + i);
    const uint4 vr = __ldg(reinterpret_cast<const uint4*>(vp) + i);
    const KV* kb = reinterpret_cast<const KV*>(&kr);
    const KV* vb = reinterpret_cast<const KV*>(&vr);
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      ks[t][d + u] = widen(kb[u]);
      vs[t][d + u] = widen(vb[u]);
    }
  }
}

template <typename KV>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const KV* __restrict__ kpool, const KV* __restrict__ vpool,
                   const int* __restrict__ tables,
                   const int* __restrict__ kv_len_arr,
                   float* __restrict__ ws_acc, float2* __restrict__ ws_ml,
                   int C, int Hq, int Hkv, int ps, int n_pages, int maxp,
                   int n_qtiles, int n_splits, int pps, float scale) {
  __shared__ float qs[kQT][kD];
  __shared__ float ks[kKT][kD + 1];
  __shared__ float vs[kKT][kD];
  __shared__ float sc[kQT][kKT];          // scores, then bf16-rounded p
  __shared__ float m_s[kQT], l_s[kQT], al_s[kQT];

  const int qt = blockIdx.x % n_qtiles;
  const int split = blockIdx.x / n_qtiles;
  const int h = blockIdx.y;
  const int r = blockIdx.z;
  const int G = Hq / Hkv;
  const int GC = G * C;
  const int j0 = qt * kQT;
  const int nq = min(kQT, GC - j0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kv_len = kv_len_arr[r];

  // query row j (flat over the group x chunk, chunk-minor) -> q offset
  auto q_off = [&](int j) -> size_t {
    const int g = j / C, c = j % C;
    return (((size_t)r * C + c) * Hq + (size_t)h * G + g) * kD;
  };
  // the tile's latest query slot bounds its causal key range: the largest
  // chunk index among rows j0..j0+nq-1 (C - 1 once the rows wrap a chunk)
  const int c_hi = (j0 % C) + nq > C ? C - 1 : (j0 + nq - 1) % C;
  const int qpos_hi = kv_len - C + c_hi;
  const int live_pages = kv_len > 0 ? min((kv_len + ps - 1) / ps, maxp) : 0;
  const int p_lo = split * pps;
  const int p_hi = min(p_lo + pps, live_pages);
  const size_t ws_row =
      (((size_t)r * Hkv + h) * n_splits + split) * (size_t)GC;

  for (int i = threadIdx.x; i < kQT; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  for (int i = threadIdx.x; i < kQT * kD; i += kThreads) {
    const int j = i / kD;
    qs[j][i % kD] = j < nq ? __bfloat162float(q[q_off(j0 + j) + i % kD]) : 0.f;
  }
  float acc[kQT];
#pragma unroll
  for (int i = 0; i < kQT; ++i) acc[i] = 0.f;

  const size_t page_stride = (size_t)Hkv * ps * kD;
  for (int pi = p_lo; pi < p_hi; ++pi) {
    int pid = tables[(size_t)r * maxp + pi];
    pid = min(max(pid, 0), n_pages - 1);
    const KV* kp = kpool + (size_t)pid * page_stride + (size_t)h * ps * kD;
    const KV* vp = vpool + (size_t)pid * page_stride + (size_t)h * ps * kD;
    for (int sub = 0; sub < ps / kKT; ++sub) {
      const int kpos0 = pi * ps + sub * kKT;
      // block-uniform: a tile past the rows' last visible slot changes no
      // query row's m, l or acc
      if (kpos0 >= kv_len || kpos0 > qpos_hi) break;
      __syncthreads();                        // previous tile consumed
      stage_tile<KV>(kp + (size_t)sub * kKT * kD, vp + (size_t)sub * kKT * kD,
                     ks, vs);
      __syncthreads();
      // scores: thread (warp, lane) scores key `lane` for rows warp + 4i
      const int kpos = kpos0 + lane;
      for (int j = warp; j < nq; j += kWarps) {
        const int qpos = kv_len - C + (j0 + j) % C;
        float s = 0.f;
#pragma unroll 16
        for (int d = 0; d < kD; ++d) s = fmaf(qs[j][d], ks[lane][d], s);
        sc[j][lane] = (kpos <= qpos && kpos < kv_len) ? s * scale : kNegInf;
      }
      // online softmax of each of this warp's rows over the tile (lane t
      // reads back the score it wrote)
      for (int j = warp; j < nq; j += kWarps) {
        const float s = sc[j][lane];
        const float m_prev = m_s[j];
        const float m_new = fmaxf(m_prev, warp_max(s));
        const float m_safe = fmaxf(m_new, kFloor);
        const float p = expf(s - m_safe);
        const float alpha = expf(fmaxf(m_prev, kFloor) - m_safe);
        const float psum = warp_sum(p);
        sc[j][lane] = __bfloat162float(__float2bfloat16(p));
        if (lane == 0) {
          l_s[j] = l_s[j] * alpha + psum;
          m_s[j] = m_new;
          al_s[j] = alpha;
        }
      }
      __syncthreads();
      // P.V: thread d owns output dim d of every query row
      const int d = threadIdx.x;
#pragma unroll
      for (int j = 0; j < kQT; ++j) {
        if (j < nq) {
          float a = acc[j] * al_s[j];
#pragma unroll 8
          for (int t = 0; t < kKT; ++t) a = fmaf(sc[j][t], vs[t][d], a);
          acc[j] = a;
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kQT; ++j)
    if (j < nq) ws_acc[(ws_row + j0 + j) * kD + threadIdx.x] = acc[j];
  if (threadIdx.x < nq)
    ws_ml[ws_row + j0 + threadIdx.x] =
        make_float2(m_s[threadIdx.x], l_s[threadIdx.x]);
}

// one block per (query row, kv head, row): thread d merges output dim d of
// the row's splits in split order; a split that saw no visible key (l == 0)
// contributes nothing
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const float* __restrict__ ws_acc,
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
    o = fmaf(ws_acc[(base + (size_t)s * GC) * kD + threadIdx.x], w, o);
  }
  const int g = j / C, c = j % C;
  const size_t off = (((size_t)r * C + c) * Hq + (size_t)h * G + g) * kD;
  out[off + threadIdx.x] = __float2bfloat16(o / (l == 0.f ? 1.f : l));
}

}  // namespace

// q bf16 [R,C,Hq,D]; pools [P,Hkv,ps,D] bf16 (kv_fp8=0) or e5m2 (kv_fp8=1);
// tables int32 [R,maxp]; kv_len int32 [R]; ws_acc fp32 [R,Hkv,n_splits,GC,D]
// and ws_ml fp32 [R,Hkv,n_splits,GC,2] (GC = Hq/Hkv*C) are scratch the
// caller allocates; out bf16 [R,C,Hq,D].  D is 128, ps a multiple of 32.
// Launches pass 1 then pass 2 on `stream`; returns the first non-zero
// cudaGetLastError() of the two, or cudaErrorInvalidValue for another D.
extern "C" int paged_attention(const void* q, const void* kpool,
                               const void* vpool, const void* tables,
                               const void* kv_len, void* ws_acc, void* ws_ml,
                               void* out, int R, int C, int Hq, int Hkv,
                               int D, int ps, int n_pages, int maxp,
                               int n_splits, int pps, int kv_fp8, float scale,
                               void* stream) {
  if (D != kD || ps % kKT) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int gc = (Hq / Hkv) * C;
  const int n_qtiles = (gc + kQT - 1) / kQT;
  dim3 grid1(n_qtiles * n_splits, Hkv, R);
  float* acc = static_cast<float*>(ws_acc);
  float2* ml = static_cast<float2*>(ws_ml);
  if (kv_fp8)
    paged_split_kernel<uint8_t><<<grid1, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const uint8_t*>(kpool), static_cast<const uint8_t*>(vpool),
        static_cast<const int*>(tables), static_cast<const int*>(kv_len), acc,
        ml, C, Hq, Hkv, ps, n_pages, maxp, n_qtiles, n_splits, pps, scale);
  else
    paged_split_kernel<uint16_t><<<grid1, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const uint16_t*>(kpool),
        static_cast<const uint16_t*>(vpool), static_cast<const int*>(tables),
        static_cast<const int*>(kv_len), acc, ml, C, Hq, Hkv, ps, n_pages,
        maxp, n_qtiles, n_splits, pps, scale);
  int err = (int)cudaGetLastError();
  if (err) return err;
  dim3 grid2(gc, Hkv, R);
  paged_merge_kernel<<<grid2, kThreads, 0, st>>>(
      acc, ml, static_cast<__nv_bfloat16*>(out), C, Hq, Hkv, n_splits);
  return (int)cudaGetLastError();
}
