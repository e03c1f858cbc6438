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
// ~2 flops per byte read), so the card's memory rate.
//
// Design: the TPU grid walks S in order carrying (m, l, acc) in scratch;
// here the S axis splits over blocks.  A block owns one (row, kv head,
// S-split) and walks only the slots of its split that the row's kv_start,
// window and kv_len leave visible: dead tiles are never read (the TPU
// kernel still DMAs them).  Each of its 4 warps takes 32-key sub-tiles in
// turn: lane t reads key t's row with 16-byte loads and scores it against
// all G queries of the group (q sits in shared memory, read as
// broadcasts), the warp reduces max and sum with shuffles, then each lane
// accumulates 4 head dims of P.V (one 8- or 4-byte load per key, the warp
// reading the V row contiguously).  The 4 warps' states merge in shared
// memory into the split's fp32 partial (m, l, acc); a second kernel merges
// the splits in split order (deterministic, no atomics) and writes bf16.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kD = 128;                  // head dim (the only instance)
constexpr int kDPL = kD / 32;            // head dims per lane in P.V
constexpr float kNegInf = -1e30f;        // the reference's NEG_INF
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

__device__ __forceinline__ float e5m2_to_float(uint32_t c) {
  return __half2float(__ushort_as_half((unsigned short)((c & 0xFF) << 8)));
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float((bits16 & 0xFFFF) << 16);
}

// 8 consecutive elements of a K row as fp32 (bf16: one 16-byte load)
__device__ __forceinline__ void load8(const uint16_t* p, float* out) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = bf16_bits_to_float(w[i]);
    out[2 * i + 1] = bf16_bits_to_float(w[i] >> 16);
  }
}

// e5m2: 8 elements per 8-byte load, widened exactly (an e5m2 code is the
// top byte of an fp16)
__device__ __forceinline__ void load8(const uint8_t* p, float* out) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[i] = e5m2_to_float(r.x >> (8 * i));
    out[4 + i] = e5m2_to_float(r.y >> (8 * i));
  }
}

// 4 consecutive V elements (dims 4*lane .. 4*lane+3)
__device__ __forceinline__ void load4(const uint16_t* p, float* out) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
  out[0] = bf16_bits_to_float(r.x);
  out[1] = bf16_bits_to_float(r.x >> 16);
  out[2] = bf16_bits_to_float(r.y);
  out[3] = bf16_bits_to_float(r.y >> 16);
}

__device__ __forceinline__ void load4(const uint8_t* p, float* out) {
  const uint32_t r = __ldg(reinterpret_cast<const uint32_t*>(p));
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = e5m2_to_float(r >> (8 * i));
}

template <typename KV, int G>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,
                   const KV* __restrict__ k, const KV* __restrict__ v,
                   const int* __restrict__ kv_len_arr,
                   const int* __restrict__ kv_start_arr,
                   const int* __restrict__ won_arr,
                   float* __restrict__ part_acc,   // [B,Hkv,splits,G,D]
                   float* __restrict__ part_ml,    // [B,Hkv,splits,G,2]
                   int Hkv, int S, int split_len, float scale, int window,
                   float softcap) {
  __shared__ float qs[G][kD];
  __shared__ float wm[kWarps][G], wl[kWarps][G];
  __shared__ float wacc[kWarps][G][kD];

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int splits = gridDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int Hq = Hkv * G;

  for (int i = threadIdx.x; i < G * kD; i += kThreads)
    qs[i / kD][i % kD] = __bfloat162float(
        q[((size_t)b * Hq + (size_t)h * G + i / kD) * kD + i % kD]);

  const int kv_len = min(kv_len_arr[b], S);
  int lo = max(kv_start_arr[b], 0);
  if (window > 0 && won_arr[b] != 0) lo = max(lo, kv_len - window);
  lo = max(lo, split * split_len);
  const int hi = min(kv_len, (split + 1) * split_len);
  __syncthreads();

  float m[G], l[G], acc[G][kDPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDPL; ++dd) acc[g][dd] = 0.f;
  }

  const size_t head_off = ((size_t)b * Hkv + h) * (size_t)S * kD;
  const KV* kh = k + head_off;
  const KV* vh = v + head_off;
  // 32-key sub-tiles aligned to 32 slots; warp w takes sub-tiles w, w+4, ..
  const int t0 = lo & ~31;
  for (int base = t0 + warp * 32; base < hi; base += kWarps * 32) {
    const int kpos = base + lane;
    const bool vis = kpos >= lo && kpos < hi;
    const int krow = min(kpos, S - 1);            // never read past S
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g] = 0.f;
#pragma unroll 4
    for (int d0 = 0; d0 < kD; d0 += 8) {
      float kf[8];
      load8(kh + (size_t)krow * kD + d0, kf);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int u = 0; u < 8; ++u) sc[g] = fmaf(qs[g][d0 + u], kf[u], sc[g]);
    }
    float p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = sc[g] * scale;
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      if (!vis) s = kNegInf;
      const float m_new = fmaxf(m[g], warp_max(s));
      const float m_safe = fmaxf(m_new, -1e29f);
      const float pf = expf(s - m_safe);
      const float alpha = expf(fmaxf(m[g], -1e29f) - m_safe);
      l[g] = l[g] * alpha + warp_sum(pf);
#pragma unroll
      for (int dd = 0; dd < kDPL; ++dd) acc[g][dd] *= alpha;
      m[g] = m_new;
      p[g] = __bfloat162float(__float2bfloat16_rn(pf));  // P.V in bf16
    }
    const int n_keys = min(32, hi - base);
    for (int t = 0; t < n_keys; ++t) {
      if (base + t < lo) continue;                // warp-uniform
      float vf[kDPL];
      load4(vh + (size_t)(base + t) * kD + lane * kDPL, vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pt = __shfl_sync(kFull, p[g], t);
#pragma unroll
        for (int dd = 0; dd < kDPL; ++dd)
          acc[g][dd] = fmaf(pt, vf[dd], acc[g][dd]);
      }
    }
  }

  // merge the 4 warps' states
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      wm[warp][g] = m[g];
      wl[warp][g] = l[g];
    }
#pragma unroll
    for (int dd = 0; dd < kDPL; ++dd) wacc[warp][g][lane * kDPL + dd] = acc[g][dd];
  }
  __syncthreads();
  const size_t pidx = ((size_t)b * Hkv + h) * splits + split;
  for (int i = threadIdx.x; i < G * kD; i += kThreads) {
    const int g = i / kD, d = i % kD;
    float mt = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, wm[w][g]);
    const float m_safe = fmaxf(mt, -1e29f);
    float a = 0.f, lt = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(fmaxf(wm[w][g], -1e29f) - m_safe);
      a = fmaf(wacc[w][g][d], f, a);
      lt = fmaf(wl[w][g], f, lt);
    }
    part_acc[(pidx * G + g) * kD + d] = a;
    if (d == 0) {
      part_ml[(pidx * G + g) * 2] = mt;
      part_ml[(pidx * G + g) * 2 + 1] = lt;
    }
  }
}

// One block per (row, q head): merge the splits in split order, write bf16.
__global__ void __launch_bounds__(kD)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml,
                      __nv_bfloat16* __restrict__ out, int Hkv, int G,
                      int splits) {
  const int hq = blockIdx.x;
  const int b = blockIdx.y;
  const int h = hq / G, g = hq % G;
  const int d = threadIdx.x;
  const size_t base = ((size_t)b * Hkv + h) * splits;
  float mt = kNegInf;
  for (int s = 0; s < splits; ++s)
    mt = fmaxf(mt, part_ml[((base + s) * G + g) * 2]);
  const float m_safe = fmaxf(mt, -1e29f);
  float a = 0.f, lt = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t pi = (base + s) * G + g;
    const float f = expf(fmaxf(part_ml[pi * 2], -1e29f) - m_safe);
    a = fmaf(part_acc[pi * kD + d], f, a);
    lt = fmaf(part_ml[pi * 2 + 1], f, lt);
  }
  const float denom = lt == 0.f ? 1.f : lt;
  out[((size_t)b * Hkv * G + hq) * kD + d] = __float2bfloat16_rn(a / denom);
}

template <typename KV>
int launch(int G, dim3 grid, cudaStream_t st, const void* q, const void* k,
           const void* v, const int* kv_len, const int* kv_start,
           const int* won, float* pacc, float* pml, int Hkv, int S,
           int split_len, float scale, int window, float softcap) {
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const KV*>(k);
  const auto* vp = static_cast<const KV*>(v);
#define DECODE_CASE(GG)                                                     \
  case GG:                                                                  \
    decode_attn_kernel<KV, GG><<<grid, kThreads, 0, st>>>(                  \
        qp, kp, vp, kv_len, kv_start, won, pacc, pml, Hkv, S, split_len,    \
        scale, window, softcap);                                            \
    break;
  switch (G) {
    DECODE_CASE(1)
    DECODE_CASE(2)
    DECODE_CASE(4)
    DECODE_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef DECODE_CASE
  return 0;
}

}  // namespace

// q bf16 [B,1,Hq,D]; k/v [B,Hkv,S,D] bf16 (kv_fp8=0) or e5m2 (kv_fp8=1),
// contiguous; kv_len, kv_start, won int32 [B]; out bf16 [B,1,Hq,D];
// part_acc fp32 [B,Hkv,splits,G,D] and part_ml fp32 [B,Hkv,splits,G,2]
// scratch.  D = 128, G = Hq/Hkv in {1,2,4,8}; window <= 0 means none,
// softcap <= 0 none.  Launches the split kernel and the combine kernel;
// returns cudaGetLastError() (cudaErrorInvalidValue for an unsupported
// D or G).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* kv_len, const void* kv_start,
                                const void* won, void* out, void* part_acc,
                                void* part_ml, int B, int Hq, int Hkv, int S,
                                int D, int splits, int split_len, int kv_fp8,
                                float scale, int window, float softcap,
                                void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D != kD || Hq % Hkv) return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  dim3 grid(splits, Hkv, B);
  auto* pacc = static_cast<float*>(part_acc);
  auto* pml = static_cast<float*>(part_ml);
  const auto* kl = static_cast<const int*>(kv_len);
  const auto* ks = static_cast<const int*>(kv_start);
  const auto* wo = static_cast<const int*>(won);
  const int rc = kv_fp8
      ? launch<uint8_t>(G, grid, st, q, k, v, kl, ks, wo, pacc, pml, Hkv, S,
                        split_len, scale, window, softcap)
      : launch<uint16_t>(G, grid, st, q, k, v, kl, ks, wo, pacc, pml, Hkv, S,
                         split_len, scale, window, softcap);
  if (rc != 0) return rc;
  decode_combine_kernel<<<dim3(Hq, B), kD, 0, st>>>(
      pacc, pml, static_cast<__nv_bfloat16*>(out), Hkv, G, splits);
  return (int)cudaGetLastError();
}
