// Flash attention for Hopper: tiled online-softmax SDPA for prefill.
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
// What bounds it: the score and value products, 4 * D flops per visible
// (query, key) pair, against the bf16 tensor-core rate; this first
// version runs them on the CUDA cores (FMAs in fp32, no mma/wgmma yet).
//
// Design: a block owns (row, q head, 64-query tile) and walks 64-key tiles
// only from the first slot any of its queries can see (kv_start, or with
// the window on qpos_min - window + 1) to the last (kv_len, or qpos_max
// with causal masking): tiles that are wholly masked, such as the pad
// slots of a left-padded bucket or the far past of a sliding window, are
// never read.  Q (bf16, transposed), K (fp32, transposed), V (fp32) and P
// live in shared memory; each of the 128 threads owns a 4-query x 8-key
// block of the score tile and a 4-query x 16-dim block of the output, so
// every product reads its operands as 16-byte shared-memory vectors.  The
// 8 threads that share 4 query rows reduce their max and sum with
// shuffles.  Keys outside [kv_start, kv_len) load as zeros, so no
// uninitialised slot can reach the sums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kD = 128;                  // head dim (the only instance)
constexpr int kBQ = 64;                  // queries per block
constexpr int kBK = 64;                  // keys per tile
constexpr int kPPad = kBK + 4;           // P row stride (floats)
constexpr float kNegInf = -1e30f;        // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

constexpr size_t kSmemQ = sizeof(uint16_t) * kD * kBQ;   // Qs[d][q] bf16
constexpr size_t kSmemK = sizeof(float) * kD * kBK;      // Ks[d][key]
constexpr size_t kSmemV = sizeof(float) * kBK * kD;      // Vs[key][d]
constexpr size_t kSmemP = sizeof(float) * kBQ * kPPad;   // Ps[q][key]
constexpr size_t kSmem = kSmemQ + kSmemK + kSmemV + kSmemP;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float((bits16 & 0xFFFF) << 16);
}

__device__ __forceinline__ float group_max(float v) {   // over 8 lanes
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// column j (0..7) of thread c's score block: keys 4c..4c+3, 32+4c..32+4c+3
// (neighbouring lanes read neighbouring 16-byte vectors: no bank conflict)
__device__ __forceinline__ int col_of(int c, int j) {
  return (j < 4 ? 4 * c : 32 + 4 * c) + (j & 3);
}

__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ qpos_arr,   // [B, T]
                  const int* __restrict__ kv_len_arr,
                  const int* __restrict__ kv_start_arr,
                  const int* __restrict__ won_arr,
                  __nv_bfloat16* __restrict__ out,
                  int T, int Hq, int Hkv, int S, long long ksb, long long kss,
                  long long ksh, float scale, int causal, int window,
                  float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem);
  float* Ks = reinterpret_cast<float*>(smem + kSmemQ);
  float* Vs = reinterpret_cast<float*>(smem + kSmemQ + kSmemK);
  float* Ps = reinterpret_cast<float*>(smem + kSmemQ + kSmemK + kSmemV);
  __shared__ int qmin_s, qmax_s;

  const int q0 = blockIdx.x * kBQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = hq / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int r = tid >> 3;                  // query rows 4r .. 4r+3
  const int c = tid & 7;                   // score cols / output dims
  const int kvs = max(kv_start_arr[b], 0);
  const int kvl = min(kv_len_arr[b], S);
  const bool win = causal && window > 0 && won_arr[b] != 0;

  // Q tile, transposed to Qs[d][q]: lanes take consecutive queries
  for (int i = tid; i < kBQ * (kD / 8); i += kThreads) {
    const int qi = i % kBQ, d0 = (i / kBQ) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q0 + qi < T)
      raw = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * T + q0 + qi) * Hq + hq) * kD + d0);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      Qs[(d0 + 2 * u) * kBQ + qi] = (uint16_t)(w[u] & 0xFFFF);
      Qs[(d0 + 2 * u + 1) * kBQ + qi] = (uint16_t)(w[u] >> 16);
    }
  }
  int qp[4];
  bool qlive[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * r + i;
    qlive[i] = t < T;
    qp[i] = qlive[i] ? qpos_arr[(size_t)b * T + t] : 0;
  }
  if (tid < 32) {                          // the block's query slot range
    int mn = 0x7fffffff, mx = -0x7fffffff;
    for (int t = q0 + tid; t < min(q0 + kBQ, T); t += 32) {
      const int p = qpos_arr[(size_t)b * T + t];
      mn = min(mn, p);
      mx = max(mx, p);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn = min(mn, __shfl_xor_sync(kFull, mn, o));
      mx = max(mx, __shfl_xor_sync(kFull, mx, o));
    }
    if (tid == 0) {
      qmin_s = mn;
      qmax_s = mx;
    }
  }
  __syncthreads();
  int lo = kvs, hi = kvl;
  if (causal) hi = min(hi, qmax_s + 1);
  if (win) lo = max(lo, qmin_s - window + 1);

  float m[4], l[4], acc[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[i][e] = 0.f;
  }

  const __nv_bfloat16* kh = k + (size_t)b * ksb + (size_t)hkv * ksh;
  const __nv_bfloat16* vh = v + (size_t)b * ksb + (size_t)hkv * ksh;
  for (int kt = (max(lo, 0) / kBK) * kBK; kt < hi; kt += kBK) {
    __syncthreads();                       // previous tile consumed
    for (int i = tid; i < kBK * (kD / 8); i += kThreads) {
      // K transposed (lanes take consecutive keys), V as stored
      const int key = i % kBK, d0 = (i / kBK) * 8;
      const int kpos = kt + key;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (kpos >= kvs && kpos < kvl)
        raw = *reinterpret_cast<const uint4*>(kh + (size_t)kpos * kss + d0);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        Ks[(d0 + 2 * u) * kBK + key] = bf16_bits_to_float(w[u]);
        Ks[(d0 + 2 * u + 1) * kBK + key] = bf16_bits_to_float(w[u] >> 16);
      }
      const int vkey = i / (kD / 8), vd0 = (i % (kD / 8)) * 8;
      const int vpos = kt + vkey;
      uint4 vraw = make_uint4(0, 0, 0, 0);
      if (vpos >= kvs && vpos < kvl)
        vraw = *reinterpret_cast<const uint4*>(vh + (size_t)vpos * kss + vd0);
      const uint32_t vw[4] = {vraw.x, vraw.y, vraw.z, vraw.w};
      float4* vdst = reinterpret_cast<float4*>(Vs + vkey * kD + vd0);
      vdst[0] = make_float4(bf16_bits_to_float(vw[0]),
                            bf16_bits_to_float(vw[0] >> 16),
                            bf16_bits_to_float(vw[1]),
                            bf16_bits_to_float(vw[1] >> 16));
      vdst[1] = make_float4(bf16_bits_to_float(vw[2]),
                            bf16_bits_to_float(vw[2] >> 16),
                            bf16_bits_to_float(vw[3]),
                            bf16_bits_to_float(vw[3] >> 16));
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      const uint2 qr = *reinterpret_cast<const uint2*>(Qs + d * kBQ + 4 * r);
      const float qf[4] = {bf16_bits_to_float(qr.x),
                           bf16_bits_to_float(qr.x >> 16),
                           bf16_bits_to_float(qr.y),
                           bf16_bits_to_float(qr.y >> 16)};
      const float4 k0 = *reinterpret_cast<const float4*>(Ks + d * kBK + 4 * c);
      const float4 k1 =
          *reinterpret_cast<const float4*>(Ks + d * kBK + 32 + 4 * c);
      const float kf[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qf[i], kf[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = kt + col_of(c, j);
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool vis = qlive[i] && kpos >= kvs && kpos < kvl;
        if (causal) {
          vis = vis && kpos <= qp[i];
          if (win) vis = vis && kpos > qp[i] - window;
        }
        s[i][j] = vis ? x : kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(tmax));
      const float m_safe = fmaxf(m_new, -1e29f);
      const float alpha = expf(fmaxf(m[i], -1e29f) - m_safe);
      float psum = 0.f;
      float p[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pf = expf(s[i][j] - m_safe);
        psum += pf;
        p[j] = __bfloat162float(__float2bfloat16_rn(pf));   // P.V in bf16
      }
      l[i] = l[i] * alpha + group_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[i][e] *= alpha;
      float* prow = Ps + (4 * r + i) * kPPad;
      *reinterpret_cast<float4*>(prow + 4 * c) =
          make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(prow + 32 + 4 * c) =
          make_float4(p[4], p[5], p[6], p[7]);
    }
    __syncthreads();

    const int n_keys = min(kBK, hi - kt);
#pragma unroll 1
    for (int kk = 0; kk < n_keys; kk += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t4 =
            *reinterpret_cast<const float4*>(Ps + (4 * r + i) * kPPad + kk);
        pr[i][0] = t4.x; pr[i][1] = t4.y; pr[i][2] = t4.z; pr[i][3] = t4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = Vs + (kk + u) * kD + 4 * c;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 32 * jj);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * jj + 0] = fmaf(pr[i][u], vv.x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(pr[i][u], vv.y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(pr[i][u], vv.z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(pr[i][u], vv.w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }

  // output dims of thread c: 32*jj + 4c .. 32*jj + 4c + 3
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!qlive[i]) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    __nv_bfloat16* orow =
        out + (((size_t)b * T + q0 + 4 * r + i) * Hq + hq) * kD + 4 * c;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      __nv_bfloat162 lo2 = __floats2bfloat162_rn(acc[i][4 * jj] * inv,
                                                 acc[i][4 * jj + 1] * inv);
      __nv_bfloat162 hi2 = __floats2bfloat162_rn(acc[i][4 * jj + 2] * inv,
                                                 acc[i][4 * jj + 3] * inv);
      uint2 w;
      w.x = *reinterpret_cast<uint32_t*>(&lo2);
      w.y = *reinterpret_cast<uint32_t*>(&hi2);
      *reinterpret_cast<uint2*>(orow + 32 * jj) = w;
    }
  }
}

}  // namespace

// q bf16 [B,T,Hq,D] contiguous; k/v bf16 with element strides (ksb, kss,
// ksh) over (B, S, Hkv) and a contiguous D (the same strides for both);
// qpos int32 [B,T]; kv_len, kv_start, won int32 [B]; out bf16 [B,T,Hq,D].
// D = 128; window <= 0 means none, softcap <= 0 none.  Returns
// cudaGetLastError() (cudaErrorInvalidValue for another D).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* qpos, const void* kv_len,
                               const void* kv_start, const void* won,
                               void* out, int B, int T, int Hq, int Hkv,
                               int S, int D, long long ksb, long long kss,
                               long long ksh, float scale, int causal,
                               int window, float softcap, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D != kD || Hq % Hkv) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + kBQ - 1) / kBQ, Hq, B);
  flash_attn_kernel<<<grid, kThreads, kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kv_len), static_cast<const int*>(kv_start),
      static_cast<const int*>(won), static_cast<__nv_bfloat16*>(out), T, Hq,
      Hkv, S, ksb, kss, ksh, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}
