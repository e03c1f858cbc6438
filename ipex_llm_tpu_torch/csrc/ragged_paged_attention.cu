// Ragged paged attention for Hopper: ONE kernel for every row shape of an
// engine tick (decode rows, right-padded prefill chunks, idle rows), reading
// K/V straight off the paged pool through each row's block table.
//
// Replaces the TPU kernel
// ipex_llm_tpu/ops/pallas/ragged_paged_attention.py::ragged_paged_sdpa
// (body _ragged, _kernel).  Semantics kept exactly:
//   - q [R, C, Hq, D] bf16; the query at chunk index c of row r sits at slot
//     kv_len[r] - chunk_len[r] + c; head hq reads kv head hq / (Hq/Hkv);
//   - key slot kpos is visible iff kpos <= qpos && kpos < kv_len[r];
//   - pad queries (c >= chunk_len) compute bounded garbage the caller drops;
//   - chunk_len == 0 (idle row) writes exact zeros and walks no pages; its
//     kv_len may be a sentinel past the table width, so the walk is bounded
//     by min((kv_len-1)/ps, maxP-1), never by kv_len alone;
//   - table entries of -1 clip to page 0 (the engine's scratch page);
//   - a query with no visible key (l == 0) returns 0.
//
// What bounds it: reading the row's K/V pages (decode: ~2 bytes per key
// element per layer for bf16, 1 for e5m2), so the card's memory rate; at
// prefill the score and value products.
//
// Design: a block owns (row, kv head, 16 query rows); each warp keeps four
// query rows' online-softmax state (m, l, acc) in registers, fp32
// throughout, and writes the output once.  The block walks only the row's
// valid pages, 32 keys at a time: the tile is loaded coalesced (16-byte
// vectors) into shared memory and widened there, e5m2 -> fp32 exactly (an
// e5m2 code is the top byte of an fp16), so an fp8 pool streams half the
// bytes.  Lane t scores key t of the tile (conflict-free: K rows are padded
// by one float), then the warp broadcasts each probability to accumulate
// V.  A tile entirely in a query row's future is skipped for that row,
// which is exact: it would change neither m, l nor acc.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kQRows = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kTK = 32;                         // keys per shared tile
constexpr float kNegInf = -1e30f;               // the reference's NEG_INF
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

// bf16 pool: 8 elements per 16-byte vector
template <int D>
__device__ __forceinline__ void load_tile(const uint16_t* __restrict__ kp,
                                          const uint16_t* __restrict__ vp,
                                          float (*ks)[D + 1],
                                          float (*vs)[D]) {
  constexpr int kVec = 8;
  for (int i = threadIdx.x; i < kTK * D / kVec; i += kThreads) {
    const int e = i * kVec;
    const int t = e / D, d = e % D;
    const uint4 kr = __ldg(reinterpret_cast<const uint4*>(kp) + i);
    const uint4 vr = __ldg(reinterpret_cast<const uint4*>(vp) + i);
    const __nv_bfloat16* kb = reinterpret_cast<const __nv_bfloat16*>(&kr);
    const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      ks[t][d + u] = __bfloat162float(kb[u]);
      vs[t][d + u] = __bfloat162float(vb[u]);
    }
  }
}

__device__ __forceinline__ float e5m2_to_float(uint8_t c) {
  return __half2float(__ushort_as_half((unsigned short)(c) << 8));
}

// e5m2 pool: 16 elements per 16-byte vector
template <int D>
__device__ __forceinline__ void load_tile(const uint8_t* __restrict__ kp,
                                          const uint8_t* __restrict__ vp,
                                          float (*ks)[D + 1],
                                          float (*vs)[D]) {
  constexpr int kVec = 16;
  for (int i = threadIdx.x; i < kTK * D / kVec; i += kThreads) {
    const int e = i * kVec;
    const int t = e / D, d = e % D;
    const uint4 kr = __ldg(reinterpret_cast<const uint4*>(kp) + i);
    const uint4 vr = __ldg(reinterpret_cast<const uint4*>(vp) + i);
    const uint8_t* kb = reinterpret_cast<const uint8_t*>(&kr);
    const uint8_t* vb = reinterpret_cast<const uint8_t*>(&vr);
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      ks[t][d + u] = e5m2_to_float(kb[u]);
      vs[t][d + u] = e5m2_to_float(vb[u]);
    }
  }
}

template <typename KV, int D>
__global__ void __launch_bounds__(kThreads)
ragged_attn_kernel(const __nv_bfloat16* __restrict__ q,
                   const KV* __restrict__ kpool,
                   const KV* __restrict__ vpool,
                   const int* __restrict__ tables,
                   const int* __restrict__ kv_len_arr,
                   const int* __restrict__ chunk_arr,
                   __nv_bfloat16* __restrict__ out,
                   int C, int Hq, int Hkv, int ps, int n_pages, int maxp,
                   float scale) {
  constexpr int kDPL = D / 32;              // head dims per lane
  __shared__ float qs[kQRows][D];
  __shared__ float ks[kTK][D + 1];
  __shared__ float vs[kTK][D];

  const int r = blockIdx.z;
  const int h = blockIdx.y;
  const int G = Hq / Hkv;
  const int GC = G * C;
  const int j0 = blockIdx.x * kQRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kv_len = kv_len_arr[r];
  const int chunk = chunk_arr[r];

  // flat query row j -> (g, c): head h*G + g at chunk index c (chunk-minor,
  // the reference's [G*C] flattening)
  auto q_off = [&](int j) -> size_t {
    const int g = j / C, c = j % C;
    return (((size_t)r * C + c) * Hq + (size_t)h * G + g) * D;
  };

  if (chunk <= 0) {                         // idle row: zeros, no page walk
    for (int i = threadIdx.x; i < kQRows * D; i += kThreads) {
      const int j = j0 + i / D;
      if (j < GC) out[q_off(j) + i % D] = __float2bfloat16(0.f);
    }
    return;
  }
  for (int i = threadIdx.x; i < kQRows * D; i += kThreads) {
    const int j = j0 + i / D;
    qs[i / D][i % D] = j < GC ? __bfloat162float(q[q_off(j) + i % D]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPL];
  int qpos[kRowsPerWarp];
  bool live[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int j = j0 + warp * kRowsPerWarp + i;
    live[i] = j < GC;
    qpos[i] = kv_len - chunk + (j % C);
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDPL; ++dd) acc[i][dd] = 0.f;
  }

  const int last_page = kv_len > 0 ? min((kv_len - 1) / ps, maxp - 1) : -1;
  const size_t page_stride = (size_t)Hkv * ps * D;
  for (int pi = 0; pi <= last_page; ++pi) {
    int pid = tables[(size_t)r * maxp + pi];
    pid = min(max(pid, 0), n_pages - 1);
    const KV* kp = kpool + (size_t)pid * page_stride + (size_t)h * ps * D;
    const KV* vp = vpool + (size_t)pid * page_stride + (size_t)h * ps * D;
    for (int sub = 0; sub < ps / kTK; ++sub) {
      const int kpos0 = pi * ps + sub * kTK;
      if (kpos0 >= kv_len) break;           // block-uniform
      __syncthreads();                      // previous tile consumed
      load_tile<D>(kp + (size_t)sub * kTK * D, vp + (size_t)sub * kTK * D,
                   ks, vs);
      __syncthreads();
      const int kpos = kpos0 + lane;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        if (!live[i] || kpos0 > qpos[i]) continue;   // warp-uniform
        const float* qrow = qs[warp * kRowsPerWarp + i];
        float sdot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) sdot = fmaf(qrow[d], ks[lane][d], sdot);
        sdot *= scale;
        if (!(kpos <= qpos[i] && kpos < kv_len)) sdot = kNegInf;
        const float m_new = fmaxf(m[i], warp_max(sdot));
        const float m_safe = fmaxf(m_new, -1e29f);
        const float p = expf(sdot - m_safe);
        const float alpha = expf(fmaxf(m[i], -1e29f) - m_safe);
        l[i] = l[i] * alpha + warp_sum(p);
#pragma unroll
        for (int dd = 0; dd < kDPL; ++dd) acc[i][dd] *= alpha;
#pragma unroll 8
        for (int t = 0; t < kTK; ++t) {
          const float pt = __shfl_sync(kFull, p, t);
#pragma unroll
          for (int dd = 0; dd < kDPL; ++dd)
            acc[i][dd] = fmaf(pt, vs[t][lane + 32 * dd], acc[i][dd]);
        }
        m[i] = m_new;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (!live[i]) continue;
    const int j = j0 + warp * kRowsPerWarp + i;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    const size_t o = q_off(j);
#pragma unroll
    for (int dd = 0; dd < kDPL; ++dd)
      out[o + lane + 32 * dd] = __float2bfloat16(acc[i][dd] * inv);
  }
}

template <typename KV, int D>
void launch(dim3 grid, cudaStream_t st, const void* q, const void* kpool,
            const void* vpool, const void* tables, const void* kv_len,
            const void* chunk_len, void* out, int C, int Hq, int Hkv, int ps,
            int n_pages, int maxp, float scale) {
  ragged_attn_kernel<KV, D><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(kpool),
      static_cast<const KV*>(vpool), static_cast<const int*>(tables),
      static_cast<const int*>(kv_len), static_cast<const int*>(chunk_len),
      static_cast<__nv_bfloat16*>(out), C, Hq, Hkv, ps, n_pages, maxp, scale);
}

}  // namespace

// q bf16 [R,C,Hq,D]; pools [P,Hkv,ps,D] bf16 (kv_fp8=0) or e5m2 (kv_fp8=1);
// tables int32 [R,maxp]; kv_len, chunk_len int32 [R]; out bf16 [R,C,Hq,D].
// D is 128 (the only instance), ps a multiple of 32.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another D.
extern "C" int ragged_paged_attention(const void* q, const void* kpool,
                                      const void* vpool, const void* tables,
                                      const void* kv_len,
                                      const void* chunk_len, void* out,
                                      int R, int C, int Hq, int Hkv, int D,
                                      int ps, int n_pages, int maxp,
                                      int kv_fp8, float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int gc = (Hq / Hkv) * C;
  dim3 grid((gc + kQRows - 1) / kQRows, Hkv, R);
  if (D != 128) return (int)cudaErrorInvalidValue;
  if (kv_fp8)
    launch<uint8_t, 128>(grid, st, q, kpool, vpool, tables, kv_len, chunk_len,
                         out, C, Hq, Hkv, ps, n_pages, maxp, scale);
  else
    launch<uint16_t, 128>(grid, st, q, kpool, vpool, tables, kv_len,
                          chunk_len, out, C, Hq, Hkv, ps, n_pages, maxp, scale);
  return (int)cudaGetLastError();
}
