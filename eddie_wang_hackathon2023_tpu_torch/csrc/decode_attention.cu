// Single-token decode attention over the stacked seq-minor KV cache, and
// the int8 weight-only out-projection GEMV that follows it.
//
// Replaces the TPU kernel eddie_wang_hackathon2023_tpu/ops/
// pallas_decode_attention.py:45 `_kernel` (entry `fused_decode_attention`,
// :767), in the modes the Whisper decode path uses: bf16 or int8 cache,
// per-tensor dequant scale, fresh K/V of the current token, start-index
// mask, and the int8 out-projection epilogue (:62-95).
//
// Bound: bytes.  One query row per (batch, head) reads the valid columns of
// one layer's K and V; the arithmetic is 4*D flops per column.  The design
// therefore streams K/V once, straight from device memory, in their stored
// dtype (int8 is never expanded into a float copy; the scale multiplies the
// scores and the context instead):
//   * one 256-thread block per (head, batch row); the cache is walked in
//     chunks of 1024 columns, four consecutive columns per thread for the
//     scores (one 4- or 8-byte load per row, unrolled so that many loads
//     are in flight), with the softmax kept online in fp32 across chunks
//     (running max and sum);
//   * chunks past the valid length are neither read nor computed, and no
//     column at or past S is read, so padding never reaches the sums;
//   * for P*V each warp owns D/8 rows of V and its lanes read four
//     consecutive columns each (coalesced along the seq-minor axis); the
//     probabilities enter it rounded to bf16, the sum of the softmax
//     denominator and the fresh column stay fp32, as in the TPU kernel.
// Beam search (the TPU kernel's `_beam_kernel`, :213, entry `_beam_call`
// :320) is the same kernel instantiated with kBeam: query row b of group
// g = b / bw reads each cache position s from row g*bw + ind[b][s] of its
// group (ind is the [groups, bw, S] cache-indirection table), so the cache
// is never reordered.  Row g*bw speaks for the group's length and start;
// the fresh K/V is the row's own.  The block layout is kernel 1's (one block
// per (head, query row)); the TPU kernel instead reads each source row of a
// group once for all bw query beams.  Here the bw blocks of a group read the
// same rows, and all but the first read can hit L2 (a layer's self cache at
// the Whisper beam path's shapes is a few MB), so the bound counts the
// group-once bytes.  Each column's source row may differ from its
// neighbour's, so the loads are per column (2 or 1 bytes) instead of one
// 4-column vector; the P*V pass reads the chunk's source rows from shared
// memory.
//
// The TPU kernel ran its epilogue GEMV inside the same kernel from a VMEM
// panel.  A single block cannot read the 1.6 MB panel fast, so here it is a
// second kernel spread over N: out[b, n] = (sum_k ctx[b, k] W[l, k, n]) *
// scale[n] + bias[n], with the context cast to bf16 first and fp32
// accumulation, as weight_only_quant_matmul does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4 * kThreads;   // columns per chunk, 4 per thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reduction; every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();                     // red may still be read
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// Four consecutive cache columns as floats (one 4- or 8-byte load).
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  return make_float4(v.x, v.y, v.z, v.w);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}

// One element of a cache row as a float.
__device__ __forceinline__ float load1(const int8_t* p) { return (float)*p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Four cache columns col..col+3 of row d (d_off = d*S elements past the
// head's base): in beam mode each from its own cache row, src.x..src.w rows
// past the base row; otherwise all from the base row, as one vector load.
template <bool kBeam, typename CT>
__device__ __forceinline__ float4 load_cols(const CT* base, size_t d_off,
                                            int col, int4 src,
                                            size_t row_stride) {
  if constexpr (kBeam) {
    const CT* p = base + d_off + col;
    return make_float4(load1(p + src.x * row_stride),
                       load1(p + 1 + src.y * row_stride),
                       load1(p + 2 + src.z * row_stride),
                       load1(p + 3 + src.w * row_stride));
  } else {
    return load4(base + d_off + col);
  }
}

template <typename CT, bool kBeam>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,   // [B,H,D]
                        const CT* __restrict__ cache,  // [L,Bkv,2,H,D,S]
                        int layer, int Bkv, int H, int D, int S,
                        const int* __restrict__ seq_len,       // [B]
                        const int* __restrict__ start,         // [B] or null
                        const float* __restrict__ kscale_ptr, float scale,
                        const CT* __restrict__ fresh_k,        // [B,H,D]
                        const CT* __restrict__ fresh_v,
                        const int* __restrict__ ind,   // kBeam: [B,S]
                        int bw,                        // kBeam: beam width
                        __nv_bfloat16* __restrict__ out) {     // [B,H*D]
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ float q_s[kMaxD];
  __shared__ float acc_s[kMaxD];
  __shared__ __align__(16) float p_s[kChunk];
  __shared__ float red[kWarps];
  // kBeam: each column's source row (its beam in the group), for the P*V
  // pass of the chunk
  __shared__ __align__(16) int src_s[kBeam ? kChunk : 4];

  // the row whose cache holds position s (without beams: b itself), and
  // the row that speaks for the lengths (the group's first in beam mode)
  const int row0 = kBeam ? b - b % bw : b;
  const float kscale = kscale_ptr ? *kscale_ptr : 1.0f;
  const int total = seq_len[row0];
  const bool with_fresh = fresh_k != nullptr;
  const int cache_len = min(total - (with_fresh ? 1 : 0), S);
  const int lo = start ? start[row0] : 0;
  const size_t row_stride = (size_t)2 * H * D * S;   // elements per row

  // q pre-multiplied by scale*kscale: scores come out ready for softmax
  for (int d = tid; d < D; d += kThreads) {
    q_s[d] = to_f(q[((size_t)b * H + h) * D + d]) * (scale * kscale);
    acc_s[d] = 0.f;
  }
  __syncthreads();

  const size_t head = (size_t)D * S;
  const CT* kp =
      cache + ((((size_t)layer * Bkv + row0) * 2 + 0) * H + h) * head;
  const CT* vp =
      cache + ((((size_t)layer * Bkv + row0) * 2 + 1) * H + h) * head;
  const int* ind_b = kBeam ? ind + (size_t)b * S : nullptr;

  float m_run = kNeg, l_run = 0.f;
  const int n_chunks = (cache_len + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * kChunk;
    // scores: four consecutive columns per thread (S % 4 == 0, so a group
    // that starts below cache_len <= S lies inside the row)
    const int col = c0 + 4 * tid;
    float s[4] = {kNeg, kNeg, kNeg, kNeg};
    int4 src = make_int4(0, 0, 0, 0);
    if constexpr (kBeam) {
      if (col < cache_len) {
        // columns at or past cache_len (<= S) keep beam 0: read, never used
        src.x = ind_b[col];
        if (col + 1 < cache_len) src.y = ind_b[col + 1];
        if (col + 2 < cache_len) src.z = ind_b[col + 2];
        if (col + 3 < cache_len) src.w = ind_b[col + 3];
        *reinterpret_cast<int4*>(src_s + 4 * tid) = src;
      }
    }
    if (col < cache_len) {
      float4 dot = make_float4(0.f, 0.f, 0.f, 0.f);
      // unrolled so that many of the D independent row loads are in flight
      // at once (one at a time, each would wait a full memory latency)
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        const float4 kv =
            load_cols<kBeam>(kp, (size_t)d * S, col, src, row_stride);
        const float qd = q_s[d];
        dot.x += qd * kv.x;
        dot.y += qd * kv.y;
        dot.z += qd * kv.z;
        dot.w += qd * kv.w;
      }
      const float dv[4] = {dot.x, dot.y, dot.z, dot.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (col + i < cache_len && col + i >= lo) s[i] = dv[i];
    }
    const float m_loc = fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3]));
    const float m_new = fmaxf(m_run, block_reduce<true>(m_loc, red));
    // a masked column contributes nothing, even when the whole chunk is
    // masked (exp(kNeg - kNeg) would be 1).  The sum takes p in fp32; P*V
    // takes p rounded to bf16, as the TPU kernel casts it to the
    // activation dtype before that product (pallas_decode_attention.py:149)
    float p_loc = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = s[i] > 0.5f * kNeg ? __expf(s[i] - m_new) : 0.f;
      p_s[4 * tid + i] = __bfloat162float(__float2bfloat16(p));
      p_loc += p;
    }
    const float alpha = __expf(m_run - m_new);
    l_run = l_run * alpha + block_reduce<false>(p_loc, red);  // syncs p_s
    const int c_hi = min(kChunk, cache_len - c0);
    // P*V: each warp owns rows d; lanes read four consecutive columns
    for (int d = warp; d < D; d += kWarps) {
      float part = 0.f;
#pragma unroll 8
      for (int j = 4 * lane; j < c_hi; j += 128) {
        int4 src_j = make_int4(0, 0, 0, 0);
        if constexpr (kBeam) src_j = *reinterpret_cast<const int4*>(src_s + j);
        const float4 v =
            load_cols<kBeam>(vp, (size_t)d * S, c0 + j, src_j, row_stride);
        const float4 p = *reinterpret_cast<const float4*>(p_s + j);
        // masked columns have p == 0; the select keeps a non-finite value
        // in a padding column out of the sum (0 * inf would be NaN)
        part += (p.x != 0.f ? p.x * v.x : 0.f) + (p.y != 0.f ? p.y * v.y : 0.f)
              + (p.z != 0.f ? p.z * v.z : 0.f) + (p.w != 0.f ? p.w * v.w : 0.f);
      }
      part = warp_sum(part);
      if (lane == 0) acc_s[d] = acc_s[d] * alpha + part;
    }
    m_run = m_new;
    __syncthreads();                   // p_s is rewritten by the next chunk
  }

  // the current token's column, from the fresh operand
  float alpha = 1.f, p_f = 0.f;
  if (with_fresh) {
    float part = 0.f;
    const size_t f0 = ((size_t)b * H + h) * D;
    for (int d = lane; d < D; d += 32) part += q_s[d] * to_f(fresh_k[f0 + d]);
    const float s_f = warp_sum(part);  // every warp computes the same value
    const float m_fin = fmaxf(m_run, s_f);
    alpha = __expf(m_run - m_fin);
    p_f = __expf(s_f - m_fin);
    l_run = l_run * alpha + p_f;
  }
  const float inv = l_run > 0.f ? kscale / l_run : 0.f;
  for (int d = tid; d < D; d += kThreads) {
    float ctx = acc_s[d] * alpha;
    if (with_fresh)
      ctx += p_f * to_f(fresh_v[((size_t)b * H + h) * D + d]);
    out[(size_t)b * H * D + (size_t)h * D + d] = __float2bfloat16(ctx * inv);
  }
}

// out[b, n] = bf16((sum_k x[b, k] * W[layer, k, n]) * scale[n] + bias[n])
// Block (8, 32): tx covers 4 columns each (one char4), ty strides K.
constexpr int kGemvCols = 32;
constexpr int kGemvRows = 32;
constexpr int kGemvBatch = 10;

__global__ void __launch_bounds__(256)
out_proj_gemv_kernel(const __nv_bfloat16* __restrict__ x,   // [B,K]
                     const int8_t* __restrict__ w,          // [L,K,N]
                     int layer, const float* __restrict__ scale,  // [N]
                     const __nv_bfloat16* __restrict__ bias,      // [N]
                     __nv_bfloat16* __restrict__ out,             // [B,N]
                     int K, int N) {
  extern __shared__ float x_s[];                               // [K]
  __shared__ float red[kGemvRows][kGemvCols + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * blockDim.x + tx;
  const int b = blockIdx.y;
  const int n = blockIdx.x * kGemvCols + tx * 4;
  for (int k = tid; k < K; k += blockDim.x * blockDim.y)
    x_s[k] = __bfloat162float(x[(size_t)b * K + k]);
  __syncthreads();
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (n < N) {
    const int8_t* wp = w + (size_t)layer * K * N + n;
    // kGemvBatch rows are loaded before they are used (loads in flight)
    for (int k0 = ty; k0 < K; k0 += kGemvRows * kGemvBatch) {
      char4 v[kGemvBatch];
#pragma unroll
      for (int i = 0; i < kGemvBatch; ++i) {
        const int k = k0 + i * kGemvRows;
        v[i] = k < K ? *reinterpret_cast<const char4*>(wp + (size_t)k * N)
                     : make_char4(0, 0, 0, 0);
      }
#pragma unroll
      for (int i = 0; i < kGemvBatch; ++i) {
        const int k = k0 + i * kGemvRows;
        const float xv = k < K ? x_s[k] : 0.f;
        acc[0] += xv * (float)v[i].x;
        acc[1] += xv * (float)v[i].y;
        acc[2] += xv * (float)v[i].z;
        acc[3] += xv * (float)v[i].w;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty][tx * 4 + j] = acc[j];
  __syncthreads();
  if (tid < kGemvCols) {
    const int col = blockIdx.x * kGemvCols + tid;
    if (col < N) {
      float s = 0.f;
#pragma unroll 8
      for (int r = 0; r < kGemvRows; ++r) s += red[r][tid];
      s *= scale[col];
      if (bias) s += __bfloat162float(bias[col]);
      out[(size_t)b * N + col] = __float2bfloat16(s);
    }
  }
}

template <bool kBeam>
int launch_decode_attention(const void* q, const void* cache,
                            int cache_is_int8, int layer, int B, int Bkv,
                            int H, int D, int S, const int* seq_len,
                            const int* start, const float* kscale,
                            float scale, const void* fresh_k,
                            const void* fresh_v, const int* ind, int bw,
                            void* out, void* stream) {
  if (D > kMaxD || S % 4) return (int)cudaErrorInvalidValue;
  dim3 grid(H, B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (cache_is_int8) {
    decode_attention_kernel<int8_t, kBeam><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const int8_t*>(cache), layer, Bkv, H, D, S, seq_len,
        start, kscale, scale,
        static_cast<const int8_t*>(fresh_k),
        static_cast<const int8_t*>(fresh_v), ind, bw,
        static_cast<__nv_bfloat16*>(out));
  } else {
    decode_attention_kernel<__nv_bfloat16, kBeam><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(cache), layer, Bkv, H, D, S,
        seq_len, start, kscale, scale,
        static_cast<const __nv_bfloat16*>(fresh_k),
        static_cast<const __nv_bfloat16*>(fresh_v), ind, bw,
        static_cast<__nv_bfloat16*>(out));
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int decode_attention(const void* q, const void* cache, int cache_is_int8,
                     int layer, int B, int Bkv, int H, int D, int S,
                     const int* seq_len, const int* start,
                     const float* kscale, float scale, const void* fresh_k,
                     const void* fresh_v, void* out, void* stream) {
  return launch_decode_attention<false>(
      q, cache, cache_is_int8, layer, B, Bkv, H, D, S, seq_len, start,
      kscale, scale, fresh_k, fresh_v, nullptr, 1, out, stream);
}

// Beam search: B = groups * bw query rows over B cache rows; ind [B, S]
// int32 (the [groups, bw, S] table) holds beams in [0, bw).  The fresh K/V
// is required.
int beam_decode_attention(const void* q, const void* cache,
                          int cache_is_int8, int layer, int B, int H, int D,
                          int S, const int* seq_len, const int* start,
                          const float* kscale, float scale,
                          const void* fresh_k, const void* fresh_v,
                          const int* ind, int bw, void* out, void* stream) {
  if (bw < 1 || B % bw || !fresh_k || !fresh_v || !ind)
    return (int)cudaErrorInvalidValue;
  return launch_decode_attention<true>(
      q, cache, cache_is_int8, layer, B, B, H, D, S, seq_len, start, kscale,
      scale, fresh_k, fresh_v, ind, bw, out, stream);
}

int out_proj_gemv(const void* x, const void* w, int layer,
                  const float* scale, const void* bias, void* out, int B,
                  int K, int N, void* stream) {
  dim3 block(kGemvCols / 4, kGemvRows);
  dim3 grid((N + kGemvCols - 1) / kGemvCols, B);
  const size_t smem = (size_t)K * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  out_proj_gemv_kernel<<<grid, block, smem,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      layer, scale, static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), K, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
