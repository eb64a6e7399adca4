// MQA/GQA single-token decode attention over the stacked seq-minor cache.
//
// Replaces the TPU kernel eddie_wang_hackathon2023_tpu/ops/
// pallas_decode_attention.py:410 `_gqa_kernel` (assembled by `_gqa_call`,
// :518; entry `fused_decode_attention`, :767, when the query has more heads
// than the cache): the rep = H / Hkv query heads of one KV head share that
// head's cache, which is read once for all of them and never repeated.
// Modes: bf16 or int8 cache with its per-tensor dequant scale, the fresh
// K/V of the current token (deferred write), the start-index mask of
// left-padded prompts, any rep, head dim up to 128, any S.  fp8 caches and
// the K-step tail are refused by the wrapper.
//
// Numerics, as the TPU kernel's: scores in fp32 (q pre-multiplied by
// scale * kscale), softmax online in fp32 over chunks of columns, chunks
// past the valid length neither read nor computed; the unnormalised P enters
// P*V rounded to bf16 (:461-464) while the denominator sums it in fp32; the
// fresh column is scored from fp32 q and K and its V added in fp32 at the
// end (:478-481, :509-515); an int8 cache is read as integers and dequantised
// by kscale on the scores and on the context.
//
// Design: one 256-thread block per (KV head, batch row).  Its rep queries
// live in shared memory, [D][rep4] fp32 (rep4 = rep rounded up to 4, zero
// padded), so one float4 read gives four queries' d-th element; the fresh
// K/V are read there too, in the same round of loads as q.  The cache is
// walked in chunks of up to 128 columns, from the chunk that holds the start
// index.  Per chunk:
//   0. staging: the chunk's K and V columns [D][n] are copied into shared
//      memory in one round of loads (four columns a load where S % 4 == 0,
//      one otherwise), consecutive threads on consecutive columns of a row,
//      so every column is read from device memory once for all rep queries;
//   1. scores: a thread takes one column and four queries and walks d in
//      shared memory (columns below the start are not computed);
//   2. softmax: one warp per query over the chunk's scores (running max,
//      alpha, the fp32 sum), P written back rounded to bf16; the score
//      tile's rows are padded so that a warp reading one query's column
//      scores meets 4-way bank conflicts at most;
//   3. P*V: a thread takes one row d of V and four queries and walks the
//      chunk's columns in shared memory.
// Each phase waits for its slowest thread and each round of device loads
// costs about a microsecond, so the design keeps the rounds few: q and the
// fresh K/V in one, each chunk's K/V in one.  The block count is B * Hkv
// (8 blocks for MQA at batch 8): at the decode lengths of the decoder-only
// path (tens of columns) the kernel is bound by this latency, not by the
// bytes; an S-split with a combine pass is left for long contexts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
constexpr int kMaxRep = 128;
constexpr int kMaxChunk = 128;          // cache columns staged at a time
constexpr int kRowPad = 4;              // elements past each staged row
constexpr int kStage = 12;              // K and V loads a thread has in flight
constexpr size_t kMaxSmem = 227 * 1024; // shared memory a block may take
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

// Four consecutive cache elements, as one load (8 bytes of bf16, 4 of int8).
template <typename CT> struct Vec4;
template <> struct Vec4<__nv_bfloat16> { using T = uint2; };
template <> struct Vec4<int8_t> { using T = uint32_t; };

// Copies the [D][n] window at column c0 of the rows of k and v (row d at
// d * S) to the rows of kt and vt (row d at d * cs), kStage loads of each
// per thread in flight; ``vec``: four columns per load (S, c0 and cs
// multiples of 4; the last group may read up to 3 columns past n, never
// past S).
template <typename CT, bool vec>
__device__ __forceinline__ void stage(CT* kt, CT* vt, int cs,
                                      const CT* __restrict__ k,
                                      const CT* __restrict__ v, int D,
                                      size_t S, int c0, int n, int tid) {
  using T = typename std::conditional<vec, typename Vec4<CT>::T, CT>::type;
  constexpr int w = vec ? 4 : 1;
  const int per_row = (n + w - 1) / w, total = D * per_row;
  for (int base = 0; base < total; base += kThreads * kStage) {
    T kr[kStage], vr[kStage];
    int at[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int it = base + u * kThreads + tid;
      at[u] = -1;
      if (it < total) {
        const int d = it / per_row, j = (it - d * per_row) * w;
        const size_t g = (size_t)d * S + c0 + j;
        kr[u] = *reinterpret_cast<const T*>(k + g);
        vr[u] = *reinterpret_cast<const T*>(v + g);
        at[u] = d * cs + j;
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      if (at[u] >= 0) {
        *reinterpret_cast<T*>(kt + at[u]) = kr[u];
        *reinterpret_cast<T*>(vt + at[u]) = vr[u];
      }
    }
  }
}

// Row stride (floats) of the [chunk][rep4] score tile: four times an odd
// number, so that 32 consecutive rows start in 8 different bank groups
// (4-way conflicts at most when a warp walks one query down the rows).
__host__ __device__ __forceinline__ int score_stride(int rep4) {
  return (rep4 / 4) % 2 ? rep4 : rep4 + 4;
}

// a * b + c, lane by lane
__device__ __forceinline__ float4 fma4(float4 a, float b, float4 c) {
  return make_float4(fmaf(a.x, b, c.x), fmaf(a.y, b, c.y), fmaf(a.z, b, c.z),
                     fmaf(a.w, b, c.w));
}

template <typename CT>
__global__ void __launch_bounds__(kThreads)
gqa_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [B,H,D]
                            const CT* __restrict__ cache,  // [L,B,2,Hkv,D,S]
                            int layer, int B, int Hkv, int rep, int D, int S,
                            const int* __restrict__ seq_len,      // [B]
                            const int* __restrict__ start,        // [B]/null
                            const float* __restrict__ kscale_ptr, float scale,
                            const CT* __restrict__ fresh_k,   // [B,Hkv,D]/null
                            const CT* __restrict__ fresh_v,
                            int chunk, __nv_bfloat16* __restrict__ out) {
  const int kv = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rep4 = (rep + 3) & ~3, ng = rep4 / 4;
  const int rp = score_stride(rep4);       // row stride of the score tile
  const int H = Hkv * rep;
  const int cs = chunk + kRowPad;          // row stride of the K/V tiles

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                       // [D][rep4], q * scale * kscale
  float* acc_s = q_s + D * rep4;           // [D][rep4], unnormalised context
  float* p_s = acc_s + D * rep4;           // [chunk][rp], scores, then P
  float* m_s = p_s + chunk * rp;           // [rep4] running max
  float* l_s = m_s + rep4;                 // [rep4] running denominator
  float* a_s = l_s + rep4;                 // [rep4] this chunk's rescale
  const int D4 = (D + 3) & ~3;             // keeps the tiles 16-byte aligned
  float* fk_s = a_s + rep4;                // [D] the fresh K, V
  float* fv_s = fk_s + D4;
  CT* k_t = reinterpret_cast<CT*>(fv_s + D4);    // [D][cs] the chunk's K
  CT* v_t = k_t + D * cs;                        // [D][cs] and V
  const float4* q4 = reinterpret_cast<const float4*>(q_s);
  float4* acc4 = reinterpret_cast<float4*>(acc_s);
  const int rp4 = rp / 4;
  float4* p4 = reinterpret_cast<float4*>(p_s);

  const float kscale = kscale_ptr ? *kscale_ptr : 1.0f;
  const bool with_fresh = fresh_k != nullptr;
  const int cache_len = min(seq_len[b] - (with_fresh ? 1 : 0), S);
  const int lo = start ? max(start[b], 0) : 0;

  for (int i = tid; i < D * rep4; i += kThreads) {
    q_s[i] = 0.f;                          // the padding queries stay 0
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < rep4; g += kThreads) {
    m_s[g] = kNeg;
    l_s[g] = 0.f;
    a_s[g] = 1.f;                          // the padding queries keep it
  }
  __syncthreads();
  // one round of loads: the fresh K/V (issued first), then q, read
  // coalesced (query head h = kv * rep + g of row b)
  const size_t f0 = ((size_t)b * Hkv + kv) * D;
  float fk = 0.f, fv = 0.f;
  if (with_fresh && tid < D) {
    fk = to_f(fresh_k[f0 + tid]);
    fv = to_f(fresh_v[f0 + tid]);
  }
  const __nv_bfloat16* qb = q + ((size_t)b * H + (size_t)kv * rep) * D;
#pragma unroll 8
  for (int i = tid; i < rep * D; i += kThreads)
    q_s[(i % D) * rep4 + i / D] = to_f(qb[i]) * (scale * kscale);
  if (tid < D) {
    fk_s[tid] = fk;
    fv_s[tid] = fv;
  }

  const size_t head = (size_t)D * S;
  const CT* kp = cache + ((((size_t)layer * B + b) * 2 + 0) * Hkv + kv) * head;
  const CT* vp = cache + ((((size_t)layer * B + b) * 2 + 1) * Hkv + kv) * head;

  // chunks wholly below the start index are skipped; in a chunk, the
  // columns below it (j < jlo) are neither scored nor summed
  for (int c0 = (lo / chunk) * chunk; c0 < cache_len; c0 += chunk) {
    const int nc = min(chunk, cache_len - c0);
    const int jlo = max(lo - c0, 0), nv = nc - jlo;
    // 0. stage the chunk's K and V columns
    if (S % 4 == 0)
      stage<CT, true>(k_t, v_t, cs, kp, vp, D, S, c0, nc, tid);
    else
      stage<CT, false>(k_t, v_t, cs, kp, vp, D, S, c0, nc, tid);
    __syncthreads();
    // 1. scores of (column j, queries 4*gq .. 4*gq+3)
    for (int it = tid; it < ng * nv; it += kThreads) {
      const int gq = it / nv, j = jlo + it % nv;
      float4 dot = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int d = 0; d < D; ++d)
        dot = fma4(q4[d * ng + gq], to_f(k_t[d * cs + j]), dot);
      p4[j * rp4 + gq] = dot;
    }
    __syncthreads();
    // 2. online softmax, one warp per query.  The sum takes p in fp32; P*V
    // takes it rounded to bf16, as the TPU kernel casts it to the
    // activation dtype before that product
    for (int g = warp; g < rep; g += kWarps) {
      float m_loc = kNeg;
      for (int j = jlo + lane; j < nc; j += 32)
        m_loc = fmaxf(m_loc, p_s[j * rp + g]);
      const float m_new = fmaxf(m_s[g], warp_max(m_loc));
      float sum = 0.f;
      for (int j = jlo + lane; j < nc; j += 32) {
        const float p = __expf(p_s[j * rp + g] - m_new);
        p_s[j * rp + g] = __bfloat162float(__float2bfloat16(p));
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = __expf(m_s[g] - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        a_s[g] = alpha;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // 3. P*V of (row d, queries 4*gq .. 4*gq+3); acc4 index d * ng + gq
    for (int it = tid; it < D * ng; it += kThreads) {
      const int d = it / ng, gq = it % ng;
      const CT* vr = v_t + d * cs;
      float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int j = jlo; j < nc; ++j)
        part = fma4(p4[j * rp4 + gq], to_f(vr[j]), part);
      const float4 a = reinterpret_cast<const float4*>(a_s)[gq];
      const float4 acc = acc4[it];
      acc4[it] = make_float4(fmaf(acc.x, a.x, part.x), fmaf(acc.y, a.y, part.y),
                             fmaf(acc.z, a.z, part.z), fmaf(acc.w, a.w, part.w));
    }
    __syncthreads();               // the tiles are rewritten by the next chunk
  }
  __syncthreads();                 // q and the fresh K/V, when no chunk ran

  // the current token's column, from the fresh operand: per query the final
  // rescale of the cache part (a_s), the fresh probability (m_s) and
  // kscale / denominator (l_s)
  for (int g = warp; g < rep; g += kWarps) {
    float alpha = 1.f, p_f = 0.f;
    const float m = m_s[g];
    float denom = l_s[g];
    if (with_fresh) {
      float part = 0.f;
      for (int d = lane; d < D; d += 32) part += q_s[d * rep4 + g] * fk_s[d];
      const float s_f = warp_sum(part);
      const float m_fin = fmaxf(m, s_f);
      alpha = __expf(m - m_fin);
      p_f = __expf(s_f - m_fin);
      denom = denom * alpha + p_f;
    }
    __syncwarp();
    if (lane == 0) {
      a_s[g] = alpha;
      m_s[g] = p_f;
      l_s[g] = denom > 0.f ? kscale / denom : 0.f;
    }
  }
  __syncthreads();
  __nv_bfloat16* ob = out + ((size_t)b * H + (size_t)kv * rep) * D;
  for (int it = tid; it < rep * D; it += kThreads) {
    const int g = it / D, d = it % D;
    const float ctx = acc_s[d * rep4 + g] * a_s[g] + m_s[g] * fv_s[d];
    ob[it] = __float2bfloat16(ctx * l_s[g]);
  }
}

template <typename CT>
int launch(const void* q, const void* cache, int layer, int B, int Hkv,
           int rep, int D, int S, const int* seq_len, const int* start,
           const float* kscale, float scale, const void* fresh_k,
           const void* fresh_v, void* out, cudaStream_t st) {
  const int rep4 = (rep + 3) & ~3;
  // the widest chunk (128, 64 or 32 columns) whose shared memory fits
  size_t smem = 0;
  int chunk = kMaxChunk;
  for (; chunk >= 32; chunk /= 2) {
    smem = sizeof(float) * ((size_t)2 * D * rep4
                            + (size_t)chunk * score_stride(rep4) + 3 * rep4
                            + 2 * ((D + 3) & ~3))
           + sizeof(CT) * 2 * (size_t)D * (chunk + kRowPad);
    if (smem <= kMaxSmem) break;
  }
  if (chunk < 32) return (int)cudaErrorInvalidValue;
  auto kernel = gqa_decode_attention_kernel<CT>;
  // the shared memory this instantiation may take, raised once per size
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  dim3 grid(Hkv, B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const CT*>(cache),
      layer, B, Hkv, rep, D, S, seq_len, start, kscale, scale,
      static_cast<const CT*>(fresh_k), static_cast<const CT*>(fresh_v), chunk,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Hkv*rep, D] bf16 (head h = kv*rep + g); cache [L, B, 2, Hkv, D, S]
// bf16 or int8; seq_len [B] int32 counts the fresh token; start [B] int32 or
// null; kscale one fp32 or null; fresh_k/fresh_v [B, Hkv, D] in cache dtype
// or null; out [B, Hkv*rep*D] bf16.  Returns cudaGetLastError() after the
// launch (0 = launched).
int gqa_decode_attention(const void* q, const void* cache, int cache_is_int8,
                         int layer, int B, int Hkv, int rep, int D, int S,
                         const int* seq_len, const int* start,
                         const float* kscale, float scale,
                         const void* fresh_k, const void* fresh_v, void* out,
                         void* stream) {
  if (D < 1 || D > kMaxD || rep < 1 || rep > kMaxRep || S < 1 || Hkv < 1 ||
      (fresh_k == nullptr) != (fresh_v == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (cache_is_int8)
    return launch<int8_t>(q, cache, layer, B, Hkv, rep, D, S, seq_len, start,
                          kscale, scale, fresh_k, fresh_v, out, st);
  return launch<__nv_bfloat16>(q, cache, layer, B, Hkv, rep, D, S, seq_len,
                               start, kscale, scale, fresh_k, fresh_v, out,
                               st);
}

}  // extern "C"
