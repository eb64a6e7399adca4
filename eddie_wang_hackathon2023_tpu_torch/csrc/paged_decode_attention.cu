// Single-token decode attention straight off the block-paged KV pool.
//
// Replaces the TPU kernel eddie_wang_hackathon2023_tpu/ops/
// pallas_decode_attention.py:612 `_paged_kernel` (entry
// `paged_decode_attention_pallas`, :682): each row reads the pool blocks its
// block-table row names, with no gathered [B, max_blocks * T, ...] copy.
// The current token's K/V is already in the pool (serving appends before it
// reads), so there is no fresh operand.  Modes: bf16 or int8 pool with its
// per-tensor dequant scale, MQA/GQA (the rep = H / Hkv query heads of one
// KV head share that head's blocks), head dim a multiple of 16 up to 128.
// fp8 pools are refused by the wrapper.
//
// Numerics, as the TPU kernel's: scores q·k in fp32 times scale * kscale,
// positions >= seq masked, online softmax in fp32 over chunks of blocks; the
// unnormalised P enters P·V rounded to bf16 (:670) while the denominator
// sums it in fp32; the context is acc * kscale / denominator.  An int8 pool
// is read as integers and dequantised by kscale on the scores and the
// context.  Only the first ceil(seq / T) table entries of a row are read.
// Among them a -1 entry (a length longer than the row's table) is clamped
// to block 0, as the TPU kernel's index map does (:720), and block 0 is
// attended in its place; an entry beyond the pool is clamped to its last
// block, so no read leaves the pool.  A row with seq <= 0 writes zeros (the
// TPU kernel's 0/0 there is not a result either); the serving manager sends
// length 0 for a slot that is not live.
//
// Bound: at serve shapes (8 rows, 16 KV heads of 64, 60-80 tokens) K and V
// of the valid tokens are about 2.3 MB a call, 0.7 us at 3.35 TB/s; a
// block of this kernel is latency-bound well before that (each round of
// dependent device loads costs about a microsecond from one block).
// Design: one 256-thread block per (KV head, row), as the grouped kernel
// (gqa_decode_attention.cu).  Its loads come in two rounds: first the row's
// table entries (all of them, one thread each) together with q, then every
// needed [T, D] panel of K and V of this head (contiguous in the pool:
// 16-byte vector loads along D, up to kStage per thread in flight) into
// shared memory, token-major.  Rows of the staged tiles are padded by one
// 4-byte word, so that threads walking consecutive tokens at the same d
// meet no bank conflict.  Then per chunk: scores (a thread per (token,
// 4 queries)), the online softmax (a warp per query), P·V (a thread per
// (d, 4 queries), the tokens split over the idle threads and summed
// through shared memory).  A chunk is as many blocks as fit in 256 tokens
// and in shared memory; a longer table is walked chunk by chunk, the
// table itself read once.  All pool offsets are 64-bit (an L·N·2·Hkv·T·D
// pool passes 2^31 elements at deployment sizes).  The tensor-core passes
// and a split of long tables over several blocks are left for later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
constexpr int kMaxRep = 128;
constexpr int kMaxChunkTok = 256;        // tokens staged at a time
constexpr int kStage = 8;                // 16-byte loads a thread has in flight
constexpr size_t kMaxSmem = 227 * 1024;  // shared memory a block may take
constexpr float kNeg = -1e30f;

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

// a * b + c, lane by lane
__device__ __forceinline__ float4 fma4(float4 a, float b, float4 c) {
  return make_float4(fmaf(a.x, b, c.x), fmaf(a.y, b, c.y), fmaf(a.z, b, c.z),
                     fmaf(a.w, b, c.w));
}

// The values of one 4-byte word of a staged row: 2 bf16 or 4 int8.
template <typename CT> struct Word;
template <> struct Word<__nv_bfloat16> {
  static constexpr int n = 2;
  __device__ __forceinline__ static float at(uint32_t w, int e) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w);
    return e ? __high2float(h) : __low2float(h);
  }
};
template <> struct Word<int8_t> {
  static constexpr int n = 4;
  __device__ __forceinline__ static float at(uint32_t w, int e) {
    return (float)(int8_t)(w >> (8 * e));
  }
};

// Row stride (floats) of the [chunk][rep4] score tile: four times an odd
// number (4-way bank conflicts at most when a warp walks one query down it).
__host__ __device__ __forceinline__ int score_stride(int rep4) {
  return (rep4 / 4) % 2 ? rep4 : rep4 + 4;
}

// Row stride in 4-byte words of a staged [token][D] tile: the row's words
// plus one, odd for D a multiple of 16.
__host__ __device__ __forceinline__ int row_words(int D, int elem) {
  return D * elem / 4 + 1;
}

struct Smem {
  size_t bytes, q, acc, p, red, m, l, a, tab, kt, vt;
};

// Takes n_bytes at offset `at` (kept 16-byte aligned); returns its offset.
__host__ __device__ inline size_t take(size_t& at, size_t n_bytes) {
  const size_t here = at;
  at += (n_bytes + 15) & ~(size_t)15;
  return here;
}

// The shared-memory layout of one block: q and the accumulator [D][rep4],
// the score tile, the P·V partial sums, the softmax state, the table row,
// then the K and V tiles.
__host__ __device__ inline Smem layout(int D, int rep, int MB, int chunk_tok,
                                       int elem) {
  const int rep4 = (rep + 3) & ~3;
  Smem s;
  size_t at = 0;
  s.q = take(at, sizeof(float) * D * rep4);
  s.acc = take(at, sizeof(float) * D * rep4);
  s.p = take(at, sizeof(float) * chunk_tok * score_stride(rep4));
  s.red = take(at, sizeof(float4) * kThreads);
  s.m = take(at, sizeof(float) * rep4);
  s.l = take(at, sizeof(float) * rep4);
  s.a = take(at, sizeof(float) * rep4);
  s.tab = take(at, sizeof(int) * MB);
  s.kt = take(at, 4 * (size_t)chunk_tok * row_words(D, elem));
  s.vt = take(at, 4 * (size_t)chunk_tok * row_words(D, elem));
  s.bytes = at;
  return s;
}

template <typename CT>
__global__ void __launch_bounds__(kThreads)
paged_decode_attention_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, Hkv*rep, D]
    const CT* __restrict__ pool,           // [L, N, 2, Hkv, T, D]
    int layer, int N, int Hkv, int rep, int T, int D, int MB,
    const int* __restrict__ table,         // [B, MB]
    const int* __restrict__ seq_len,       // [B]
    const float* __restrict__ kscale_ptr, float scale, int chunk_blocks,
    __nv_bfloat16* __restrict__ out) {     // [B, Hkv*rep, D]
  const int kv = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rep4 = (rep + 3) & ~3, ng = rep4 / 4;
  const int rp = score_stride(rep4), rp4 = rp / 4;
  const int H = Hkv * rep;
  constexpr int E = (int)sizeof(CT);
  constexpr int per_word = Word<CT>::n;
  const int rw = row_words(D, E);          // staged row stride, words
  const int vec_row = D * E / 16;          // 16-byte vectors per token row
  const int chunk_tok = chunk_blocks * T;
  const Smem sm = layout(D, rep, MB, chunk_tok, E);

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + sm.q);      // [D][rep4]
  float* acc_s = reinterpret_cast<float*>(smem + sm.acc);  // [D][rep4]
  float* p_s = reinterpret_cast<float*>(smem + sm.p);      // [chunk][rp]
  float4* red4 = reinterpret_cast<float4*>(smem + sm.red); // [kThreads]
  float* m_s = reinterpret_cast<float*>(smem + sm.m);
  float* l_s = reinterpret_cast<float*>(smem + sm.l);
  float* a_s = reinterpret_cast<float*>(smem + sm.a);
  int* tab_s = reinterpret_cast<int*>(smem + sm.tab);
  uint32_t* k_t = reinterpret_cast<uint32_t*>(smem + sm.kt);
  uint32_t* v_t = reinterpret_cast<uint32_t*>(smem + sm.vt);
  const float4* q4 = reinterpret_cast<const float4*>(q_s);
  float4* acc4 = reinterpret_cast<float4*>(acc_s);
  float4* p4 = reinterpret_cast<float4*>(p_s);

  __nv_bfloat16* ob = out + ((size_t)b * H + (size_t)kv * rep) * D;
  const int seq = min(seq_len[b], MB * T);
  if (seq <= 0) {                          // not a live row: zeros
    for (int i = tid; i < rep * D; i += kThreads)
      ob[i] = __float2bfloat16(0.f);
    return;
  }
  const int n_need = (seq + T - 1) / T;    // blocks that hold the tokens
  const float kscale = kscale_ptr ? *kscale_ptr : 1.0f;
  const float s_mul = scale * kscale;

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
  // round 1: the table entries this row needs, and q (coalesced; query head
  // h = kv * rep + g of row b)
  for (int i = tid; i < n_need; i += kThreads)
    tab_s[i] = min(max(table[(size_t)b * MB + i], 0), N - 1);
  const __nv_bfloat16* qb = q + ((size_t)b * H + (size_t)kv * rep) * D;
#pragma unroll 4
  for (int i = tid; i < rep * D; i += kThreads)
    q_s[(i % D) * rep4 + i / D] = __bfloat162float(qb[i]);
  __syncthreads();

  const size_t panel = (size_t)T * D;      // elements of one [T, D] panel
  const size_t head0 = ((size_t)layer * N * 2 * Hkv) * panel;
  for (int c0 = 0; c0 < n_need; c0 += chunk_blocks) {
    const int cb = min(chunk_blocks, n_need - c0);
    const int nv = min(cb * T, seq - c0 * T);    // valid tokens of the chunk
    // round 2: stage the chunk's K and V panels, token-major
    const int per_panel = T * vec_row, total = 2 * cb * per_panel;
    for (int base = 0; base < total; base += kThreads * kStage) {
      uint4 r[kStage];
      uint32_t* dst[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int it = base + u * kThreads + tid;
        dst[u] = nullptr;
        if (it < total) {
          const int sel = it / (cb * per_panel);      // 0 K, 1 V
          const int rem = it - sel * cb * per_panel;
          const int i = rem / per_panel, w = rem - i * per_panel;
          const size_t blk = (size_t)tab_s[c0 + i];
          const CT* src = pool + head0
                          + ((blk * 2 + sel) * Hkv + kv) * panel;
          r[u] = *reinterpret_cast<const uint4*>(
              reinterpret_cast<const unsigned char*>(src) + (size_t)w * 16);
          const int tok = i * T + w / vec_row, col = w % vec_row;
          dst[u] = (sel ? v_t : k_t) + tok * rw + col * 4;
        }
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        if (dst[u] != nullptr) {
          dst[u][0] = r[u].x;
          dst[u][1] = r[u].y;
          dst[u][2] = r[u].z;
          dst[u][3] = r[u].w;
        }
      }
    }
    __syncthreads();
    // scores of (token j, queries 4*gq .. 4*gq+3), times scale * kscale
    for (int it = tid; it < ng * nv; it += kThreads) {
      const int gq = it / nv, j = it - gq * nv;
      const uint32_t* kr = k_t + j * rw;
      float4 dot = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int w = 0; w < D / per_word; ++w) {
        const uint32_t word = kr[w];
#pragma unroll
        for (int e = 0; e < per_word; ++e)
          dot = fma4(q4[(w * per_word + e) * ng + gq], Word<CT>::at(word, e),
                     dot);
      }
      p4[j * rp4 + gq] = make_float4(dot.x * s_mul, dot.y * s_mul,
                                     dot.z * s_mul, dot.w * s_mul);
    }
    __syncthreads();
    // online softmax, one warp per query.  The sum takes p in fp32; P·V
    // takes it rounded to bf16, as the TPU kernel casts it to the activation
    // dtype before that product
    for (int g = warp; g < rep; g += kWarps) {
      float m_loc = kNeg;
      for (int j = lane; j < nv; j += 32) m_loc = fmaxf(m_loc, p_s[j * rp + g]);
      const float m_new = fmaxf(m_s[g], warp_max(m_loc));
      float sum = 0.f;
      for (int j = lane; j < nv; j += 32) {
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
    // P·V of (row d, queries 4*gq .. 4*gq+3); where that leaves threads
    // idle, the chunk's tokens are split into `parts` ranges summed through
    // shared memory
    const int items = D * ng;
    const int parts = max(1, min(kThreads / items, (nv + 31) / 32));
    const int span = (nv + parts - 1) / parts;
    for (int it = tid; it < items * parts; it += kThreads) {
      const int part = it / items, item = it - part * items;
      const int d = item / ng, gq = item - d * ng;
      const int w = d / per_word, e = d - w * per_word;
      const int j1 = min(nv, (part + 1) * span);
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int j = part * span; j < j1; ++j)
        sum = fma4(p4[j * rp4 + gq], Word<CT>::at(v_t[j * rw + w], e), sum);
      if (parts == 1) {
        const float4 a = reinterpret_cast<const float4*>(a_s)[gq];
        const float4 acc = acc4[it];
        acc4[it] = make_float4(fmaf(acc.x, a.x, sum.x),
                               fmaf(acc.y, a.y, sum.y),
                               fmaf(acc.z, a.z, sum.z),
                               fmaf(acc.w, a.w, sum.w));
      } else {
        red4[it] = sum;                    // items * parts <= kThreads
      }
    }
    if (parts > 1) {
      __syncthreads();
      for (int it = tid; it < items; it += kThreads) {
        const int gq = it % ng;
        float4 sum = red4[it];
        for (int part = 1; part < parts; ++part) {
          const float4 o = red4[part * items + it];
          sum = make_float4(sum.x + o.x, sum.y + o.y, sum.z + o.z,
                            sum.w + o.w);
        }
        const float4 a = reinterpret_cast<const float4*>(a_s)[gq];
        const float4 acc = acc4[it];
        acc4[it] = make_float4(fmaf(acc.x, a.x, sum.x),
                               fmaf(acc.y, a.y, sum.y),
                               fmaf(acc.z, a.z, sum.z),
                               fmaf(acc.w, a.w, sum.w));
      }
    }
    __syncthreads();               // the tiles are rewritten by the next chunk
  }

  for (int it = tid; it < rep * D; it += kThreads) {
    const int g = it / D, d = it - g * D;
    const float denom = l_s[g];
    const float ctx = acc_s[d * rep4 + g] * (denom > 0.f ? kscale / denom : 0.f);
    ob[it] = __float2bfloat16(ctx);
  }
}

template <typename CT>
int launch(const void* q, const void* pool, int layer, int N, int Hkv,
           int rep, int T, int D, int B, int MB, const int* table,
           const int* seq_len, const float* kscale, float scale, void* out,
           cudaStream_t st) {
  // the most blocks per chunk (at most kMaxChunkTok tokens) whose shared
  // memory fits
  int chunk_blocks = max(1, min(MB, kMaxChunkTok / T));
  Smem sm = layout(D, rep, MB, chunk_blocks * T, (int)sizeof(CT));
  while (sm.bytes > kMaxSmem && chunk_blocks > 1) {
    chunk_blocks /= 2;
    sm = layout(D, rep, MB, chunk_blocks * T, (int)sizeof(CT));
  }
  if (sm.bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = paged_decode_attention_kernel<CT>;
  // the shared memory this instantiation may take, raised once per size
  static size_t smem_allowed = 48 * 1024;
  if (sm.bytes > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm.bytes);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = sm.bytes;
  }
  dim3 grid(Hkv, B);
  kernel<<<grid, kThreads, sm.bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const CT*>(pool),
      layer, N, Hkv, rep, T, D, MB, table, seq_len, kscale, scale,
      chunk_blocks, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Hkv*rep, D] bf16 (head h = kv*rep + g); pool [L, N, 2, Hkv, T, D]
// bf16 or int8, contiguous; table [B, MB] int32 (-1 padded); seq_len [B]
// int32 counts the current token (already in the pool); kscale one fp32 or
// null; out [B, Hkv*rep, D] bf16.  Returns cudaGetLastError() after the
// launch (0 = launched).
int paged_decode_attention(const void* q, const void* pool, int pool_is_int8,
                           int layer, int N, int Hkv, int rep, int T, int D,
                           int B, int MB, const int* table,
                           const int* seq_len, const float* kscale,
                           float scale, void* out, void* stream) {
  if (D < 16 || D > kMaxD || D % 16 || rep < 1 || rep > kMaxRep ||
      Hkv < 1 || T < 1 || N < 1 || MB < 1 || B < 1 || layer < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (pool_is_int8)
    return launch<int8_t>(q, pool, layer, N, Hkv, rep, T, D, B, MB, table,
                          seq_len, kscale, scale, out, st);
  return launch<__nv_bfloat16>(q, pool, layer, N, Hkv, rep, T, D, B, MB,
                               table, seq_len, kscale, scale, out, st);
}

}  // extern "C"
