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
// one layer's K and V; the arithmetic is 4*D flops per column.  K/V are
// read once, straight from device memory, in their stored dtype (int8 is
// never expanded into a float copy; the scale multiplies the scores and
// the context instead).  What held the first design back was latency, not
// bytes: one block per (head, row) left 112 of 132 SMs idle at batch 1 and
// walked the cache in dependent rounds of loads and block barriers.  So:
//   * the sequence is split over a thread-block cluster: grid (H, B,
//     splits), cluster (1, 1, splits), `splits` = ceil(S / 256) capped at
//     8, fixed by the static S on the host (the valid length lives on the
//     device); block `rank` owns columns [rank * W, rank * W + W), W =
//     ceil(S / splits) rounded up to 4 (S = 1500: 6 slices of 252, 120
//     blocks at batch 1; S = 448: 2 of 224);
//   * each block starts the loads of its slice's K and V at once, one
//     round of 4-byte (int8) or 8-byte (bf16) cp.async into shared memory
//     (rows are S elements apart, so at S = 1500 only every fourth row
//     starts on 16 bytes: no wider vector and no TMA tensor map fits),
//     only up to the last valid column; a slice past the valid length or
//     below `start` reads nothing;
//   * q, the lengths and (rank 0) the fresh K/V are read in one round,
//     before the copies start;
//   * scores from shared memory (four interleaved d-groups of 64 column
//     groups, int8 to float by a byte permute into 2^23's mantissa), the
//     slice max by warp shuffles; the cluster's max by messages: each
//     block stores its max into every block's shared memory with st.async,
//     counted on the receiver's mbarrier (a point-to-point exchange, no
//     barrier of the whole cluster); p = exp(s - max) against the CLUSTER
//     max, so P*V takes p rounded to bf16 relative to the row's true max
//     (the TPU kernel run as one chunk) while the denominator sums p in
//     fp32;
//   * P*V: each warp sums its eight rows interleaved, one load of p for
//     all of them; every block sends its fp32 context [D] and sum to rank
//     0's shared memory the same way, and is done; rank 0 sums them in rank
//     order (deterministic), adds the fresh column, normalises and writes
//     bf16 [B, H*D].  One launch, no scratch in device memory, one cluster
//     barrier (at the start: no block writes into one not yet running);
//   * at most 48 registers a thread, so five blocks fit an SM and the 600
//     blocks of batch 5 run in one wave.
// Every sum has a fixed order and no product is contracted into an FMA
// (__fmul_rn / __fadd_rn), so `plain_split_decode_attention` in
// ops/decode_attention.py repeats the arithmetic step by step and the
// kernel equals it bit for bit.
//
// Beam search (the TPU kernel's `_beam_kernel`, :213, entry `_beam_call`
// :320) keeps the first design's code, `beam_decode_attention_kernel`
// (the first kernel's beam instantiation without its non-beam branches; a
// rewrite of it ran slower on the card).  Query row b of group
// g = b / bw reads each cache position s from row g*bw + ind[b][s] of its
// group (ind is the [groups, bw, S] cache-indirection table), so the cache
// is never reordered.  Row g*bw speaks for the group's length and start;
// the fresh K/V is the row's own.  One 256-thread block per (head, query
// row) walks the cache in chunks of 1024 columns with the softmax online
// in fp32; the TPU kernel instead reads each source row of a group once
// for all bw query beams.  Here the bw blocks of a group read the same
// rows, and all but the first read can hit L2 (a layer's self cache at the
// Whisper beam path's shapes is a few MB), so the bound counts the
// group-once bytes.  Each column's source row may differ from its
// neighbour's, so the loads are per column (2 or 1 bytes); the P*V pass
// reads the chunk's source rows from shared memory; P enters P*V rounded
// to bf16 against the running max.
//
// The TPU kernel ran its epilogue GEMV inside the same kernel from a VMEM
// panel.  A single block cannot read the 1.6 MB panel fast, so here it is a
// second kernel spread over N: out[b, n] = (sum_k ctx[b, k] W[l, k, n]) *
// scale[n] + bias[n], with the context cast to bf16 first and fp32
// accumulation, as weight_only_quant_matmul does.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
constexpr float kNeg = -1e30f;
constexpr int kChunk = 4 * kThreads;       // beam: columns a chunk, 4 a thread
constexpr int kSplitCols = kThreads;       // split: columns staged a round
constexpr int kMaxSplits = 8;

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

// One element of a cache row as a float.
__device__ __forceinline__ float load1(const int8_t* p) { return (float)*p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Four cache columns col..col+3 of row d (d_off = d*S elements past the
// head's base), each from its own cache row, src.x..src.w rows past the
// base row.
template <typename CT>
__device__ __forceinline__ float4 load_cols(const CT* base, size_t d_off,
                                            int col, int4 src,
                                            size_t row_stride) {
  const CT* p = base + d_off + col;
  return make_float4(load1(p + src.x * row_stride),
                     load1(p + 1 + src.y * row_stride),
                     load1(p + 2 + src.z * row_stride),
                     load1(p + 3 + src.w * row_stride));
}

template <typename CT>
__global__ void __launch_bounds__(kThreads)
beam_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [B,H,D]
                             const CT* __restrict__ cache,  // [L,Bkv,2,H,D,S]
                             int layer, int Bkv, int H, int D, int S,
                             const int* __restrict__ seq_len,       // [B]
                             const int* __restrict__ start,   // [B] or null
                             const float* __restrict__ kscale_ptr,
                             float scale,
                             const CT* __restrict__ fresh_k,      // [B,H,D]
                             const CT* __restrict__ fresh_v,
                             const int* __restrict__ ind,         // [B,S]
                             int bw,                        // beam width
                             __nv_bfloat16* __restrict__ out) {   // [B,H*D]
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ float q_s[kMaxD];
  __shared__ float acc_s[kMaxD];
  __shared__ __align__(16) float p_s[kChunk];
  __shared__ float red[kWarps];
  // each column's source row (its beam in the group), for the P*V pass of
  // the chunk
  __shared__ __align__(16) int src_s[kChunk];

  // the group's first row: the base of the group's cache rows, and the
  // row that speaks for the lengths
  const int row0 = b - b % bw;
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
  const int* ind_b = ind + (size_t)b * S;

  float m_run = kNeg, l_run = 0.f;
  const int n_chunks = (cache_len + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * kChunk;
    // scores: four consecutive columns per thread (S % 4 == 0, so a group
    // that starts below cache_len <= S lies inside the row)
    const int col = c0 + 4 * tid;
    float s[4] = {kNeg, kNeg, kNeg, kNeg};
    int4 src = make_int4(0, 0, 0, 0);
    if (col < cache_len) {
      // columns at or past cache_len (<= S) keep beam 0: read, never used
      src.x = ind_b[col];
      if (col + 1 < cache_len) src.y = ind_b[col + 1];
      if (col + 2 < cache_len) src.z = ind_b[col + 2];
      if (col + 3 < cache_len) src.w = ind_b[col + 3];
      *reinterpret_cast<int4*>(src_s + 4 * tid) = src;
    }
    if (col < cache_len) {
      float4 dot = make_float4(0.f, 0.f, 0.f, 0.f);
      // unrolled so that many of the D independent row loads are in flight
      // at once (one at a time, each would wait a full memory latency)
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        const float4 kv =
            load_cols(kp, (size_t)d * S, col, src, row_stride);
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
        src_j = *reinterpret_cast<const int4*>(src_s + j);
        const float4 v =
            load_cols(vp, (size_t)d * S, c0 + j, src_j, row_stride);
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

// -- kernel 1 without beams: the sequence split over a cluster --------------

// Four consecutive int8 values (one 32-bit word) as exact floats: each byte
// with its sign bit flipped (x + 128) becomes the low mantissa byte of
// 2^23, and 2^23 + 128 is subtracted, so no conversion instruction is used.
__device__ __forceinline__ float4 cols4(const int8_t* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
  const float bias = 8388736.f;                      // 2^23 + 128
  return make_float4(__int_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - bias,
                     __int_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - bias,
                     __int_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - bias,
                     __int_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - bias);
}
__device__ __forceinline__ float4 cols4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// Four cache columns (4 or 8 bytes) copied to shared memory, asynchronously.
__device__ __forceinline__ void cp_async_cols(int8_t* dst, const int8_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_cols(__nv_bfloat16* dst,
                                              const __nv_bfloat16* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// P*V's term for one column: a masked column (p == 0) adds nothing, even
// when its value is not finite (0 * inf would be NaN).  p is a bf16 value
// and v an int8 or bf16 one, so the product is exact.
__device__ __forceinline__ float pv_term(float p, float v) {
  return p != 0.f ? __fmul_rn(p, v) : 0.f;
}

// The cluster barrier, once: every block arrives at its start (after its
// mbarriers are set up) and waits before its first write into another
// block's shared memory, so that no write lands in a block not yet running.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}
// v into `dst` of block `rank` of the cluster (the same variable there),
// counted in bytes on that block's mbarrier `bar`: a point-to-point
// message, no barrier of the whole cluster
__device__ __forceinline__ void send(float* dst, float v, uint64_t* bar,
                                     int rank) {
  uint32_t rd, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rd) : "r"(smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rb) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(rd), "r"(__float_as_uint(v)), "r"(rb) : "memory");
}

// kDMax: the largest head dim the instantiation takes (64 or 128); each
// warp sums P*V for kDMax / 8 rows.
template <typename CT, int kDMax>
__global__ void __launch_bounds__(kThreads, 5)
split_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [B,H,D]
                              const CT* __restrict__ cache,  // [L,B,2,H,D,S]
                              int layer, int H, int D, int S, int W,
                              const int* __restrict__ seq_len,      // [B]
                              const int* __restrict__ start,  // [B] or null
                              const float* __restrict__ kscale_ptr,
                              float scale,
                              const CT* __restrict__ fresh_k,     // [B,H,D]
                              const CT* __restrict__ fresh_v,  // or null
                              __nv_bfloat16* __restrict__ out) {  // [B,H*D]
  constexpr int kRows = kDMax / kWarps;       // P*V rows a warp
  const cg::cluster_group cluster = cg::this_cluster();
  const int h = blockIdx.x, b = blockIdx.y, B = gridDim.y;
  const int rank = (int)cluster.block_rank();
  const int splits = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CT* const k_s = reinterpret_cast<CT*>(smem_raw);        // [D][kSplitCols]
  CT* const v_s = k_s + (size_t)D * kSplitCols;           // [D][kSplitCols]
  // the four d-groups' partial scores [4][kSplitCols], then the slice's
  // scores [W], which become p rounded to bf16
  float* const part_s = reinterpret_cast<float*>(v_s + (size_t)D * kSplitCols);
  float* const p_s = part_s + 4 * kSplitCols;
  __shared__ float q_s[kDMax];
  __shared__ float fk_s[kDMax];               // rank 0: the fresh key
  __shared__ float max_s[kMaxSplits];         // every block's max, by rank
  __shared__ float ctx_s[kMaxSplits][kDMax];  // rank 0: partial contexts
  __shared__ float l_s[kMaxSplits];           // rank 0: partial sums
  __shared__ float red[kWarps];
  __shared__ float sf_s;
  // [0]: every block's max has landed in max_s; [1], rank 0: every
  // block's partials have landed in ctx_s and l_s
  __shared__ __align__(8) uint64_t bars[2];

  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_expect_tx(&bars[0], splits * 4);
    if (rank == 0) mbar_expect_tx(&bars[1], splits * (D + 1) * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive_relaxed();

  // q and, in rank 0, the fresh K/V are read in the round of the lengths
  const size_t f0 = ((size_t)b * H + h) * D;
  const bool with_fresh = fresh_k != nullptr;
  const bool fin = rank == 0 && with_fresh;
  float qv = 0.f, fk = 0.f, fv = 0.f;
  if (tid < D) {
    qv = to_f(q[f0 + tid]);
    if (fin) {
      fk = to_f(fresh_k[f0 + tid]);
      fv = to_f(fresh_v[f0 + tid]);
    }
  }
  const float kscale = kscale_ptr ? *kscale_ptr : 1.0f;
  const float sk = __fmul_rn(scale, kscale);
  const int cache_len = min(seq_len[b] - (with_fresh ? 1 : 0), S);
  const int lo = start ? start[b] : 0;
  const int c_begin = rank * W;
  // this slice reads columns [c_begin, c_begin + n_ld): up to its last
  // valid one, rounded up to 4 columns (S % 4 == 0 keeps them in the row),
  // or none when no column of the slice is valid
  const int v_hi = min(c_begin + W, cache_len);
  const int n_ld = max(c_begin, lo) < v_hi ? (v_hi - c_begin + 3) & ~3 : 0;
  const int n_rounds = (n_ld + kSplitCols - 1) / kSplitCols;
  const size_t head = (size_t)D * S;
  const CT* kp =
      cache + ((((size_t)layer * B + b) * 2) * H + h) * head + c_begin;
  const CT* vp = kp + (size_t)H * head;

  // thread (dg, g): column group g (4 columns) of rows dg, dg + 4, ..., for
  // the copies and for the scores
  const int g = tid % (kSplitCols / 4), dg = tid / (kSplitCols / 4);
  // columns [c0, c0 + kSplitCols) of the slice's K or V into dst
  auto stage = [&](CT* dst, const CT* src, int c0) {
    if (4 * g < n_ld - c0)
      for (int d = dg; d < D; d += 4)
        cp_async_cols(dst + d * kSplitCols + 4 * g,
                      src + (size_t)d * S + c0 + 4 * g);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // one round: the first columns of K and of V together
  if (n_rounds > 0) {
    stage(k_s, kp, 0);
    stage(v_s, vp, 0);
  }
  // q pre-multiplied by scale*kscale: scores come out ready for softmax
  if (tid < D) {
    q_s[tid] = __fmul_rn(qv, sk);
    fk_s[tid] = fk;
  }
  __syncthreads();
  if (fin && warp == 0) {
    // the current token's score, summed as a cache column's is
    float a = 0.f;
    if (lane < 4)
      for (int d = lane; d < D; d += 4)
        a = __fadd_rn(a, __fmul_rn(q_s[d], fk_s[d]));
    const float a1 = __shfl_sync(0xffffffffu, a, 1);
    const float a2 = __shfl_sync(0xffffffffu, a, 2);
    const float a3 = __shfl_sync(0xffffffffu, a, 3);
    if (lane == 0) sf_s = __fadd_rn(__fadd_rn(__fadd_rn(a, a1), a2), a3);
  }

  // scores: thread (dg, g) sums d = dg, dg + 4, ... for columns 4g..4g+3;
  // the four d-groups are then added in order
  for (int r = 0; r < n_rounds; ++r) {
    const int c0 = r * kSplitCols, cw = min(kSplitCols, n_ld - c0);
    if (r > 0) stage(k_s, kp, c0);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (4 * g < cw) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 8
      for (int d = dg; d < D; d += 4) {
        const float4 k = cols4(k_s + d * kSplitCols + 4 * g);
        const float qd = q_s[d];
        a0 = __fadd_rn(a0, __fmul_rn(qd, k.x));
        a1 = __fadd_rn(a1, __fmul_rn(qd, k.y));
        a2 = __fadd_rn(a2, __fmul_rn(qd, k.z));
        a3 = __fadd_rn(a3, __fmul_rn(qd, k.w));
      }
      *reinterpret_cast<float4*>(part_s + dg * kSplitCols + 4 * g) =
          make_float4(a0, a1, a2, a3);
    }
    __syncthreads();
    for (int j = tid; j < cw; j += kThreads) {
      const int col = c_begin + c0 + j;
      const float s = __fadd_rn(
          __fadd_rn(__fadd_rn(part_s[j], part_s[kSplitCols + j]),
                    part_s[2 * kSplitCols + j]),
          part_s[3 * kSplitCols + j]);
      p_s[c0 + j] = col < cache_len && col >= lo ? s : kNeg;
    }
    __syncthreads();                   // part_s and k_s are reused
  }

  // the cluster's max: each block's own to every block, by rank
  float m = kNeg;
  for (int j = tid; j < n_ld; j += kThreads) m = fmaxf(m, p_s[j]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  cluster_wait();                      // every block of the cluster runs
  if (tid < splits) send(&max_s[rank], m, &bars[0], tid);
  mbar_wait(&bars[0], 0);
  m = max_s[0];
  for (int r = 1; r < splits; ++r) m = fmaxf(m, max_s[r]);

  // p against the cluster's max: the sum takes it in fp32, P*V rounded to
  // bf16, as the TPU kernel casts it to the activation dtype
  // (pallas_decode_attention.py:149)
  float l = 0.f;
  for (int j = tid; j < n_ld; j += kThreads) {
    const int col = c_begin + j;
    const float p =
        col < cache_len && col >= lo ? expf(__fsub_rn(p_s[j], m)) : 0.f;
    l = __fadd_rn(l, p);
    p_s[j] = __bfloat162float(__float2bfloat16(p));
  }
  l = warp_sum(l);
  if (lane == 0) red[warp] = l;
  __syncthreads();                     // red and p_s complete

  // P*V: warp w owns rows d = w, w + 8, ...; lane j0 adds columns
  // 4*j0..4*j0+3, then 128 further, and so on, into one sum a row (the
  // rows' sums interleaved); then the warp's lanes are summed
  float part[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) part[i] = 0.f;
  for (int r = 0; r < n_rounds; ++r) {
    const int c0 = r * kSplitCols, cw = min(kSplitCols, n_ld - c0);
    if (r > 0) {
      __syncthreads();                 // v_s is consumed
      stage(v_s, vp, c0);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
    // four columns of p, then their terms for the warp's rows; where all
    // four are valid (p != 0) the select is not needed
    auto terms = [&](const float4 p, int j, auto masked_t) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int d = warp + i * kWarps;
        if (d < D) {
          const float4 v = cols4(v_s + d * kSplitCols + j);
          if (decltype(masked_t)::value) {
            part[i] = __fadd_rn(part[i], pv_term(p.x, v.x));
            part[i] = __fadd_rn(part[i], pv_term(p.y, v.y));
            part[i] = __fadd_rn(part[i], pv_term(p.z, v.z));
            part[i] = __fadd_rn(part[i], pv_term(p.w, v.w));
          } else {
            part[i] = __fadd_rn(part[i], __fmul_rn(p.x, v.x));
            part[i] = __fadd_rn(part[i], __fmul_rn(p.y, v.y));
            part[i] = __fadd_rn(part[i], __fmul_rn(p.z, v.z));
            part[i] = __fadd_rn(part[i], __fmul_rn(p.w, v.w));
          }
        }
      }
    };
    for (int j = 4 * lane; j < cw; j += 128) {
      const float4 p = *reinterpret_cast<const float4*>(p_s + c0 + j);
      if (p.x != 0.f && p.y != 0.f && p.z != 0.f && p.w != 0.f)
        terms(p, j, std::false_type{});
      else
        terms(p, j, std::true_type{});
    }
  }
  // the partial context and sum to rank 0's shared memory: lane i sends
  // row warp + 8 i
  float mine = 0.f;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float r = warp_sum(part[i]);
    if (lane == i) mine = r;
  }
  if (lane < kRows && warp + lane * kWarps < D)
    send(&ctx_s[rank][warp + lane * kWarps], mine, &bars[1], 0);
  if (tid == 0) {
    float lb = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) lb = __fadd_rn(lb, red[w]);
    send(&l_s[rank], lb, &bars[1], 0);
  }
  // a block other than rank 0 is done: every write into its shared memory
  // (the maxima) has landed
  if (rank != 0 || tid >= D) return;
  mbar_wait(&bars[1], 0);

  // rank 0: the slices in rank order, the fresh column, the normalisation
  float acc = ctx_s[0][tid], lt = l_s[0];
  for (int r = 1; r < splits; ++r) {
    acc = __fadd_rn(acc, ctx_s[r][tid]);
    lt = __fadd_rn(lt, l_s[r]);
  }
  if (with_fresh) {
    const float s_f = sf_s;
    const float m_fin = fmaxf(m, s_f);
    const float alpha = expf(__fsub_rn(m, m_fin));
    const float p_f = expf(__fsub_rn(s_f, m_fin));
    lt = __fadd_rn(__fmul_rn(lt, alpha), p_f);
    acc = __fadd_rn(__fmul_rn(acc, alpha), __fmul_rn(p_f, fv));
  }
  const float inv = lt > 0.f ? __fdiv_rn(kscale, lt) : 0.f;
  out[f0 + tid] = __float2bfloat16(__fmul_rn(acc, inv));
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

// shared memory beside the static arrays that a block may take
constexpr size_t kMaxDynSmem = 200 * 1024;

template <typename CT>
int launch_split(const void* q, const void* cache, int layer, int B, int H,
                 int D, int S, int splits, const int* seq_len,
                 const int* start, const float* kscale, float scale,
                 const void* fresh_k, const void* fresh_v, void* out,
                 cudaStream_t st) {
  const int W = ((S + splits - 1) / splits + 3) & ~3;
  const size_t smem = 2 * (size_t)D * kSplitCols * sizeof(CT)
                      + (4 * (size_t)kSplitCols + W) * sizeof(float);
  if (smem > kMaxDynSmem) return (int)cudaErrorInvalidValue;
  auto kernel = D <= 64 ? split_decode_attention_kernel<CT, 64>
                        : split_decode_attention_kernel<CT, kMaxD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(q),
      static_cast<const CT*>(cache), layer, H, D, S, W, seq_len, start,
      kscale, scale, static_cast<const CT*>(fresh_k),
      static_cast<const CT*>(fresh_v), static_cast<__nv_bfloat16*>(out));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename CT>
int launch_beam(const void* q, const void* cache, int layer, int B, int H,
                int D, int S, const int* seq_len, const int* start,
                const float* kscale, float scale, const void* fresh_k,
                const void* fresh_v, const int* ind, int bw, void* out,
                cudaStream_t st) {
  beam_decode_attention_kernel<CT><<<dim3(H, B), kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const CT*>(cache),
      layer, B, H, D, S, seq_len, start, kscale, scale,
      static_cast<const CT*>(fresh_k), static_cast<const CT*>(fresh_v), ind,
      bw, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One cluster launch: grid (H, B, splits), cluster (1, 1, splits), splits
// in [1, 8] (the wrapper's `decode_splits(S)`); the cache holds B rows.
// Returns the launch's CUDA error (0 = launched).
int decode_attention(const void* q, const void* cache, int cache_is_int8,
                     int layer, int B, int H, int D, int S,
                     int splits, const int* seq_len, const int* start,
                     const float* kscale, float scale, const void* fresh_k,
                     const void* fresh_v, void* out, void* stream) {
  if (D > kMaxD || S % 4 || splits < 1 || splits > kMaxSplits
      || (fresh_k == nullptr) != (fresh_v == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return cache_is_int8
      ? launch_split<int8_t>(q, cache, layer, B, H, D, S, splits, seq_len,
                             start, kscale, scale, fresh_k, fresh_v, out, st)
      : launch_split<__nv_bfloat16>(q, cache, layer, B, H, D, S, splits,
                                    seq_len, start, kscale, scale, fresh_k,
                                    fresh_v, out, st);
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
  if (bw < 1 || B % bw || !fresh_k || !fresh_v || !ind || D > kMaxD || S % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return cache_is_int8
      ? launch_beam<int8_t>(q, cache, layer, B, H, D, S, seq_len, start,
                            kscale, scale, fresh_k, fresh_v, ind, bw, out, st)
      : launch_beam<__nv_bfloat16>(q, cache, layer, B, H, D, S, seq_len,
                                   start, kscale, scale, fresh_k, fresh_v,
                                   ind, bw, out, st);
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
