// Single-token decode attention straight off the block-paged KV pool.
//
// Replaces the TPU kernel eddie_wang_hackathon2023_tpu/ops/
// pallas_decode_attention.py:612 `_paged_kernel` (entry
// `paged_decode_attention_pallas`, :682): each row reads the pool blocks its
// block-table row names, with no gathered [B, max_blocks * T, ...] copy.
// The current token's K/V is already in the pool (serving appends before it
// reads), so there is no fresh operand.  Modes: bf16 or int8 pool with its
// per-tensor dequant scale, or an fp8 (e4m3) pool with the same scale (the
// TPU kernel's `quant` over float8_e4m3fn, :696; e4m3_t of e4m3.cuh, its
// bytes staged as int8's, each word decoded exactly by cvt.rn.f16x2.e4m3x2),
// MQA/GQA (the rep = H / Hkv query heads of one KV head share that head's
// blocks), head dim a multiple of 16 up to 128, any T and table width.
// Every entry reads only tokens below the row's length, so a NaN byte past
// it (e4m3 0x7F) is never read.
//
// Numerics, as the TPU kernel's: scores q·k in fp32 times scale * kscale,
// positions >= seq masked; the unnormalised P enters P·V rounded to bf16
// (:670) while the denominator sums it in fp32; the context is acc * kscale
// / denominator.  An int8 pool is read as integers and dequantised by
// kscale on the scores and the context.  P is rounded against the max of
// ALL the row's scores (the TPU kernel run as one chunk), exchanged before
// any p is formed.  Only tokens below seq are read.  Their table entries
// are clamped: a -1 entry (a length longer than the row's table) reads
// block 0, as the TPU kernel's index map does (:720), and an entry beyond
// the pool its last block, so no read leaves the pool.  A row with seq <= 0
// writes zeros (the TPU kernel's 0/0 there is not a result either); the
// serving manager sends length 0 for a slot that is not live.  All pool
// offsets are 64-bit.
//
// Bound: at serve shapes (8 rows, 16 KV heads of 64, 61-80 tokens) K and V
// of the valid tokens are about 2.3 MB a call, 0.7 us at 3.35 TB/s; a
// block is latency-bound well before that (each round of dependent device
// loads costs about a microsecond).  The first design ran one 256-thread
// block per (KV head, row) through seven block barriers, with its query
// lanes padded to four (3 of 4 idle at rep 1), a one-warp softmax and the
// panels moved through registers.  This one:
//   * the plan is the wrapper's (`paged_plan` in ops/decode_attention.py),
//     checked by the C entry: grid (Hkv * ceil(rep / heads), B, splits),
//     cluster (1, 1, splits); rank r of a cluster owns the row's tokens
//     [r * width, r * width + width), `splits` fixed by the static table
//     width, never by the lengths; `heads` (1 or 2) query heads a
//     block, so no query lane is padded at rep 1;
//   * two rounds of loads: the row's length, q, kscale and each lane's
//     token's table entry together; then every valid token's K and V row
//     (one piece of a contiguous [T, D] panel) by 16-byte cp.async straight
//     into shared memory, token-major, rows padded to an odd number of
//     16-byte units (no bank conflict when lanes walk tokens).  Each warp
//     copies and reads only its own 32 tokens, so the copies need a warp
//     barrier, not a block one;
//   * scores with a lane per token (its K row against q broadcast from
//     shared memory, for the block's query heads), the max by shuffles;
//     the warps' maxima through shared memory (one block barrier) and the
//     cluster's by st.async into every block's shared memory, counted on
//     its mbarrier;
//   * P·V with a lane per 4-byte word of the value rows, p of each token
//     by shuffle from its lane; the warps' partial contexts and sums
//     through shared memory (a second block barrier), added in warp order;
//     with a cluster, each block's partials go to rank 0 by st.async, which
//     adds them in rank order and normalises;
//   * a slice longer than one round (32 tokens a warp) is walked twice: K
//     alone for the max, then K and V for P and P·V (scores recomputed), so
//     P is still rounded against the max of all tokens.
//
// The beam entry (`paged_beam_attention`, beam search over the pool) replaces
// no TPU kernel: the JAX package runs paged beams in XLA, its masked
// cross-beam formulation (ops/paged_attention.py:139-170).  Rows are grouped
// by slot, r = g * bw + w, every beam row appending into its own private
// block chain; position s of row r is read from the chain of row g * bw +
// ind[g, w, s], the beam that wrote it (shared prompt blocks appear in every
// beam's table).  It is the single-token kernel above with that one
// difference, `kBeam` (one body, `paged_decode_body`, under two kernels,
// so that the single-token kernel keeps its parameters): each lane looks
// up its token's source row in the indirection table, then that row's
// table entry, before it stages the token.  Equal heads only (rep 1: the JAX formulation reshapes q with the
// KV heads and cannot run MQA/GQA beams).  Bound as the single-token
// entry's: the bytes of the distinct (block, token) pairs that the rows'
// tables and the indirection point at, which at the serve shape (32 rows of
// 16 heads of 64) is far below a block's latency.  The first design, simple
// and right: the two dependent loads (the indirection entry, then the table
// entry) lengthen round 1 by one load; tokens that several beams share are
// staged once a beam, each block reading its own row.
//
// The window entry (`paged_window_attention`, mixed context+generation
// admission) replaces no TPU kernel: the JAX package computes the window in
// XLA (ops/paged_attention.py:95, Lq > 1 with `causal_offset`), after its
// own paged_append_window.  It reads the same pool through the same table,
// W query tokens a row (a decode row's pending token and its pad lanes, or
// a prompt chunk at any offset): query row i of row b attends keys
// < seq[b] and <= offset[b] + i; a row with no valid key writes zeros.
// Bound: the valid tokens' K and V once, q and out (at the serve shape,
// 8 rows of 16 KV heads of 64, W 16, up to 128 tokens, about 2 MB, 0.6 us
// at 3.35 TB/s); its work, 2 W D flops a (query head, key), is far below
// the tensor cores' rate.  The first design, simple and right:
//   * a block a (row, KV head, tile of 16 query rows), the rows taken
//     token-major over the rep query heads of the KV head; 4 warps;
//   * the tile's keys up to its last row's diagonal, in chunks of 32 a
//     warp (chunk c to warp c % 4), staged by 16-byte cp.async into the
//     warp's own tiles, as the single-token entry stages them;
//   * a lane a key for the 16 rows' scores (q from shared memory, fp32),
//     both masks, then an online softmax a warp: P enters P·V rounded to
//     bf16 against the warp's running max, the sums in fp32;
//   * the warps' maxima, sums and contexts through shared memory, combined
//     at the end (one block barrier), the context times kscale / sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "e4m3.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 4;
constexpr int kMaxD = 128;
constexpr int kMaxRep = 128;
constexpr int kMaxSplits = 8;
// dynamic shared memory a block may take beside its static mbarriers
constexpr size_t kMaxSmem = 226 * 1024;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The values of one 4-byte word of a staged row: 2 bf16 or 4 int8, exact.
__device__ __forceinline__ void word_vals(uint32_t w, float (&f)[2],
                                          __nv_bfloat16) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}
// int8: each byte with its sign bit flipped (x + 128) becomes the low
// mantissa byte of 2^23, and 2^23 + 128 is subtracted
__device__ __forceinline__ void word_vals(uint32_t w, float (&f)[4], int8_t) {
  const uint32_t u = w ^ 0x80808080u;
  const float bias = 8388736.f;                      // 2^23 + 128
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + e)) - bias;
}

__device__ __forceinline__ void word_vals(uint32_t w, float (&f)[4], e4m3_t) {
  const float4 v = e4m3x4_to_float4(w);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// -- the cluster's messages (as kernel 1's, csrc/decode_attention.cu) --------

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
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
// counted in bytes on that block's mbarrier `bar`
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

// -- shared memory -----------------------------------------------------------

// Bytes of a staged token row: its 16-byte pieces, padded to an odd number
__host__ __device__ __forceinline__ int row_pitch(int D, int elem) {
  return 16 * ((D * elem / 16) | 1);
}

struct Smem {
  size_t tiles, q, red_m, red_l, red_c, max_s, l_s, ctx_s, bytes;
};

// Takes n_bytes at offset `at` (kept 16-byte aligned); returns its offset.
__host__ __device__ inline size_t take(size_t& at, size_t n_bytes) {
  const size_t here = at;
  at += (n_bytes + 15) & ~(size_t)15;
  return here;
}

// Each warp's K and V tiles [32][pitch]; q [heads][D] fp32; the warps'
// maxima, sums and partial contexts; the cluster's maxima and sums by rank;
// with a cluster, rank 0's partial contexts [splits][heads][D].
__host__ __device__ inline Smem layout(int D, int elem, int warps, int heads,
                                       int splits) {
  Smem s;
  size_t at = 0;
  s.tiles = take(at, (size_t)warps * 2 * kWarp * row_pitch(D, elem));
  s.q = take(at, sizeof(float) * heads * D);
  s.red_m = take(at, sizeof(float) * warps * heads);
  s.red_l = take(at, sizeof(float) * warps * heads);
  s.red_c = take(at, sizeof(float) * warps * heads * D);
  s.max_s = take(at, sizeof(float) * kMaxSplits * heads);
  s.l_s = take(at, sizeof(float) * kMaxSplits * heads);
  s.ctx_s = take(at, splits > 1 ? sizeof(float) * splits * heads * D : 0);
  s.bytes = at;
  return s;
}

// The single-token kernel's body.  kH: query heads a block (1 or 2); rows
// past rep in the last tile of heads are computed from zeros and never
// stored.  kBeam: each token's table row is that of the beam the
// indirection names (the beam entry); without it `ind` is not read
template <typename CT, int kH, bool kBeam>
__device__ __forceinline__ void paged_decode_body(
    const __nv_bfloat16* __restrict__ q,   // [B, Hkv*rep, D]
    const CT* __restrict__ pool,           // [L, N, 2, Hkv, T, D]
    int layer, int N, int Hkv, int rep, int T, int D, int MB,
    const int* __restrict__ table,         // [B, MB]
    const int* __restrict__ seq_len,       // [B]
    const float* __restrict__ kscale_ptr, float scale, int width,
    const int* __restrict__ ind,           // [B / bw, bw, S_ind] (kBeam)
    int bw, int S_ind,
    __nv_bfloat16* __restrict__ out) {     // [B, Hkv*rep, D]
  constexpr int E = (int)sizeof(CT);
  constexpr int kEW = 4 / E;               // values a 4-byte word
  constexpr int kEP = 16 / E;              // values a 16-byte piece
  constexpr int kMaxWords = kMaxD * E / 4 / kWarp;  // P·V words a lane
  const int n_rt = (rep + kH - 1) / kH;
  const int kv = blockIdx.x / n_rt, rt = blockIdx.x - kv * n_rt;
  const int b = blockIdx.y;
  const int splits = gridDim.z;
  const int rank = splits > 1 ? cluster_rank() : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x / kWarp;
  const int H = Hkv * rep;
  const int rows = min(kH, rep - rt * kH);   // live query heads
  const int pieces = D * E / 16;           // 16-byte pieces a token row
  const int words = D * E / 4;             // 4-byte words a token row
  const int pitch = row_pitch(D, E);
  const Smem sm = layout(D, E, warps, kH, splits);

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const k_t =
      smem + sm.tiles + (size_t)warp * 2 * kWarp * pitch;
  unsigned char* const v_t = k_t + kWarp * pitch;
  float* const q_s = reinterpret_cast<float*>(smem + sm.q);       // [kH][D]
  // the warps' maxima, sums [warps][kH] and contexts [warps][kH][D]
  float* const red_m = reinterpret_cast<float*>(smem + sm.red_m);
  float* const red_l = reinterpret_cast<float*>(smem + sm.red_l);
  float* const red_c = reinterpret_cast<float*>(smem + sm.red_c);
  float* const max_s = reinterpret_cast<float*>(smem + sm.max_s); // [8][kH]
  float* const l_s = reinterpret_cast<float*>(smem + sm.l_s);
  float* const ctx_s = reinterpret_cast<float*>(smem + sm.ctx_s);
  // [0]: every block's max has landed in max_s; [1], rank 0: every block's
  // partial context and sum have landed in ctx_s and l_s
  __shared__ __align__(8) uint64_t bars[2];

  if (splits > 1) {
    if (tid == 0) {
      mbar_init(&bars[0], 1);
      mbar_init(&bars[1], 1);
      mbar_expect_tx(&bars[0], splits * kH * 4);
      if (rank == 0) mbar_expect_tx(&bars[1], splits * kH * (D + 1) * 4);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_arrive_relaxed();
  }

  // round 1: the length, kscale, q (as bf16 pairs) and this lane's token's
  // table entry, every load issued before any is used
  const int cap = MB * T;
  const int lo_r = rank * width;           // this block's first token
  const int per_round = warps * kWarp;
  auto entry = [&](int tok) {              // raw, or 0 past the table
    if constexpr (kBeam) {
      if (tok >= cap) return 0;
      // the beam that wrote position tok (0 past the table's width), its
      // row among the group's bw consecutive rows
      const int src = tok < S_ind ? ind[(size_t)b * S_ind + tok] : 0;
      const int row = b - b % bw + min(max(src, 0), bw - 1);
      return table[(size_t)row * MB + tok / T];
    }
    return tok < cap ? table[(size_t)b * MB + tok / T] : 0;
  };
  int tab = entry(lo_r + warp * kWarp + lane);
  const int seq_raw = seq_len[b];
  const float kscale = kscale_ptr ? *kscale_ptr : 1.0f;
  const uint32_t* qb = reinterpret_cast<const uint32_t*>(
      q + ((size_t)b * H + (size_t)kv * rep + (size_t)rt * kH) * D);
  constexpr int kQW = (kH * kMaxD / 2 + kWarp - 1) / kWarp;
  const int q_words = rows * D / 2;
  uint32_t qw[kQW];
#pragma unroll
  for (int u = 0; u < kQW; ++u) {
    const int i = tid + u * blockDim.x;
    qw[u] = i < q_words ? qb[i] : 0u;
  }
  const int seq = min(seq_raw, cap);
  __nv_bfloat16* const ob =
      out + ((size_t)b * H + (size_t)kv * rep + (size_t)rt * kH) * D;
  if (seq <= 0) {                          // not a live row: zeros
    if (rank == 0)
      for (int i = tid; i < rows * D; i += blockDim.x)
        ob[i] = __float2bfloat16(0.f);
    return;
  }
  const int hi_r = min(seq, lo_r + width);
  const int n_r = max(0, hi_r - lo_r);
  const int n_rounds = (n_r + per_round - 1) / per_round;
  const bool single = n_rounds <= 1;       // K and V staged once

  const size_t panel = (size_t)T * D;      // elements of one [T, D] panel
  const size_t head0 = (size_t)layer * N * 2 * Hkv * panel + kv * panel;
  // the warp's tokens [base, base + nv) of a round into its tiles: lane t
  // copies the 16-byte pieces of its own token's K (and V) row, through
  // its own table entry
  auto stage = [&](int base, int nv, int entry_raw, bool with_v) {
    if (lane >= nv) return;
    const int blk = min(max(entry_raw, 0), N - 1);
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        pool + head0 + (size_t)blk * 2 * Hkv * panel
        + (size_t)((base + lane) % T) * D);
    const size_t v_off = (size_t)Hkv * panel * E;
    unsigned char* const kd = k_t + lane * pitch;
    unsigned char* const vd = v_t + lane * pitch;
    for (int u = 0; u < pieces; ++u) {
      cp_async16(kd + 16 * u, src + 16 * u);
      if (with_v) cp_async16(vd + 16 * u, src + v_off + 16 * u);
    }
  };
  auto round_span = [&](int ro, int& base, int& nv) {
    base = lo_r + ro * per_round + warp * kWarp;
    nv = min(max(hi_r - base, 0), kWarp);
  };
  int base = 0, nv = 0;
  if (n_rounds > 0) {
    round_span(0, base, nv);
    stage(base, nv, tab, single);
  }
  // q to shared memory as fp32 (rows past rep are zeros)
#pragma unroll
  for (int u = 0; u < kQW; ++u) {
    const int i = tid + u * blockDim.x;
    if (i < kH * D / 2) {
      const __nv_bfloat162 h =
          *reinterpret_cast<const __nv_bfloat162*>(&qw[u]);
      q_s[2 * i] = __low2float(h);
      q_s[2 * i + 1] = __high2float(h);
    }
  }
  __syncthreads();                         // q

  const float s_mul = scale * kscale;
  // scores of this lane's token for the block's heads, -1e30 where invalid
  float s[kH];
  auto scores = [&](int nv_) {
#pragma unroll
    for (int g = 0; g < kH; ++g) s[g] = 0.f;
    if (lane < nv_) {
      const uint4* kr = reinterpret_cast<const uint4*>(k_t + lane * pitch);
      for (int u = 0; u < pieces; ++u) {
        const uint4 p4 = kr[u];
        const uint32_t pw[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          float f[kEW];
          word_vals(pw[w], f, CT());
          const int d0 = u * kEP + w * kEW;
#pragma unroll
          for (int g = 0; g < kH; ++g) {
            const float* qg = q_s + g * D + d0;
            if constexpr (kEW == 2) {
              const float2 qv = *reinterpret_cast<const float2*>(qg);
              s[g] = fmaf(qv.x, f[0], s[g]);
              s[g] = fmaf(qv.y, f[1], s[g]);
            } else {
              const float4 qv = *reinterpret_cast<const float4*>(qg);
              s[g] = fmaf(qv.x, f[0], s[g]);
              s[g] = fmaf(qv.y, f[1], s[g]);
              s[g] = fmaf(qv.z, f[2], s[g]);
              s[g] = fmaf(qv.w, f[3], s[g]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kH; ++g) s[g] = lane < nv_ ? s[g] * s_mul : kNeg;
  };

  // 1. the scores and the max, round by round (one round: K and V staged
  // together, the scores kept for P)
  float m[kH];
#pragma unroll
  for (int g = 0; g < kH; ++g) m[g] = kNeg;
  for (int ro = 0; ro < n_rounds; ++ro) {
    if (ro > 0) {
      round_span(ro, base, nv);
      tab = entry(base + lane);
      __syncwarp();                        // the warp's tiles consumed
      stage(base, nv, tab, false);
    }
    cp_async_wait_all();
    __syncwarp();                          // the warp's copies have landed
    scores(nv);
#pragma unroll
    for (int g = 0; g < kH; ++g) m[g] = fmaxf(m[g], s[g]);
  }
#pragma unroll
  for (int g = 0; g < kH; ++g) {
    m[g] = warp_max(m[g]);
    if (lane == 0) red_m[warp * kH + g] = m[g];
  }
  __syncthreads();                         // the warps' maxima
#pragma unroll
  for (int g = 0; g < kH; ++g) {
    m[g] = red_m[g];
    #pragma unroll
    for (int w = 1; w < kMaxWarps; ++w)
      if (w < warps) m[g] = fmaxf(m[g], red_m[w * kH + g]);
  }
  if (splits > 1) {
    // the block's maxima to every block of the cluster, by rank
    cluster_wait();                        // every block runs
    for (int i = tid; i < splits * kH; i += blockDim.x) {
      const int g = i % kH;
      float mg = red_m[g];
      #pragma unroll
      for (int w = 1; w < kMaxWarps; ++w)
        if (w < warps) mg = fmaxf(mg, red_m[w * kH + g]);
      send(&max_s[rank * kH + g], mg, &bars[0], i / kH);
    }
    mbar_wait(&bars[0], 0);                // every block's maxima
#pragma unroll
    for (int g = 0; g < kH; ++g) {
      m[g] = max_s[g];
      #pragma unroll
      for (int r = 1; r < kMaxSplits; ++r)
        if (r < splits) m[g] = fmaxf(m[g], max_s[r * kH + g]);
    }
  }

  // 2. P against that max (the sum takes it in fp32, P·V rounded to bf16)
  // and P·V: lane w sums words w, w + 32 of the warp's value rows
  float acc[kH][kMaxWords * kEW];
  float l[kH];
#pragma unroll
  for (int g = 0; g < kH; ++g) {
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxWords * kEW; ++e) acc[g][e] = 0.f;
  }
  for (int ro = 0; ro < n_rounds; ++ro) {
    if (!single) {
      round_span(ro, base, nv);
      tab = entry(base + lane);
      __syncwarp();                        // the warp's tiles consumed
      stage(base, nv, tab, true);
      cp_async_wait_all();
      __syncwarp();                        // the warp's copies have landed
      scores(nv);
    }
    float p[kH];
#pragma unroll
    for (int g = 0; g < kH; ++g) {
      const float pg = lane < nv ? __expf(s[g] - m[g]) : 0.f;
      l[g] += pg;
      p[g] = __bfloat162float(__float2bfloat16(pg));
    }
    __syncwarp();                          // p
    // 8 tokens at a time, without a branch, so that their loads and
    // shuffles are in flight together; a token past nv reads the last
    // valid row with p = 0
    for (int t0 = 0; t0 < nv; t0 += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int t = t0 + u, tc = min(t, nv - 1);
        float pt[kH];
#pragma unroll
        for (int g = 0; g < kH; ++g) {
          const float pg = __shfl_sync(kFull, p[g], tc);
          pt[g] = t < nv ? pg : 0.f;
        }
        const uint32_t* vr =
            reinterpret_cast<const uint32_t*>(v_t + tc * pitch);
#pragma unroll
        for (int i = 0; i < kMaxWords; ++i) {
          const int w = lane + i * kWarp;
          if (w < words) {
            float f[kEW];
            word_vals(vr[w], f, CT());
#pragma unroll
            for (int g = 0; g < kH; ++g)
#pragma unroll
              for (int e = 0; e < kEW; ++e)
                acc[g][i * kEW + e] = fmaf(pt[g], f[e], acc[g][i * kEW + e]);
          }
        }
      }
    }
  }
  __syncwarp();                            // the warp's P·V
  // the warp's partials to shared memory: context [kH][D], sums [kH]
#pragma unroll
  for (int g = 0; g < kH; ++g) {
    const float lg = warp_sum(l[g]);
    if (lane == 0) red_l[warp * kH + g] = lg;
#pragma unroll
    for (int i = 0; i < kMaxWords; ++i) {
      const int w = lane + i * kWarp;
      if (w < words)
#pragma unroll
        for (int e = 0; e < kEW; ++e)
          red_c[(warp * kH + g) * D + w * kEW + e] = acc[g][i * kEW + e];
    }
  }
  __syncthreads();                         // the warps' partials

  // the warps in order; then the normalisation, or the block's partials to
  // rank 0, which adds them in rank order
  float lt[kH];
#pragma unroll
  for (int g = 0; g < kH; ++g) {
    lt[g] = red_l[g];
    #pragma unroll
    for (int w = 1; w < kMaxWarps; ++w)
      if (w < warps) lt[g] += red_l[w * kH + g];
  }
  auto block_ctx = [&](int g, int d) {
    float c = red_c[g * D + d];
    #pragma unroll
    for (int w = 1; w < kMaxWarps; ++w)
      if (w < warps) c += red_c[(w * kH + g) * D + d];
    return c;
  };
  if (splits > 1) {
#pragma unroll
    for (int g = 0; g < kH; ++g)
      for (int d = tid; d < D; d += blockDim.x)
        send(&ctx_s[(rank * kH + g) * D + d], block_ctx(g, d), &bars[1], 0);
    if (tid == 0)
#pragma unroll
      for (int g = 0; g < kH; ++g)
        send(&l_s[rank * kH + g], lt[g], &bars[1], 0);
    // a block other than rank 0 is done: every write into its shared
    // memory (the maxima) has landed
    if (rank != 0) return;
    mbar_wait(&bars[1], 0);                // every block's partials
#pragma unroll
    for (int g = 0; g < kH; ++g) {
      lt[g] = l_s[g];
      #pragma unroll
      for (int r = 1; r < kMaxSplits; ++r)
        if (r < splits) lt[g] += l_s[r * kH + g];
    }
  }
#pragma unroll
  for (int g = 0; g < kH; ++g) {
    if (g >= rows) break;
    const float inv = lt[g] > 0.f ? kscale / lt[g] : 0.f;
    for (int d = tid; d < D; d += blockDim.x) {
      float c;
      if (splits == 1) {
        c = block_ctx(g, d);
      } else {
        c = ctx_s[g * D + d];
        #pragma unroll
        for (int r = 1; r < kMaxSplits; ++r)
          if (r < splits) c += ctx_s[(r * kH + g) * D + d];
      }
      ob[g * D + d] = __float2bfloat16(c * inv);
    }
  }
}

template <typename CT, int kH>
__global__ void __launch_bounds__(kMaxWarps * kWarp, 1)
paged_decode_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const CT* __restrict__ pool,
    int layer, int N, int Hkv, int rep, int T, int D, int MB,
    const int* __restrict__ table, const int* __restrict__ seq_len,
    const float* __restrict__ kscale_ptr, float scale, int width,
    __nv_bfloat16* __restrict__ out) {
  paged_decode_body<CT, kH, false>(q, pool, layer, N, Hkv, rep, T, D, MB,
                                   table, seq_len, kscale_ptr, scale, width,
                                   nullptr, 1, 0, out);
}

// the beam entry: one query head a block, equal heads
template <typename CT>
__global__ void __launch_bounds__(kMaxWarps * kWarp, 1)
paged_beam_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const CT* __restrict__ pool,
    int layer, int N, int H, int T, int D, int MB,
    const int* __restrict__ table, const int* __restrict__ seq_len,
    const float* __restrict__ kscale_ptr, float scale, int width,
    const int* __restrict__ ind, int bw, int S_ind,
    __nv_bfloat16* __restrict__ out) {
  paged_decode_body<CT, 1, true>(q, pool, layer, N, H, 1, T, D, MB, table,
                                 seq_len, kscale_ptr, scale, width, ind, bw,
                                 S_ind, out);
}

template <typename CT, int kH, bool kBeam>
int launch(const void* q, const void* pool, int layer, int N, int Hkv,
           int rep, int T, int D, int B, int MB, const int* table,
           const int* seq_len, const float* kscale, float scale, int splits,
           int width, int warps, const int* ind, int bw, int S_ind,
           void* out, cudaStream_t st) {
  const Smem sm = layout(D, (int)sizeof(CT), warps, kH, splits);
  if (sm.bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = [] {
    if constexpr (kBeam) return paged_beam_attention_kernel<CT>;
    else return paged_decode_attention_kernel<CT, kH>;
  }();
  // the shared memory this instantiation may take, raised once per size
  static size_t smem_allowed = 48 * 1024;
  if (sm.bytes > smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm.bytes);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = sm.bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hkv * ((rep + kH - 1) / kH), B, splits);
  cfg.blockDim = dim3(warps * kWarp);
  cfg.dynamicSmemBytes = sm.bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* pp = static_cast<const CT*>(pool);
  auto* op = static_cast<__nv_bfloat16*>(out);
  cudaError_t e;
  if constexpr (kBeam)
    e = cudaLaunchKernelEx(&cfg, kernel, qp, pp, layer, N, Hkv, T, D, MB,
                           table, seq_len, kscale, scale, width, ind, bw,
                           S_ind, op);
  else
    e = cudaLaunchKernelEx(&cfg, kernel, qp, pp, layer, N, Hkv, rep, T, D,
                           MB, table, seq_len, kscale, scale, width, op);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename CT>
int launch_heads(int heads, const void* q, const void* pool, int layer,
                 int N, int Hkv, int rep, int T, int D, int B, int MB,
                 const int* table, const int* seq_len, const float* kscale,
                 float scale, int splits, int width, int warps, void* out,
                 cudaStream_t st) {
  if (heads == 1)
    return launch<CT, 1, false>(q, pool, layer, N, Hkv, rep, T, D, B, MB,
                                table, seq_len, kscale, scale, splits, width,
                                warps, nullptr, 1, 0, out, st);
  return launch<CT, 2, false>(q, pool, layer, N, Hkv, rep, T, D, B, MB,
                              table, seq_len, kscale, scale, splits, width,
                              warps, nullptr, 1, 0, out, st);
}

// -- the window entry --------------------------------------------------------

constexpr int kWinRows = 16;     // query rows a block (tokens x query heads)
constexpr int kWinWarps = 4;

struct WinSmem {
  size_t tiles, q, red_m, red_l, red_c, bytes;
};

// Each warp's K and V tiles [32][pitch]; q [16][D] fp32; the warps'
// maxima and sums [warps][16] and contexts [warps][16][D]
__host__ __device__ inline WinSmem win_layout(int D, int elem) {
  WinSmem s;
  size_t at = 0;
  s.tiles = take(at, (size_t)kWinWarps * 2 * kWarp * row_pitch(D, elem));
  s.q = take(at, sizeof(float) * kWinRows * D);
  s.red_m = take(at, sizeof(float) * kWinWarps * kWinRows);
  s.red_l = take(at, sizeof(float) * kWinWarps * kWinRows);
  s.red_c = take(at, sizeof(float) * kWinWarps * kWinRows * D);
  s.bytes = at;
  return s;
}

template <typename CT>
__global__ void __launch_bounds__(kWinWarps * kWarp, 1)
paged_window_attention_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, Hkv*rep, W, D]
    const CT* __restrict__ pool,           // [L, N, 2, Hkv, T, D]
    int layer, int N, int Hkv, int rep, int T, int D, int MB, int W,
    const int* __restrict__ table,         // [B, MB]
    const int* __restrict__ seq_len,       // [B]
    const int* __restrict__ offset,        // [B]
    const float* __restrict__ kscale_ptr, float scale,
    __nv_bfloat16* __restrict__ out) {     // [B, Hkv*rep, W, D]
  constexpr int E = (int)sizeof(CT);
  constexpr int kEW = 4 / E;               // values a 4-byte word
  constexpr int kEP = 16 / E;              // values a 16-byte piece
  constexpr int kMaxWords = kMaxD * E / 4 / kWarp;  // P·V words a lane
  const int M = W * rep;                   // query rows of one KV head
  const int n_tiles = (M + kWinRows - 1) / kWinRows;
  const int kv = blockIdx.x / n_tiles, tile = blockIdx.x - kv * n_tiles;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = Hkv * rep;
  const int pieces = D * E / 16;           // 16-byte pieces a token row
  const int words = D * E / 4;             // 4-byte words a token row
  const int pitch = row_pitch(D, E);
  const WinSmem sm = win_layout(D, E);

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const k_t =
      smem + sm.tiles + (size_t)warp * 2 * kWarp * pitch;
  unsigned char* const v_t = k_t + kWarp * pitch;
  float* const q_s = reinterpret_cast<float*>(smem + sm.q);   // [16][D]
  float* const red_m = reinterpret_cast<float*>(smem + sm.red_m);
  float* const red_l = reinterpret_cast<float*>(smem + sm.red_l);
  float* const red_c = reinterpret_cast<float*>(smem + sm.red_c);

  // query row r of the tile: token i = (r0 + r) / rep, head g = (r0 + r) %
  // rep of the KV head; rows past M are zeros and never stored
  const int r0 = tile * kWinRows;
  const int rows = min(kWinRows, M - r0);
  const int seq = min(seq_len[b], MB * T);
  const int off = offset[b];
  const float kscale = kscale_ptr ? *kscale_ptr : 1.0f;
  auto q_row = [&](int r) -> size_t {      // element offset of row r
    const int qi = r0 + r, i = qi / rep, g = qi - i * rep;
    return (((size_t)b * H + (size_t)kv * rep + g) * W + i) * D;
  };
  for (int idx = tid; idx < kWinRows * D / 2; idx += blockDim.x) {
    const int r = idx / (D / 2), c = idx - r * (D / 2);
    float2 f = make_float2(0.f, 0.f);
    if (r < rows)
      f = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(q + q_row(r))[c]);
    q_s[r * D + 2 * c] = f.x;
    q_s[r * D + 2 * c + 1] = f.y;
  }
  // each row's keys end (exclusive) at its diagonal and at seq; the tile's
  // at its last row's
  int lim[kWinRows];
#pragma unroll
  for (int r = 0; r < kWinRows; ++r)
    lim[r] = r < rows ? min(seq, off + (r0 + r) / rep + 1) : 0;
  const int kend = max(0, min(seq, off + (r0 + rows - 1) / rep + 1));
  __syncthreads();                         // q

  const size_t panel = (size_t)T * D;      // elements of one [T, D] panel
  const size_t head0 = (size_t)layer * N * 2 * Hkv * panel + kv * panel;
  const size_t v_off = (size_t)Hkv * panel * E;
  const float s_mul = scale * kscale;
  float m[kWinRows], l[kWinRows], acc[kWinRows][kMaxWords * kEW];
#pragma unroll
  for (int r = 0; r < kWinRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxWords * kEW; ++e) acc[r][e] = 0.f;
  }
  for (int c = warp; c * kWarp < kend; c += kWinWarps) {
    const int base = c * kWarp, nv = min(kWarp, kend - base);
    const int tok = base + lane;
    __syncwarp();                          // the warp's tiles consumed
    if (lane < nv) {
      const int entry = table[(size_t)b * MB + tok / T];
      const int blk = min(max(entry, 0), N - 1);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          pool + head0 + (size_t)blk * 2 * Hkv * panel
          + (size_t)(tok % T) * D);
      for (int u = 0; u < pieces; ++u) {
        cp_async16(k_t + lane * pitch + 16 * u, src + 16 * u);
        cp_async16(v_t + lane * pitch + 16 * u, src + v_off + 16 * u);
      }
    }
    cp_async_wait_all();
    __syncwarp();                          // the warp's copies have landed
    float s[kWinRows];
#pragma unroll
    for (int r = 0; r < kWinRows; ++r) s[r] = 0.f;
    if (lane < nv) {
      const uint4* kr = reinterpret_cast<const uint4*>(k_t + lane * pitch);
      for (int u = 0; u < pieces; ++u) {
        const uint4 p4 = kr[u];
        const uint32_t pw[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          float f[kEW];
          word_vals(pw[w], f, CT());
          const int d0 = u * kEP + w * kEW;
#pragma unroll
          for (int r = 0; r < kWinRows; ++r)
#pragma unroll
            for (int e = 0; e < kEW; ++e)
              s[r] = fmaf(q_s[r * D + d0 + e], f[e], s[r]);
        }
      }
    }
    // both masks, then the warp's online softmax
    float p[kWinRows];
#pragma unroll
    for (int r = 0; r < kWinRows; ++r) {
      const bool ok = lane < nv && tok < lim[r];
      const float sr = ok ? s[r] * s_mul : kNeg;
      const float mn = fmaxf(m[r], warp_max(sr));
      const float alpha = __expf(m[r] - mn);
      const float pr = ok ? __expf(sr - mn) : 0.f;
      l[r] = l[r] * alpha + pr;            // this lane's share of the sum
#pragma unroll
      for (int e = 0; e < kMaxWords * kEW; ++e) acc[r][e] *= alpha;
      m[r] = mn;
      p[r] = __bfloat162float(__float2bfloat16(pr));
    }
    // P·V: lane w sums words w, w + 32 of the chunk's value rows
    for (int t = 0; t < nv; ++t) {
      float pt[kWinRows];
#pragma unroll
      for (int r = 0; r < kWinRows; ++r) pt[r] = __shfl_sync(kFull, p[r], t);
      const uint32_t* vr = reinterpret_cast<const uint32_t*>(v_t + t * pitch);
#pragma unroll
      for (int i = 0; i < kMaxWords; ++i) {
        const int w = lane + i * kWarp;
        if (w < words) {
          float f[kEW];
          word_vals(vr[w], f, CT());
#pragma unroll
          for (int r = 0; r < kWinRows; ++r)
#pragma unroll
            for (int e = 0; e < kEW; ++e)
              acc[r][i * kEW + e] = fmaf(pt[r], f[e], acc[r][i * kEW + e]);
        }
      }
    }
  }
  // the warp's maxima, sums and contexts to shared memory
#pragma unroll
  for (int r = 0; r < kWinRows; ++r) {
    const float lr = warp_sum(l[r]);
    if (lane == 0) {
      red_m[warp * kWinRows + r] = m[r];
      red_l[warp * kWinRows + r] = lr;
    }
#pragma unroll
    for (int i = 0; i < kMaxWords; ++i) {
      const int w = lane + i * kWarp;
      if (w < words)
#pragma unroll
        for (int e = 0; e < kEW; ++e)
          red_c[(warp * kWinRows + r) * D + w * kEW + e] =
              acc[r][i * kEW + e];
    }
  }
  __syncthreads();                         // the warps' partials
  // the warps in order, rescaled to the row's max; zeros for a row with no
  // valid key
  for (int idx = tid; idx < rows * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    float mt = kNeg;
#pragma unroll
    for (int w = 0; w < kWinWarps; ++w)
      mt = fmaxf(mt, red_m[w * kWinRows + r]);
    float lt = 0.f, ct = 0.f;
#pragma unroll
    for (int w = 0; w < kWinWarps; ++w) {
      const float a = __expf(red_m[w * kWinRows + r] - mt);
      lt = fmaf(red_l[w * kWinRows + r], a, lt);
      ct = fmaf(red_c[(w * kWinRows + r) * D + d], a, ct);
    }
    out[q_row(r) + d] = __float2bfloat16(lt > 0.f ? ct * kscale / lt : 0.f);
  }
}

template <typename CT>
int launch_window(const void* q, const void* pool, int layer, int N, int Hkv,
                  int rep, int T, int D, int B, int MB, int W,
                  const int* table, const int* seq_len, const int* offset,
                  const float* kscale, float scale, void* out,
                  cudaStream_t st) {
  const WinSmem sm = win_layout(D, (int)sizeof(CT));
  if (sm.bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = paged_window_attention_kernel<CT>;
  static size_t smem_allowed = 48 * 1024;
  if (sm.bytes > smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm.bytes);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = sm.bytes;
  }
  const long long tiles = ((long long)W * rep + kWinRows - 1) / kWinRows;
  kernel<<<dim3((unsigned)(Hkv * tiles), B), kWinWarps * kWarp, sm.bytes,
           st>>>(static_cast<const __nv_bfloat16*>(q),
                 static_cast<const CT*>(pool), layer, N, Hkv, rep, T, D, MB,
                 W, table, seq_len, offset, kscale, scale,
                 static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Hkv*rep, D] bf16 (head h = kv*rep + g); pool [L, N, 2, Hkv, T, D]
// of kind 0 (bf16), 1 (int8) or 2 (e4m3), contiguous, 16-byte aligned; table [B, MB] int32 (-1
// padded); seq_len [B] int32 counts the current token (already in the
// pool); kscale one fp32 or null; out [B, Hkv*rep, D] bf16.  The plan is
// the wrapper's `paged_plan`: `splits` blocks a cluster (1-8), each
// `width` tokens (a multiple of 32; the slices cover the table), `warps`
// warps a block (1, 2 or 4), walking its slice in `rounds` =
// ceil(width / (32 * warps)) rounds, `heads` query heads a block (1 or
// 2).  Any other plan is refused.  Returns the launch's CUDA error
// (0 = launched).
int paged_decode_attention(const void* q, const void* pool, int kind,
                           int layer, int N, int Hkv, int rep, int T, int D,
                           int B, int MB, const int* table,
                           const int* seq_len, const float* kscale,
                           float scale, int splits, int width, int warps,
                           int rounds, int heads, void* out, void* stream) {
  const bool pow2_warps = warps == 1 || warps == 2 || warps == 4;
  const bool pow2_heads = heads == 1 || heads == 2;
  if (D < 16 || D > kMaxD || D % 16 || rep < 1 || rep > kMaxRep ||
      Hkv < 1 || T < 1 || N < 1 || MB < 1 || B < 1 || B > 65535 ||
      layer < 0 || splits < 1 || splits > kMaxSplits || width < kWarp ||
      width % kWarp || (long long)splits * width < (long long)MB * T ||
      (long long)(splits - 1) * width >= (long long)MB * T || !pow2_warps ||
      rounds != (width + warps * kWarp - 1) / (warps * kWarp) ||
      !pow2_heads || kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (kind == 2)
    return launch_heads<e4m3_t>(heads, q, pool, layer, N, Hkv, rep, T, D, B,
                                MB, table, seq_len, kscale, scale, splits,
                                width, warps, out, st);
  if (kind == 1)
    return launch_heads<int8_t>(heads, q, pool, layer, N, Hkv, rep, T, D, B,
                                MB, table, seq_len, kscale, scale, splits,
                                width, warps, out, st);
  return launch_heads<__nv_bfloat16>(heads, q, pool, layer, N, Hkv, rep, T,
                                     D, B, MB, table, seq_len, kscale, scale,
                                     splits, width, warps, out, st);
}

// The beam entry: q [B, H, D] bf16 and a pool of H KV heads (equal heads);
// pool, table, seq_len and kscale as above, the rows grouped by slot (B a
// multiple of bw); ind [B / bw, bw, S_ind] int32: position s of row
// g * bw + w is read through the table row g * bw + ind[g, w, s] (0 past
// S_ind); the plan is the wrapper's `paged_plan` at rep 1 (heads 1).
// Returns the launch's CUDA error (0 = launched).
int paged_beam_attention(const void* q, const void* pool, int kind,
                         int layer, int N, int H, int T, int D, int B,
                         int MB, const int* table, const int* seq_len,
                         const int* ind, int bw, int S_ind,
                         const float* kscale, float scale, int splits,
                         int width, int warps, int rounds, void* out,
                         void* stream) {
  const bool pow2_warps = warps == 1 || warps == 2 || warps == 4;
  if (D < 16 || D > kMaxD || D % 16 || H < 1 || T < 1 || N < 1 || MB < 1 ||
      B < 1 || B > 65535 || bw < 1 || B % bw || S_ind < 1 || layer < 0 ||
      splits < 1 || splits > kMaxSplits || width < kWarp || width % kWarp ||
      (long long)splits * width < (long long)MB * T ||
      (long long)(splits - 1) * width >= (long long)MB * T || !pow2_warps ||
      rounds != (width + warps * kWarp - 1) / (warps * kWarp) || kind < 0 ||
      kind > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (kind == 2)
    return launch<e4m3_t, 1, true>(q, pool, layer, N, H, 1, T, D, B, MB,
                                   table, seq_len, kscale, scale, splits,
                                   width, warps, ind, bw, S_ind, out, st);
  if (kind == 1)
    return launch<int8_t, 1, true>(q, pool, layer, N, H, 1, T, D, B, MB,
                                   table, seq_len, kscale, scale, splits,
                                   width, warps, ind, bw, S_ind, out, st);
  return launch<__nv_bfloat16, 1, true>(q, pool, layer, N, H, 1, T, D, B, MB,
                                        table, seq_len, kscale, scale, splits,
                                        width, warps, ind, bw, S_ind, out, st);
}

// The window entry: q [B, Hkv*rep, W, D] bf16 (head h = kv*rep + g);
// pool, table and kscale as above; seq_len [B] int32 counts the window's
// tokens (already in the pool); offset [B] int32: query token i of row b
// attends keys <= offset[b] + i (and < seq_len[b]); out [B, Hkv*rep, W, D]
// bf16.  Returns the launch's CUDA error (0 = launched).
int paged_window_attention(const void* q, const void* pool, int kind,
                           int layer, int N, int Hkv, int rep, int T, int D,
                           int B, int MB, int W, const int* table,
                           const int* seq_len, const int* offset,
                           const float* kscale, float scale, void* out,
                           void* stream) {
  const long long blocks_x =
      (long long)Hkv * (((long long)W * rep + kWinRows - 1) / kWinRows);
  if (D < 16 || D > kMaxD || D % 16 || rep < 1 || rep > kMaxRep ||
      Hkv < 1 || T < 1 || N < 1 || MB < 1 || B < 1 || B > 65535 || W < 1 ||
      layer < 0 || blocks_x > 0x7fffffffLL || kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (kind == 2)
    return launch_window<e4m3_t>(q, pool, layer, N, Hkv, rep, T, D, B, MB, W,
                                 table, seq_len, offset, kscale, scale, out,
                                 st);
  if (kind == 1)
    return launch_window<int8_t>(q, pool, layer, N, Hkv, rep, T, D, B, MB, W,
                                 table, seq_len, offset, kscale, scale, out,
                                 st);
  return launch_window<__nv_bfloat16>(q, pool, layer, N, Hkv, rep, T, D, B,
                                      MB, W, table, seq_len, offset, kscale,
                                      scale, out, st);
}

}  // extern "C"
