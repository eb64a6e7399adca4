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
// Numerics, as the TPU kernel's (:443-515): the scores are bf16 q times
// bf16 K (an int8 cache converted exactly) summed in fp32, then multiplied
// by scale * kscale; the unnormalised P enters P*V rounded to bf16 while
// the denominator sums it in fp32; the fresh column is scored from q and K
// with exact products summed in fp32 (the TPU kernel's fp32 product of the
// same bf16 or int8 values) and its V added in fp32 at the end; the
// context is dequantised by kscale.  P is rounded against the max of ALL
// the cached columns (the TPU kernel run as one chunk, which it is below S
// 128), exchanged before any p is formed.
//
// Bound: bytes (the valid columns of one KV head, read once for its rep
// query heads); at the decoder path's lengths (tens of columns) the latency
// of dependent phases instead.  The first design walked the columns in
// chunks of four phases on the CUDA cores (staging, scores, a softmax of one
// warp per query, P*V), each behind a block barrier, with the scores and P
// through a shared-memory tile.  This one:
//   * products on the tensor cores, `mma.sync m16n8k16` (bf16 in, fp32
//     out): 16 query heads a block are the m of the mma (rows past rep are
//     zeros, never stored; rep > 16 takes ceil(rep / 16) blocks a KV head,
//     each reading the head's columns, the later ones mostly from L2); D is
//     zero-padded to a multiple of 16 in shared memory;
//   * the cache is seq-minor, so a staged tile is [D][n] with the keys
//     contiguous, the transpose of the usual [key][d]: S's B operand (k = d,
//     n = key) comes by `ldmatrix.trans`, P*V's (k = key, n = d) by plain
//     `ldmatrix`; rows are padded to 272 bytes (bf16), so both are free of
//     bank conflicts.  An int8 cache forms its fragments from byte loads,
//     converted to bf16 exactly;
//   * one round of loads: q, the fresh K/V, the lengths and, when the
//     whole cache fits one round (one block, S <= 128), all of its K and V
//     columns by `cp.async` (8 bytes of bf16 or 4 of int8 a copy where
//     S % 4 == 0, element copies otherwise); q and the fresh K/V are loaded
//     into registers before any is stored, so that no load waits on a
//     store; columns past the valid range that P*V reads are zeroed after
//     they land, so a masked column adds nothing even when the cache holds
//     no finite value there;
//   * the fresh key sits in the K tile's padding column, so its score is
//     one more mma n-tile (the last warp's), not a dot product per head;
//   * warp w scores columns 16 w .. 16 w + 15 of a round of 128 (at seq 70,
//     5 warps), masks and scales in registers; the row max goes over the
//     quad of lanes by shuffles, over the warps through shared memory (one
//     barrier); P is formed in registers against it, rounded to bf16 into
//     a [16][128] tile, the fp32 sum kept (a second barrier); then warp w
//     computes P*V for d 16 w .. 16 w + 15 over all the columns, so no
//     partial contexts are summed across warps; the fresh column's terms
//     (once a query head), the normalisation and the bf16 store follow from
//     registers;
//   * long caches: above 128 columns the sequence is split over a
//     thread-block cluster of `splits` = min(8, ceil(S / 128)) blocks (the
//     wrapper's `gqa_splits(S)`, from the static S, never from the lengths):
//     grid (Hkv * ceil(rep / 16), B, splits), cluster (1, 1, splits); block
//     `rank` owns W columns from rank * W (the wrapper's
//     `gqa_slice_width(S, splits)`: ceil(S / splits) rounded up to 16).  Each
//     block's max goes to every block by `st.async` into its shared memory,
//     counted on its mbarrier; a block whose slice holds no valid column
//     sends m = -1e30 and later l = 0 and a zero context.  Every block sends
//     its partial context and sum to rank 0 the same way, which adds them in
//     rank order (each query head's max, sum and fresh-column terms once,
//     then the elements).  A slice wider than 128 columns (S > 1024) is
//     walked in rounds twice: once for the max, once for P and P*V (the
//     scores recomputed), so P is still rounded against the max of all
//     columns.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
constexpr int kMaxRep = 128;
constexpr int kRows = 16;               // query heads a block: the mma's m
constexpr int kChunk = 16 * kWarps;     // cache columns a round, 16 a warp
constexpr int kMaxSplits = 8;
constexpr size_t kMaxSmem = 227 * 1024; // shared memory a block may take
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

// over the four lanes of a quad (the lanes that share an mma row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four consecutive cache elements (8 bytes of bf16, 4 of int8) copied to
// shared memory asynchronously.
__device__ __forceinline__ void cp_async4(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(int8_t* dst, const int8_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// c += a b, m16n8k16, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
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

// -- staging -----------------------------------------------------------------

// Row pitch (elements) of a staged [D][kChunk] tile: 272 bytes of bf16, 144
// of int8, 16-byte rows whose ldmatrix / byte reads meet no bank conflict.
template <typename CT> __host__ __device__ constexpr int tile_pitch() {
  return sizeof(CT) == 2 ? kChunk + 8 : kChunk + 16;
}

// The staging map of a round: kW columns a copy (4 where S % 4 == 0, else
// 1), so a row has kChunk / kW groups; thread t takes group t % that of rows
// t / that, t / that + rows-a-pass, ...
template <int kW> struct Groups {
  static constexpr int per_row = kChunk / kW;
  static constexpr int rows_a_pass = kThreads / per_row;
};

// kW zero elements at p (aligned to their size: kW = 4 is one store)
template <int kW>
__device__ __forceinline__ void zero(__nv_bfloat16* p) {
  if constexpr (kW == 4) *reinterpret_cast<uint2*>(p) = make_uint2(0u, 0u);
  else *p = __float2bfloat16(0.f);
}
template <int kW>
__device__ __forceinline__ void zero(int8_t* p) {
  if constexpr (kW == 4) *reinterpret_cast<uint32_t*>(p) = 0u;
  else *p = 0;
}

// Columns [col0 + j_lo, col0 + j_hi) of K (and V) into the tiles: a group
// that lies below S and (unless `all`) meets the valid range [lo, hi) is
// copied, by cp.async (kW = 4) or a load and a store (kW = 1); every other
// group, and the rows d >= D (the padding to Dp), are zeros.
template <typename CT, int kW>
__device__ __forceinline__ void stage(CT* kt, CT* vt, const CT* kp,
                                      const CT* vp, bool with_v, int D,
                                      int Dp, int S, int col0, int j_lo,
                                      int j_hi, int lo, int hi, bool all,
                                      int tid) {
  using G = Groups<kW>;
  constexpr int P = tile_pitch<CT>();
  const int j = (tid % G::per_row) * kW;
  if (j < j_lo || j >= j_hi) return;
  const int col = col0 + j;
  const bool copy = col < S && (all || (col + kW > lo && col < hi));
#pragma unroll 4
  for (int d = tid / G::per_row; d < Dp; d += G::rows_a_pass) {
    CT* kd = kt + d * P + j;
    CT* vd = vt + d * P + j;
    if (copy && d < D) {
      const size_t g = (size_t)d * S + col;
      if constexpr (kW == 4) {
        cp_async4(kd, kp + g);
        if (with_v) cp_async4(vd, vp + g);
      } else {
        *kd = kp[g];
        if (with_v) *vd = vp[g];
      }
    } else {
      zero<kW>(kd);
      if (with_v) zero<kW>(vd);
    }
  }
}

// After the copies of stage() have landed (this thread's own): the columns
// of a copied group outside [lo, hi) are zeroed in V, so that P*V, which
// multiplies them by p = 0, meets finite values.  (K needs no zeros: its
// masked scores are selected out.)
template <typename CT, int kW>
__device__ __forceinline__ void patch(CT* vt, int D, int S, int col0,
                                      int j_lo, int j_hi, int lo, int hi,
                                      bool all, int tid) {
  using G = Groups<kW>;
  constexpr int P = tile_pitch<CT>();
  const int j = (tid % G::per_row) * kW;
  if (j < j_lo || j >= j_hi) return;
  const int col = col0 + j;
  const bool copy = col < S && (all || (col + kW > lo && col < hi));
  if (!copy || (col >= lo && col + kW <= hi)) return;
  for (int d = tid / G::per_row; d < D; d += G::rows_a_pass)
#pragma unroll
    for (int e = 0; e < kW; ++e)
      if (col + e < lo || col + e >= hi) zero<1>(vt + d * P + j + e);
}

// -- fragments ---------------------------------------------------------------

// S's B fragments for keys js .. js + 15 (two n-tiles) and d kk .. kk + 15
// of the [D][keys] K tile: (k = d, n = key), the transpose of its layout
__device__ __forceinline__ void k_frags(uint32_t (&b)[4],
                                        const __nv_bfloat16* kt, int kk,
                                        int js, int lane) {
  constexpr int P = tile_pitch<__nv_bfloat16>();
  ldmatrix_x4_trans(b, kt + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * P
                           + js + (lane >> 4) * 8);
}
__device__ __forceinline__ void k_frags(uint32_t (&b)[4], const int8_t* kt,
                                        int kk, int js, int lane) {
  constexpr int P = tile_pitch<int8_t>();
  const int d = kk + (lane & 3) * 2, key = js + (lane >> 2);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int8_t* c = kt + d * P + key + 8 * t;
    b[2 * t] = pack_bf16((float)c[0], (float)c[P]);
    b[2 * t + 1] = pack_bf16((float)c[8 * P], (float)c[9 * P]);
  }
}

// S's B fragment for the one n-tile of keys js .. js + 7 (the fresh key's
// column and the padding past it)
__device__ __forceinline__ void k_frag8(uint32_t (&b)[2],
                                       const __nv_bfloat16* kt, int kk,
                                       int js, int lane) {
  constexpr int P = tile_pitch<__nv_bfloat16>();
  ldmatrix_x2_trans(b, kt + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * P
                           + js);
}
__device__ __forceinline__ void k_frag8(uint32_t (&b)[2], const int8_t* kt,
                                       int kk, int js, int lane) {
  constexpr int P = tile_pitch<int8_t>();
  const int8_t* c = kt + (kk + (lane & 3) * 2) * P + js + (lane >> 2);
  b[0] = pack_bf16((float)c[0], (float)c[P]);
  b[1] = pack_bf16((float)c[8 * P], (float)c[9 * P]);
}

// P*V's B fragments for d dn .. dn + 15 (two n-tiles) and keys ks .. ks + 15
// of the [D][keys] V tile: (k = key, n = d), its own layout
__device__ __forceinline__ void v_frags(uint32_t (&b)[4],
                                        const __nv_bfloat16* vt, int dn,
                                        int ks, int lane) {
  constexpr int P = tile_pitch<__nv_bfloat16>();
  ldmatrix_x4(b, vt + (dn + (lane & 7) + (lane >> 4) * 8) * P + ks
                     + ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ void v_frags(uint32_t (&b)[4], const int8_t* vt,
                                        int dn, int ks, int lane) {
  constexpr int P = tile_pitch<int8_t>();
  const int key = ks + (lane & 3) * 2;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int8_t* r = vt + (dn + 8 * t + (lane >> 2)) * P + key;
    b[2 * t] = pack_bf16((float)r[0], (float)r[1]);
    b[2 * t + 1] = pack_bf16((float)r[8], (float)r[9]);
  }
}

// Shared memory: the fp32 area, then q [16][Dp + 8] bf16, the K and V
// tiles [Dp][pitch] (K's column kChunk, in the padding, holds the fresh
// key), P [16][kChunk + 8] bf16.  In floats, then bytes.
__host__ __device__ __forceinline__ int f32_floats(int Dp, int splits) {
  return 2 * kWarps * kRows            // red_max, red_l
         + kRows + Dp                  // sf_s, fv_s
         + 2 * kMaxSplits * kRows      // max_s, l_s
         + 3 * kRows                   // tm_s (rank 0's terms)
         + (splits > 1 ? splits * kRows * Dp : 0);  // ctx_s (rank 0)
}
template <typename CT>
__host__ __device__ __forceinline__ size_t smem_bytes(int Dp, int splits) {
  return sizeof(float) * (size_t)f32_floats(Dp, splits)
         + sizeof(__nv_bfloat16) * (size_t)kRows * (Dp + 8)
         + sizeof(CT) * 2 * (size_t)Dp * tile_pitch<CT>()
         + sizeof(__nv_bfloat16) * (size_t)kRows * (kChunk + 8);
}

template <typename CT, int kW>
__global__ void __launch_bounds__(kThreads, 1)
gqa_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [B,H,D]
                            const CT* __restrict__ cache,  // [L,B,2,Hkv,D,S]
                            int layer, int B, int Hkv, int rep, int D, int S,
                            int W, const int* __restrict__ seq_len,  // [B]
                            const int* __restrict__ start,   // [B] or null
                            const float* __restrict__ kscale_ptr,
                            float scale,
                            const CT* __restrict__ fresh_k,  // [B,Hkv,D]
                            const CT* __restrict__ fresh_v,  // or null
                            __nv_bfloat16* __restrict__ out) {
  constexpr int P = tile_pitch<CT>();
  constexpr int PP = kChunk + 8;                 // pitch of the P tile
  const int n_rt = (rep + kRows - 1) / kRows;
  const int kv = blockIdx.x / n_rt, rt = blockIdx.x - kv * n_rt;
  const int b = blockIdx.y;
  const int splits = gridDim.z;
  const int rank = splits > 1 ? cluster_rank() : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = Hkv * rep, Dp = (D + 15) & ~15, QP = Dp + 8;
  const int rows = min(kRows, rep - rt * kRows);  // live query heads

  extern __shared__ __align__(16) float smem[];
  float* const red_max = smem;                   // [kWarps][16]
  float* const red_l = red_max + kWarps * kRows; // [kWarps][16]
  float* const sf_s = red_l + kWarps * kRows;    // [16] fresh scores
  float* const fv_s = sf_s + kRows;              // [Dp] fresh V
  float* const max_s = fv_s + Dp;                // [kMaxSplits][16]
  float* const l_s = max_s + kMaxSplits * kRows; // [kMaxSplits][16]
  float* const tm_s = l_s + kMaxSplits * kRows;  // [3][16]
  float* const ctx_s = tm_s + 3 * kRows;         // [splits][16][Dp]
  __nv_bfloat16* const q_s =
      reinterpret_cast<__nv_bfloat16*>(smem + f32_floats(Dp, splits));
  CT* const k_t = reinterpret_cast<CT*>(q_s + kRows * QP);  // [Dp][P]
  CT* const v_t = k_t + Dp * P;                             // [Dp][P]
  __nv_bfloat16* const p_s = reinterpret_cast<__nv_bfloat16*>(v_t + Dp * P);
  // [0]: every block's max has landed in max_s; [1], rank 0: every
  // block's partial context and sum have landed in ctx_s and l_s
  __shared__ __align__(8) uint64_t bars[2];

  if (splits > 1) {
    if (tid == 0) {
      mbar_init(&bars[0], 1);
      mbar_init(&bars[1], 1);
      mbar_expect_tx(&bars[0], splits * kRows * 4);
      if (rank == 0) mbar_expect_tx(&bars[1], splits * (rows * D + kRows) * 4);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_arrive_relaxed();
  }

  const bool with_fresh = fresh_k != nullptr;
  const int c_begin = rank * W;
  const size_t head = (size_t)D * S;
  const CT* kp = cache + ((((size_t)layer * B + b) * 2) * Hkv + kv) * head;
  const CT* vp = kp + (size_t)Hkv * head;
  // one block and one round: the columns are copied before the lengths
  // are known, in the round of q's loads
  const bool eager = splits == 1 && S <= kChunk;
  const int s16 = (S + 15) & ~15;
  if (eager)
    stage<CT, kW>(k_t, v_t, kp, vp, true, D, Dp, S, 0, 0, s16, 0, 0, true,
                  tid);

  const int seq = seq_len[b];
  const int lo = start ? max(start[b], 0) : 0;
  const float kscale = kscale_ptr ? *kscale_ptr : 1.0f;
  const float sk = scale * kscale;
  // q (query heads kv * rep + rt * 16 + r) as bf16 [16][QP], zero past the
  // live heads and past D; the fresh K into K's column kChunk, the fresh V
  // in fp32.  Every load is issued before the first store, so that they
  // form one round
  const __nv_bfloat16* qb = q + ((size_t)b * H + kv * rep + rt * kRows) * D;
  constexpr int kQ = kRows * kMaxD / kThreads;   // q elements a thread
  __nv_bfloat16 qv[kQ];
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int i = tid + u * kThreads, r = i / Dp, d = i - r * Dp;
    qv[u] = r < rows && d < D ? qb[r * D + d] : __float2bfloat16(0.f);
  }
  const size_t f0 = ((size_t)b * Hkv + kv) * D;
  const bool fd = with_fresh && tid < D;
  CT fk, fv;
  if (fd) {
    fk = fresh_k[f0 + tid];
    fv = fresh_v[f0 + tid];
  }
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int i = tid + u * kThreads, r = i / Dp, d = i - r * Dp;
    if (r < kRows) q_s[r * QP + d] = qv[u];
  }
  if (tid < Dp) {
    if (fd) k_t[tid * P + kChunk] = fk;
    else zero<1>(k_t + tid * P + kChunk);
    fv_s[tid] = fd ? to_f(fv) : 0.f;
  }

  // this block's valid columns [lo_b, hi_b), its rounds c_first..c_last
  const int cache_len = min(seq - (with_fresh ? 1 : 0), S);
  const int lo_b = max(lo, c_begin), hi_b = min(cache_len, c_begin + W);
  const int c_first = lo_b < hi_b ? (lo_b - c_begin) / kChunk : 0;
  const int c_last = lo_b < hi_b ? (hi_b - 1 - c_begin) / kChunk : -1;
  const bool single = c_last <= c_first;

  const int js = warp * 16;            // this warp's columns in a round
  const int c2 = (lane & 3) * 2, ra = lane >> 2, rb = ra + 8;

  // the scores of this warp's 16 columns of round c: [n-tile][fragment],
  // scaled, the invalid columns at -1e30
  float s[2][4];
  auto scores = [&](int col0, bool live) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
    if (live) {
#pragma unroll
      for (int kk = 0; kk < kMaxD; kk += 16) {
        if (kk < Dp) {
          uint32_t a[4], bk[4];
          ldmatrix_x4(a, q_s + (lane & 15) * QP + kk + (lane >> 4) * 8);
          k_frags(bk, k_t, kk, js, lane);
          mma_bf16(s[0], a, bk[0], bk[1]);
          mma_bf16(s[1], a, bk[2], bk[3]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + js + 8 * t + c2 + (e & 1);
        s[t][e] = live && col >= lo_b && col < hi_b ? s[t][e] * sk : kNeg;
      }
  };
  // the fresh column's score, q . K (bf16 products, fp32 sums, as the
  // TPU kernel's fp32 product of the same values) times scale * kscale, by
  // the last warp, from K's column kChunk: an n-tile whose other 7 columns
  // are padding and are dropped
  auto fresh_score = [&]() {
    if (!with_fresh || warp != kWarps - 1) return;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kMaxD; kk += 16) {
      if (kk < Dp) {
        uint32_t a[4], bk[2];
        ldmatrix_x4(a, q_s + (lane & 15) * QP + kk + (lane >> 4) * 8);
        k_frag8(bk, k_t, kk, kChunk, lane);
        mma_bf16(f, a, bk[0], bk[1]);
      }
    }
    if ((lane & 3) == 0) {
      sf_s[ra] = f[0] * sk;
      sf_s[rb] = f[2] * sk;
    }
  };
  // round c's columns relative to its start that hold a valid one
  auto span = [&](int c, int& col0, int& j_lo, int& j_hi) {
    col0 = c_begin + c * kChunk;
    j_lo = max(lo_b - col0, 0) & ~15;
    j_hi = min((hi_b - col0 + 15) & ~15, kChunk);
  };

  // 1. the scores and the row max, round by round (one round: K and V
  // staged together, the scores kept for P)
  float m_a = kNeg, m_b = kNeg;
  for (int c = c_first; c <= c_last; ++c) {
    int col0, j_lo, j_hi;
    span(c, col0, j_lo, j_hi);
    if (!eager) {
      if (c > c_first) __syncthreads();          // k_t consumed
      stage<CT, kW>(k_t, v_t, kp, vp, single, D, Dp, S, col0, j_lo, j_hi,
                    lo_b, hi_b, false, tid);
    }
    cp_async_wait_all();
    if (single)
      patch<CT, kW>(v_t, D, S, col0, j_lo, j_hi, lo_b, hi_b, eager, tid);
    __syncthreads();                             // the round has landed
    if (c == c_first) fresh_score();
    scores(col0, js >= j_lo && js < j_hi);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      m_a = fmaxf(m_a, fmaxf(s[t][0], s[t][1]));
      m_b = fmaxf(m_b, fmaxf(s[t][2], s[t][3]));
    }
  }
  if (c_last < c_first) {                        // no round
    cp_async_wait_all();
    __syncthreads();                             // q and the fresh K/V
    fresh_score();
  }
  m_a = quad_max(m_a);
  m_b = quad_max(m_b);
  if ((lane & 3) == 0) {
    red_max[warp * kRows + ra] = m_a;
    red_max[warp * kRows + rb] = m_b;
  }
  __syncthreads();                               // the warps' maxima
  m_a = red_max[ra];
  m_b = red_max[rb];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    m_a = fmaxf(m_a, red_max[w * kRows + ra]);
    m_b = fmaxf(m_b, red_max[w * kRows + rb]);
  }
  if (splits > 1) {
    // the block's max to every block of the cluster, by rank
    cluster_wait();                              // every block runs
    if (tid < kRows * splits) {
      const int r = tid % kRows;
      float mb = red_max[r];
      for (int w = 1; w < kWarps; ++w) mb = fmaxf(mb, red_max[w * kRows + r]);
      send(&max_s[rank * kRows + r], mb, &bars[0], tid / kRows);
    }
    mbar_wait(&bars[0], 0);                      // every block's max
    m_a = max_s[ra];
    m_b = max_s[rb];
    for (int r = 1; r < splits; ++r) {
      m_a = fmaxf(m_a, max_s[r * kRows + ra]);
      m_b = fmaxf(m_b, max_s[r * kRows + rb]);
    }
  }

  // 2. P against that max, rounded to bf16 (the sum takes it in fp32), and
  // P*V: warp w computes d 16 w .. 16 w + 15 over all the round's columns
  float o[2][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  float l_a = 0.f, l_b = 0.f;
  const int dn = 16 * warp;
  for (int c = c_first; c <= c_last; ++c) {
    int col0, j_lo, j_hi;
    span(c, col0, j_lo, j_hi);
    const bool live = js >= j_lo && js < j_hi;
    if (!single) {
      __syncthreads();                           // k_t, v_t, p_s consumed
      stage<CT, kW>(k_t, v_t, kp, vp, true, D, Dp, S, col0, j_lo, j_hi,
                    lo_b, hi_b, false, tid);
      cp_async_wait_all();
      patch<CT, kW>(v_t, D, S, col0, j_lo, j_hi, lo_b, hi_b, false, tid);
      __syncthreads();                           // the round has landed
      scores(col0, live);
    }
    if (live) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float p0 = s[t][0] > kNeg ? __expf(s[t][0] - m_a) : 0.f;
        const float p1 = s[t][1] > kNeg ? __expf(s[t][1] - m_a) : 0.f;
        const float p2 = s[t][2] > kNeg ? __expf(s[t][2] - m_b) : 0.f;
        const float p3 = s[t][3] > kNeg ? __expf(s[t][3] - m_b) : 0.f;
        l_a += p0 + p1;
        l_b += p2 + p3;
        const int col = js + 8 * t + c2;
        *reinterpret_cast<uint32_t*>(p_s + ra * PP + col) = pack_bf16(p0, p1);
        *reinterpret_cast<uint32_t*>(p_s + rb * PP + col) = pack_bf16(p2, p3);
      }
    }
    if (c == c_last) {
      l_a = quad_sum(l_a);
      l_b = quad_sum(l_b);
      if ((lane & 3) == 0) {
        red_l[warp * kRows + ra] = l_a;
        red_l[warp * kRows + rb] = l_b;
      }
    }
    __syncthreads();                             // P and the sums
    if (dn < Dp) {
      for (int ks = j_lo; ks < j_hi; ks += 16) {
        uint32_t a[4], bv[4];
        ldmatrix_x4(a, p_s + (lane & 15) * PP + ks + (lane >> 4) * 8);
        v_frags(bv, v_t, dn, ks, lane);
        mma_bf16(o[0], a, bv[0], bv[1]);
        mma_bf16(o[1], a, bv[2], bv[3]);
      }
    }
  }
  if (c_last < c_first) {                        // no round: no sums yet
    if ((lane & 3) == 0) {
      red_l[warp * kRows + ra] = 0.f;
      red_l[warp * kRows + rb] = 0.f;
    }
    __syncthreads();                             // the zero sums
  }

  // the denominator over the warps in order; per query head the fresh
  // column's terms: the rescale of the cached part, the fresh probability,
  // kscale / denominator; then the bf16 store of the live query heads
  struct Terms {
    float alpha, p_f, inv;
  };
  auto terms = [&](int r, float l, float m) {
    float alpha = 1.f, p_f = 0.f, denom = l;
    if (with_fresh) {
      const float s_f = sf_s[r];
      const float m_fin = fmaxf(m, s_f);
      alpha = __expf(m - m_fin);
      p_f = __expf(s_f - m_fin);
      denom = l * alpha + p_f;
    }
    return Terms{alpha, p_f, denom > 0.f ? kscale / denom : 0.f};
  };
  auto finish = [&](int r, int d, float acc, const Terms& t) {
    out[((size_t)b * H + kv * rep + rt * kRows + r) * D + d] =
        __float2bfloat16((acc * t.alpha + t.p_f * fv_s[d]) * t.inv);
  };
  auto row_sum = [&](int r) {
    float l = red_l[r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) l += red_l[w * kRows + r];
    return l;
  };
  if (splits == 1) {
    if (dn < Dp) {
      const Terms ta = terms(ra, row_sum(ra), m_a);
      const Terms tb = terms(rb, row_sum(rb), m_b);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = dn + 8 * t + c2 + e;
          if (d >= D) continue;
          if (ra < rows) finish(ra, d, o[t][e], ta);
          if (rb < rows) finish(rb, d, o[t][e + 2], tb);
        }
    }
    return;
  }
  // the partial context and sum to rank 0; a block other than rank 0 is
  // then done (every write into its shared memory, the maxima, has landed)
  if (dn < Dp) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = dn + 8 * t + c2 + e;
        if (d >= D) continue;
        if (ra < rows)
          send(&ctx_s[(rank * kRows + ra) * Dp + d], o[t][e], &bars[1], 0);
        if (rb < rows)
          send(&ctx_s[(rank * kRows + rb) * Dp + d], o[t][e + 2], &bars[1],
               0);
      }
  }
  if (tid < kRows) send(&l_s[rank * kRows + tid], row_sum(tid), &bars[1], 0);
  if (rank != 0) return;
  mbar_wait(&bars[1], 0);                        // every block's partials
  // rank 0: each query head's max and sum over the slices in rank order,
  // and its terms, once; then the contexts in rank order
  if (tid < rows) {
    float l = l_s[tid], m = max_s[tid];
    for (int k = 1; k < splits; ++k) {
      l += l_s[k * kRows + tid];
      m = fmaxf(m, max_s[k * kRows + tid]);
    }
    const Terms t = terms(tid, l, m);
    tm_s[tid] = t.alpha;
    tm_s[kRows + tid] = t.p_f;
    tm_s[2 * kRows + tid] = t.inv;
  }
  __syncthreads();                               // the terms
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    // the slices' loads issued together, then added in rank order
    float part[kMaxSplits];
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k)
      if (k < splits) part[k] = ctx_s[(k * kRows + r) * Dp + d];
    float acc = part[0];
#pragma unroll
    for (int k = 1; k < kMaxSplits; ++k)
      if (k < splits) acc += part[k];
    finish(r, d, acc, Terms{tm_s[r], tm_s[kRows + r], tm_s[2 * kRows + r]});
  }
}

template <typename CT>
int launch(const void* q, const void* cache, int layer, int B, int Hkv,
           int rep, int D, int S, int splits, int W, const int* seq_len,
           const int* start, const float* kscale, float scale,
           const void* fresh_k, const void* fresh_v, void* out,
           cudaStream_t st) {
  const int Dp = (D + 15) & ~15;
  const size_t smem = smem_bytes<CT>(Dp, splits);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool vec = S % 4 == 0;
  auto kernel = vec ? gqa_decode_attention_kernel<CT, 4>
                    : gqa_decode_attention_kernel<CT, 1>;
  // the shared memory each instantiation may take, raised once per size
  static size_t smem_allowed[2] = {48 * 1024, 48 * 1024};
  if (smem > smem_allowed[vec]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed[vec] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hkv * ((rep + kRows - 1) / kRows), B, splits);
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
      static_cast<const CT*>(cache), layer, B, Hkv, rep, D, S, W, seq_len,
      start, kscale, scale, static_cast<const CT*>(fresh_k),
      static_cast<const CT*>(fresh_v), static_cast<__nv_bfloat16*>(out));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Hkv*rep, D] bf16 (head h = kv*rep + g); cache [L, B, 2, Hkv, D, S]
// bf16 or int8; splits in [1, 8] (the wrapper's `gqa_splits(S)`) and W the
// columns of each block's slice (its `gqa_slice_width(S, splits)`: a
// multiple of 16, the slices covering S); seq_len [B] int32 counts the fresh
// token; start [B] int32 or null; kscale one fp32 or null; fresh_k/fresh_v
// [B, Hkv, D] in cache dtype or null; out [B, Hkv*rep*D] bf16.  One cluster
// launch.  Returns its CUDA error (0 = launched).
int gqa_decode_attention(const void* q, const void* cache, int cache_is_int8,
                         int layer, int B, int Hkv, int rep, int D, int S,
                         int splits, int W, const int* seq_len,
                         const int* start, const float* kscale, float scale,
                         const void* fresh_k, const void* fresh_v, void* out,
                         void* stream) {
  if (D < 1 || D > kMaxD || rep < 1 || rep > kMaxRep || S < 1 || Hkv < 1 ||
      B < 1 || B > 65535 || splits < 1 || splits > kMaxSplits || W < 16 ||
      W % 16 != 0 || (long long)splits * W < S ||
      (fresh_k == nullptr) != (fresh_v == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (cache_is_int8)
    return launch<int8_t>(q, cache, layer, B, Hkv, rep, D, S, splits, W,
                          seq_len, start, kscale, scale, fresh_k, fresh_v,
                          out, st);
  return launch<__nv_bfloat16>(q, cache, layer, B, Hkv, rep, D, S, splits,
                               W, seq_len, start, kscale, scale, fresh_k,
                               fresh_v, out, st);
}

}  // extern "C"
