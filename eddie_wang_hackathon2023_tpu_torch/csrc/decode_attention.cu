// Single-token decode attention over the stacked seq-minor KV cache, and
// the int8 weight-only out-projection GEMV that follows it.
//
// Replaces the TPU kernel eddie_wang_hackathon2023_tpu/ops/
// pallas_decode_attention.py:45 `_kernel` (entry `fused_decode_attention`,
// :767), in the modes the Whisper decode path uses: bf16 or int8 cache,
// per-tensor dequant scale, fresh K/V of the current token, start-index
// mask, and the int8 out-projection epilogue (:62-95).  The fp8 (e4m3)
// cache (the TPU kernel's `quant` over float8_e4m3fn, :863) is a third
// instantiation of each entry, over the type e4m3_t of e4m3.cuh: its bytes
// copied as int8's are (the same tiles, plans and splits), decoded exactly
// by cvt.rn.f16x2.e4m3x2 where int8's are by a byte permute, dequantised
// by the same kscale; a masked column is selected away, as every mode here
// does (pv_term, the beam entry's V masks), since an e4m3 byte may be NaN.
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
// Beam search (the TPU kernel's `_beam_kernel`, :213, assembled by
// `_beam_call` :320): query row b of group g = b / bw reads each cache
// position s from row g*bw + ind[b][s] of its group (ind is the [groups,
// bw, S] cache-indirection table), so the cache is never reordered.  Row
// g*bw speaks for the group's length and start; the fresh K/V is the row's
// own.  Numerics as the TPU kernel's: bf16 q times bf16 K (int8 converted
// exactly) summed in fp32, times scale * kscale; p against the max of ALL
// the row's cached columns (exchanged over the cluster), rounded to bf16
// for P*V while the denominator sums it in fp32; the fresh column, in full
// precision, after.  The first design ran one block per (head, query row),
// each reading its columns through the table by scalar loads in dependent
// rounds, so every source row of a group was read bw times.
// `beam_decode_attention_kernel` reads each source row of a group once for
// all its query beams (up to 16, the mma's m; a wider beam is cut into
// tiles of 16 query beams, each tile reading the group's rows once), as
// the TPU kernel does:
//   * grid (H, groups * tiles, splits * rs), cluster (1, 1, splits * rs):
//     the columns split as kernel 1 splits them (`decode_splits(S)` slices
//     of `split_width`), each walked in rounds of `cols` columns, times `rs`
//     splits of the group's source rows, so that a row's panels are copied
//     by one block and the copies of a group spread over up to 8 SMs (an
//     SM moves a few tens of GB/s from a cold cache); a block's rows are
//     staged `rows` at a time where all of them do not fit; the plan is the
//     wrapper's `beam_plan`, checked by the C entry;
//   * after one round of the lengths, q and the fresh K/V, each block
//     copies the valid columns of its slice of its source rows' K and the
//     table's columns (one cp.async group), then V (a second): 8 columns a
//     copy where S and the cache's start keep them on 8 elements' size,
//     else 4 where the start keeps 4 on theirs, else one (the cache's start
//     is any element); a d row of a source row is contiguous along s, so
//     the panels are [D][columns];
//   * the products on the tensor cores (`mma.sync m16n8k16`), the query
//     beams as the m, as the TPU kernel computes them: the scores of every
//     (query beam, source row), each (beam, column) keeping the one its
//     table names (`ldmatrix.trans` of the K panel, as in the grouped
//     kernel), one task a (16-column tile, source row) over the warps; P
//     of row j by warp j; then P*V once per source row with P masked by
//     the table (plain `ldmatrix` of the V panel), so the selection happens
//     in shared memory and registers, never in device memory;
//   * each row's max over the cluster by st.async into every block's
//     shared memory, counted on its mbarrier, before any p is formed; each
//     block's partial context and sum go to rank 0, which adds them in
//     rank order and adds the fresh column;
//   * a block with more than one round (of columns, or of its rows) walks
//     them twice (K for the max, then K and V for P and P*V), so P is still
//     rounded against the max of all columns.

// The TPU kernel ran its epilogue GEMV inside the same kernel from a VMEM
// panel.  A single block cannot read the 1.6 MB panel fast, so here it is a
// second kernel spread over the whole card, N and K alike (see the GEMV's
// note below): out[b, n] = (sum_k ctx[b, k] W[l, k, n]) * scale[n] +
// bias[n], with the context in bf16 and fp32 accumulation, as
// weight_only_quant_matmul does.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "e4m3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
constexpr float kNeg = -1e30f;
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
__device__ __forceinline__ float4 cols4(const e4m3_t* p) {
  return e4m3x4_to_float4(*reinterpret_cast<const uint32_t*>(p));
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
__device__ __forceinline__ void cp_async_cols(e4m3_t* dst,
                                              const e4m3_t* src) {
  cp_async_cols(reinterpret_cast<int8_t*>(dst),
                reinterpret_cast<const int8_t*>(src));
}
__device__ __forceinline__ void cp_async_cols(__nv_bfloat16* dst,
                                              const __nv_bfloat16* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// P*V's term for one column: a masked column (p == 0) adds nothing, even
// when its value is not finite (0 * inf or 0 * NaN would be NaN).  p is a
// bf16 value and v an int8, e4m3 or bf16 one, so the product is exact.
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
  // the out-projection GEMV launched behind this kernel may start now: it
  // loads its weights, then waits for this grid before it reads the
  // context (programmatic dependent launch; a no-op without one)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
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

// -- the beam entry: each source row of a group read once --------------------

// dynamic shared memory a block may take beside its static mbarriers
constexpr size_t kBeamMaxSmem = 226 * 1024;
constexpr int kBeamRows = 16;              // query beams a block: the mma's m
constexpr int kBeamMaxCols = 256;          // columns a round: 2 tiles a warp

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src));
}
// cc cache columns (8 or 4 by cp.async: 16 or 8 bytes of bf16, 8 or 4 of
// int8; 1 by a load and a store) copied to shared memory
__device__ __forceinline__ void copy_cols(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int cc) {
  if (cc == 8) cp_async16(dst, src);
  else if (cc == 4) cp_async_cols(dst, src);
  else *dst = *src;
}
__device__ __forceinline__ void copy_cols(int8_t* dst, const int8_t* src,
                                          int cc) {
  if (cc == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_u32(dst)), "l"(src));
  else if (cc == 4) cp_async_cols(dst, src);
  else *dst = *src;
}
__device__ __forceinline__ void copy_cols(e4m3_t* dst, const e4m3_t* src,
                                          int cc) {
  copy_cols(reinterpret_cast<int8_t*>(dst),
            reinterpret_cast<const int8_t*>(src), cc);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
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
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// over the four lanes of a quad (the lanes that share an mma row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Row pitch (elements) of a staged [D][cols] panel: 16-byte rows whose
// ldmatrix (bf16) or byte reads (int8) meet no bank conflict for cols a
// multiple of 16.
__host__ __device__ __forceinline__ int beam_pitch(int cols, int elem) {
  return elem == 2 ? cols + 8 : cols + 16;
}

// The scores' B fragments for columns js .. js + 15 (two n-tiles) and d
// kk .. kk + 15 of a [Dp][P] K panel: (k = d, n = column), its transpose
__device__ __forceinline__ void k_frags(uint32_t (&b)[4],
                                        const __nv_bfloat16* kt, int P,
                                        int kk, int js, int lane) {
  ldmatrix_x4_trans(b, kt + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * P
                           + js + (lane >> 4) * 8);
}
__device__ __forceinline__ void k_frags(uint32_t (&b)[4], const int8_t* kt,
                                        int P, int kk, int js, int lane) {
  const int d = kk + (lane & 3) * 2, col = js + (lane >> 2);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int8_t* c = kt + d * P + col + 8 * t;
    b[2 * t] = pack_bf16((float)c[0], (float)c[P]);
    b[2 * t + 1] = pack_bf16((float)c[8 * P], (float)c[9 * P]);
  }
}
__device__ __forceinline__ void k_frags(uint32_t (&b)[4], const e4m3_t* kt,
                                        int P, int kk, int js, int lane) {
  const int d = kk + (lane & 3) * 2, col = js + (lane >> 2);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const e4m3_t* c = kt + d * P + col + 8 * t;
    b[2 * t] = pack_bf16(to_f(c[0]), to_f(c[P]));
    b[2 * t + 1] = pack_bf16(to_f(c[8 * P]), to_f(c[9 * P]));
  }
}
// P*V's B fragments for d dn .. dn + 15 (two n-tiles) and columns ks ..
// ks + 15 of a [Dp][P] V panel: (k = column, n = d), its own layout
__device__ __forceinline__ void v_frags(uint32_t (&b)[4],
                                        const __nv_bfloat16* vt, int P,
                                        int dn, int ks, int lane) {
  ldmatrix_x4(b, vt + (dn + (lane & 7) + (lane >> 4) * 8) * P + ks
                     + ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ void v_frags(uint32_t (&b)[4], const int8_t* vt,
                                        int P, int dn, int ks, int lane) {
  const int col = ks + (lane & 3) * 2;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int8_t* r = vt + (dn + 8 * t + (lane >> 2)) * P + col;
    b[2 * t] = pack_bf16((float)r[0], (float)r[1]);
    b[2 * t + 1] = pack_bf16((float)r[8], (float)r[9]);
  }
}

// (e4m3: columns col, col + 1 are one 2-byte pair, col even)
__device__ __forceinline__ void v_frags(uint32_t (&b)[4], const e4m3_t* vt,
                                        int P, int dn, int ks, int lane) {
  const int col = ks + (lane & 3) * 2;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const e4m3_t* r = vt + (dn + 8 * t + (lane >> 2)) * P + col;
    const float2 a = e4m3x2_to_float2(*reinterpret_cast<const uint16_t*>(r));
    const float2 c =
        e4m3x2_to_float2(*reinterpret_cast<const uint16_t*>(r + 8));
    b[2 * t] = pack_bf16(a.x, a.y);
    b[2 * t + 1] = pack_bf16(c.x, c.y);
  }
}

// Takes n_bytes at offset `at` (kept 16-byte aligned); returns its offset.
__host__ __device__ inline size_t take(size_t& at, size_t n_bytes) {
  const size_t here = at;
  at += (n_bytes + 15) & ~(size_t)15;
  return here;
}

struct BeamSmem {
  size_t kt, vt, ind, sc, p, q, fk, fv, mrow, lrow, sf, max_s, l_s, red_c,
      ctx_s, bytes;
};

// The K and V panels [rows][Dp][pitch] of a round (`rows` of the block's
// source rows), the table's columns and the selected scores [qn][cols] of
// the block's (at most) qn query beams, P [16][cols + 8] and q [16][Dp + 8]
// in bf16, the fresh K/V [qn][D] fp32, each row's max, sum and fresh score,
// the cluster's maxima and sums by rank, each group of warps' partial
// contexts [kWarps / (Dp / 16)][16][Dp], and (with a cluster) rank 0's
// [splits][16][Dp].  ops/decode_attention.py `beam_smem_bytes` repeats
// this sum.
__host__ __device__ inline BeamSmem beam_layout(int qn, int rows, int D,
                                                int cols, int elem,
                                                int splits) {
  const int Dp = (D + 15) & ~15;
  BeamSmem s;
  size_t at = 0;
  const size_t panel = (size_t)rows * Dp * beam_pitch(cols, elem) * elem;
  s.kt = take(at, panel);
  s.vt = take(at, panel);
  s.ind = take(at, sizeof(int) * (size_t)qn * cols);
  s.sc = take(at, sizeof(float) * (size_t)qn * cols);
  s.p = take(at, 2 * (size_t)kBeamRows * (cols + 8));
  s.q = take(at, 2 * (size_t)kBeamRows * (Dp + 8));
  s.fk = take(at, sizeof(float) * (size_t)qn * D);
  s.fv = take(at, sizeof(float) * (size_t)qn * D);
  s.mrow = take(at, sizeof(float) * kBeamRows);
  s.lrow = take(at, sizeof(float) * kBeamRows);
  s.sf = take(at, sizeof(float) * kBeamRows);
  s.max_s = take(at, sizeof(float) * kMaxSplits * kBeamRows);
  s.l_s = take(at, sizeof(float) * kMaxSplits * kBeamRows);
  s.red_c = take(at, sizeof(float) * (kWarps / (Dp / 16)) * kBeamRows * Dp);
  s.ctx_s = take(at, splits > 1 ? sizeof(float) * splits * kBeamRows * Dp
                                : 0);
  s.bytes = at;
  return s;
}

// kWide: 8 cache columns a copy, fixed at compile time (the beam path's
// case; read from `cc` at run time it cost about 0.5 us a call on an
// H100); else `cc` (4 or 1) columns a copy
template <typename CT, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
beam_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [B,H,D]
                             const CT* __restrict__ cache,  // [L,B,2,H,D,S]
                             int layer, int H, int D, int S, int W, int cols,
                             int rs,            // row splits of the cluster
                             int rows,          // source rows staged a round
                             int cc,            // columns a copy: 8, 4, 1
                             const int* __restrict__ seq_len,       // [B]
                             const int* __restrict__ start,   // [B] or null
                             const float* __restrict__ kscale_ptr,
                             float scale,
                             const CT* __restrict__ fresh_k,      // [B,H,D]
                             const CT* __restrict__ fresh_v,
                             const int* __restrict__ ind,         // [B,S]
                             int bw,                        // beam width
                             __nv_bfloat16* __restrict__ out) {   // [B,H*D]
  constexpr int E = (int)sizeof(CT);
  // blockIdx.y = group * tiles + the block's tile of query beams
  const int tiles = (bw + kBeamRows - 1) / kBeamRows;
  const int grp = blockIdx.y / tiles, qt = blockIdx.y - grp * tiles;
  const int h = blockIdx.x, row0 = grp * bw, B = gridDim.y / tiles * bw;
  const int q0 = row0 + qt * kBeamRows;    // the block's first query row
  const int qn = min(kBeamRows, bw - qt * kBeamRows);  // its query beams
  const int splits = gridDim.z;            // the cluster's blocks
  const int rank = splits > 1 ? (int)cg::this_cluster().block_rank() : 0;
  // rank = column slice * rs + row split: the block's columns and its
  // source rows [r_lo, r_lo + nr) of the group, staged in n_rr rounds of
  // `rows`
  const int cs = rank / rs, ri = rank - cs * rs;
  const int r_lo = ri * bw / rs, nr = (ri + 1) * bw / rs - r_lo;
  const int n_rr = (nr + rows - 1) / rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Dp = (D + 15) & ~15, QP = Dp + 8, PP = cols + 8;
  const int nd = Dp / 16, ng = kWarps / nd;  // P*V: d tiles, warp groups
  const int P = beam_pitch(cols, E);
  const size_t rstride = (size_t)Dp * P;   // a source row's panel
  const BeamSmem sm = beam_layout(min(bw, kBeamRows), rows, D, cols, E,
                                  splits);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CT* const k_t = reinterpret_cast<CT*>(smem_raw + sm.kt);  // [rows][Dp][P]
  CT* const v_t = reinterpret_cast<CT*>(smem_raw + sm.vt);
  int* const ind_s = reinterpret_cast<int*>(smem_raw + sm.ind);  // [qn][cols]
  float* const sc_s = reinterpret_cast<float*>(smem_raw + sm.sc); // [qn][cols]
  __nv_bfloat16* const p_s =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + sm.p);         // [16][PP]
  __nv_bfloat16* const q_s =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + sm.q);         // [16][QP]
  float* const fk_s = reinterpret_cast<float*>(smem_raw + sm.fk);  // [qn][D]
  float* const fv_s = reinterpret_cast<float*>(smem_raw + sm.fv);
  float* const mrow = reinterpret_cast<float*>(smem_raw + sm.mrow);  // [16]
  float* const lrow = reinterpret_cast<float*>(smem_raw + sm.lrow);
  float* const sf_s = reinterpret_cast<float*>(smem_raw + sm.sf);
  float* const max_s = reinterpret_cast<float*>(smem_raw + sm.max_s);
  float* const l_s = reinterpret_cast<float*>(smem_raw + sm.l_s);
  float* const red_c = reinterpret_cast<float*>(smem_raw + sm.red_c);
  float* const ctx_s = reinterpret_cast<float*>(smem_raw + sm.ctx_s);
  // [0]: every block's row maxima have landed in max_s; [1], rank 0: every
  // block's partial contexts and sums have landed in ctx_s and l_s
  __shared__ __align__(8) uint64_t bars[2];

  if (splits > 1) {
    if (tid == 0) {
      mbar_init(&bars[0], 1);
      mbar_init(&bars[1], 1);
      mbar_expect_tx(&bars[0], splits * qn * 4);
      if (rank == 0) mbar_expect_tx(&bars[1], splits * qn * (D + 1) * 4);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_arrive_relaxed();
  }

  // one round: the group's length and start, kscale, q of the qn query
  // rows and, in rank 0, their fresh K/V (16 threads a row, a row a
  // thread's 16th), every load issued before any is stored
  const int total = seq_len[row0];
  const int lo = start ? max(start[row0], 0) : 0;
  const float kscale = kscale_ptr ? *kscale_ptr : 1.0f;
  const float sk = scale * kscale;
  const int qr = tid >> 4, qc = tid & 15;   // this thread's row, column
  constexpr int kQ = kMaxD / 16;
  __nv_bfloat16 qv[kQ];
  CT fkv[kQ], fvv[kQ];
  const size_t f0 = ((size_t)(q0 + qr) * H + h) * D;
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int d = qc + 16 * u;
    const bool in = qr < qn && d < D;
    qv[u] = in ? q[f0 + d] : __float2bfloat16(0.f);
    if (rank == 0 && in) {
      fkv[u] = fresh_k[f0 + d];
      fvv[u] = fresh_v[f0 + d];
    }
  }
  // K's rows past D zeroed (q's are zeros there, and 0 times a non-finite
  // value would be NaN)
  for (int i = tid; i < rows * (Dp - D) * P; i += kThreads) {
    const int r = i / ((Dp - D) * P), e = i - r * (Dp - D) * P;
    k_t[r * rstride + (size_t)D * P + e] = CT();
  }
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int d = qc + 16 * u;
    if (d < Dp) q_s[qr * QP + d] = qv[u];
    if (rank == 0 && qr < qn && d < D) {
      fk_s[qr * D + d] = to_f(fkv[u]);
      fv_s[qr * D + d] = to_f(fvv[u]);
    }
  }
  if (tid < kBeamRows) {
    mrow[tid] = kNeg;
    lrow[tid] = 0.f;
  }

  // this block's valid columns [lo_b, hi_b), its column rounds c_first ..
  // c_last; each with n_rr rounds of its rows, a pass p of (column round,
  // row round) pairs in that order
  const int cache_len = min(total - 1, S);
  const int c_begin = cs * W;
  const int lo_b = max(lo, c_begin), hi_b = min(cache_len, c_begin + W);
  const bool any = lo_b < hi_b;
  const int c_first = any ? (lo_b - c_begin) / cols : 0;
  const int c_last = any ? (hi_b - 1 - c_begin) / cols : -1;
  const int n_pairs = (c_last - c_first + 1) * n_rr;
  const bool single = n_pairs <= 1;
  const size_t head = (size_t)D * S;
  // pair p's column round c, its first column, its valid columns [va, vb)
  // from there, the 16-column tiles [ja, jb) that hold them, and its
  // source rows [t_lo, t_lo + tn)
  struct Pair {
    int c, t, col0, va, vb, ja, jb, t_lo, tn;
  };
  auto pair = [&](int p) {
    Pair x;
    x.c = c_first + p / n_rr;
    x.t = p - (p / n_rr) * n_rr;
    x.col0 = c_begin + x.c * cols;
    x.va = max(lo_b - x.col0, 0);
    x.vb = min(hi_b - x.col0, cols);
    x.ja = x.va & ~15;
    x.jb = (x.vb + 15) & ~15;
    x.t_lo = r_lo + x.t * rows;
    x.tn = min(rows, nr - x.t * rows);
    return x;
  };
  // pair x's valid columns of its source rows' K and, with its first rows,
  // the table's columns of the qn query rows (one copy group), then V (a
  // second)
  auto stage = [&](const Pair& x, bool with_v) {
    const int w = kWide ? 8 : cc;
    const int a = x.va & ~(w - 1), b = (x.vb + w - 1) & ~(w - 1);
    const int n = (b - a) / w;
    // tg threads (a power of 2, up to 32) take the copies of a d row; the
    // (source row, d) pairs advance by kThreads / tg a pass, the pointers
    // with them
    const int tg = n > 16 ? 32 : n > 8 ? 16 : n > 4 ? 8 : n > 2 ? 4 : n;
    const int step = kThreads / tg, gi = tid % tg;
    const int step_r = step / D, step_d = step - step_r * D;
    const size_t row_el = (size_t)2 * H * head;   // between cache rows
    auto panels = [&](CT* tile, size_t off) {
      int r = (tid / tg) / D, d = (tid / tg) - r * D;
      const CT* src = cache
                      + (((size_t)layer * B + row0 + x.t_lo + r) * 2 * H + h)
                            * head
                      + off + (size_t)d * S + x.col0 + a;
      CT* dst = tile + r * rstride + (size_t)d * P + a;
      while (r < x.tn) {
        for (int g = gi; g < n; g += tg)
          copy_cols(dst + w * g, src + w * g, w);
        r += step_r;
        d += step_d;
        src += step_r * row_el + (size_t)step_d * S;
        dst += step_r * rstride + (size_t)step_d * P;
        if (d >= D) {
          d -= D;
          ++r;
          src += row_el - (size_t)D * S;
          dst += rstride - (size_t)D * P;
        }
      }
    };
    panels(k_t, 0);
    if (x.t == 0) {
      const int a4 = x.va & ~3, n4 = (((x.vb + 3) & ~3) - a4) / 4;
      for (int it = tid; it < qn * n4; it += kThreads) {
        const int g = it % n4, j = it / n4;
        cp_async16(ind_s + j * cols + a4 + 4 * g,
                   ind + (size_t)(q0 + j) * S + x.col0 + a4 + 4 * g);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    if (with_v) panels(v_t, (size_t)H * head);
    asm volatile("cp.async.commit_group;\n" ::);   // (empty without V)
  };
  const int c2 = (lane & 3) * 2, ra = lane >> 2, rb = ra + 8;
  // q's A fragments, every k step
  uint32_t qa[kMaxD / 16][4];
  // the source row of query row j at column jc of the round, and whether
  // it is one of pair x's
  auto source = [&](int j, int jc) {
    return min(max(ind_s[j * cols + jc], 0), bw - 1);
  };
  auto own = [&](const Pair& x, int r) {
    return r >= x.t_lo && r < x.t_lo + x.tn;
  };
  // the scores of pair x: every (16-column tile, source row) a task of the
  // warps, on the tensor cores; each (row, column) of a tile keeps the
  // product of the source row its table names, scaled, in sc_s
  auto scores = [&](const Pair& x) {
    const int nt = (x.jb - x.ja) / 16;
    for (int k = warp; k < nt * x.tn; k += kWarps) {
      const int t = k / x.tn, rl = k - t * x.tn, r = x.t_lo + rl;
      const int js = x.ja + 16 * t;
      float acc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kMaxD / 16; ++kk) {
        if (kk < nd) {
          uint32_t bk[4];
          k_frags(bk, k_t + rl * rstride, P, 16 * kk, js, lane);
          mma_bf16(acc[0], qa[kk], bk[0], bk[1]);
          mma_bf16(acc[1], qa[kk], bk[2], bk[3]);
        }
      }
#pragma unroll
      for (int y = 0; y < 2; ++y)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? ra : rb, col = js + 8 * y + c2 + (e & 1);
          if (row < qn && source(row, col) == r)
            sc_s[row * cols + col] = acc[y][e] * sk;
        }
    }
  };

  // 1. the scores and each row's max, pair by pair (one pair: K and V
  // staged together, the scores kept for P); the max of row j by warp j
  __syncthreads();                     // q, the fresh K/V and the zeros
  if (any) stage(pair(0), single);
  // rank 0, while the copies land: the fresh column's score of row j,
  // q_j . K_j, by the warps from the last one
  if (rank == 0)
    for (int j = kWarps - 1 - warp; j < qn; j += kWarps) {
      float part = 0.f;
      for (int d = lane; d < D; d += 32)
        part += __bfloat162float(q_s[j * QP + d]) * fk_s[j * D + d];
      part = warp_sum(part);
      if (lane == 0) sf_s[j] = part * sk;
    }
#pragma unroll
  for (int kk = 0; kk < kMaxD / 16; ++kk)
    if (kk < nd)
      ldmatrix_x4(qa[kk], q_s + (lane & 15) * QP + 16 * kk + (lane >> 4) * 8);
  for (int p = 0; p < n_pairs; ++p) {
    const Pair x = pair(p);
    if (p > 0) {
      __syncthreads();                 // k_t, ind_s and sc_s consumed
      stage(x, false);
    }
    // K and the table (the older group); V may still be landing
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();                   // the pair's K has landed
    scores(x);
    __syncthreads();                   // the pair's scores
    for (int j = warp; j < qn; j += kWarps) {
      float m = kNeg;
      for (int jc = x.va + lane; jc < x.vb; jc += 32)
        if (own(x, source(j, jc))) m = fmaxf(m, sc_s[j * cols + jc]);
      m = warp_max(m);
      if (lane == 0) mrow[j] = fmaxf(mrow[j], m);
    }
  }
  __syncwarp();                        // mrow of the warp's rows
  if (splits > 1) {
    // each row's max to every block of the cluster, by rank
    cluster_wait();                    // every block runs
    for (int j = warp; j < qn; j += kWarps)
      if (lane < splits)
        send(&max_s[rank * kBeamRows + j], mrow[j], &bars[0], lane);
    mbar_wait(&bars[0], 0);            // every block's maxima
  }
  // the row's max over the cluster
  // (the blocks' values loaded together, then taken in rank order)
  auto row_max = [&](int j) {
    if (splits == 1) return mrow[j];
    float mx[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < splits) mx[r] = max_s[r * kBeamRows + j];
    float m = mx[0];
#pragma unroll
    for (int r = 1; r < kMaxSplits; ++r)
      if (r < splits) m = fmaxf(m, mx[r]);
    return m;
  };

  // 2. P of row j against that max by warp j, rounded to bf16 into the P
  // tile (the sum takes it in fp32), and P*V: warp w computes d tile
  // w % nd over the pair's source rows w / nd, w / nd + ng, ..., one
  // product a source row with P masked by the table
  float o[2][4] = {};
  const int dn = 16 * (warp % nd), rg = warp / nd;
  for (int p = 0; p < n_pairs; ++p) {
    const Pair x = pair(p);
    if (!single) {
      __syncthreads();                 // the panels, P and sc_s consumed
      stage(x, true);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();                 // the pair's K has landed
      scores(x);
      __syncthreads();                 // the pair's scores
    }
    for (int j = warp; j < qn; j += kWarps) {
      const float m = row_max(j);
      float l = 0.f;
      for (int jc = x.ja + 2 * lane; jc < x.jb; jc += 64) {
        const bool v0 = jc >= x.va && jc < x.vb && own(x, source(j, jc));
        const bool v1 = jc + 1 >= x.va && jc + 1 < x.vb
                        && own(x, source(j, jc + 1));
        const float p0 = v0 ? __expf(sc_s[j * cols + jc] - m) : 0.f;
        const float p1 = v1 ? __expf(sc_s[j * cols + jc + 1] - m) : 0.f;
        l += p0 + p1;
        *reinterpret_cast<uint32_t*>(p_s + j * PP + jc) = pack_bf16(p0, p1);
      }
      l = warp_sum(l);
      if (lane == 0) lrow[j] += l;
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();                   // P and the pair's V
    if (rg < ng) {
      for (int ks = x.ja; ks < x.jb; ks += 16) {
        uint32_t a[4];
        ldmatrix_x4(a, p_s + (lane & 15) * PP + ks + (lane >> 4) * 8);
        // the source rows of this lane's A fragment: rows ra, rb at
        // columns ks + c2 (+1) and ks + c2 + 8 (+1)
        int sr[4][2];
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int row = y & 1 ? rb : ra;
          const int jc = ks + c2 + (y >> 1) * 8;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sr[y][e] = row < qn ? source(row, jc + e) : -1;
        }
        // V's columns outside [va, vb) masked out of the B fragments (P is
        // 0 there, but the panel may hold anything, even a non-finite
        // value, and 0 times that would be NaN): the fragments' columns
        // are ks + c2 (+1) (registers 0, 2) and ks + c2 + 8 (+1) (1, 3)
        auto live = [&](int jc) { return jc >= x.va && jc < x.vb; };
        const uint32_t vm[2] = {
            (live(ks + c2) ? 0x0000ffffu : 0u)
                | (live(ks + c2 + 1) ? 0xffff0000u : 0u),
            (live(ks + c2 + 8) ? 0x0000ffffu : 0u)
                | (live(ks + c2 + 9) ? 0xffff0000u : 0u)};
        for (int rl = rg; rl < x.tn; rl += ng) {
          const int r = x.t_lo + rl;
          uint32_t mk[4], bv[4];
#pragma unroll
          for (int y = 0; y < 4; ++y)
            mk[y] = a[y] & ((sr[y][0] == r ? 0x0000ffffu : 0u)
                            | (sr[y][1] == r ? 0xffff0000u : 0u));
          v_frags(bv, v_t + rl * rstride, P, dn, ks, lane);
#pragma unroll
          for (int y = 0; y < 4; ++y) bv[y] &= vm[y & 1];
          mma_bf16(o[0], mk, bv[0], bv[1]);
          mma_bf16(o[1], mk, bv[2], bv[3]);
        }
      }
    }
  }
  // the warps' partial contexts, a slice a group of warps
  if (rg < ng) {
#pragma unroll
    for (int y = 0; y < 2; ++y)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? ra : rb, d = dn + 8 * y + c2 + (e & 1);
        red_c[(rg * kBeamRows + row) * Dp + d] = o[y][e];
      }
  }
  __syncthreads();                     // the partial contexts

  // the block's context of row j, d: its groups of warps in order
  auto block_ctx = [&](int j, int d) {
    float acc = red_c[j * Dp + d];
    for (int g = 1; g < ng; ++g) acc += red_c[(g * kBeamRows + j) * Dp + d];
    return acc;
  };
  // the output of row j, d: the context acc and sum l over the cluster, the
  // fresh column (the row's own K/V) and the normalisation
  auto finish = [&](int j, int d, float acc, float l) {
    const float m = row_max(j), s_f = sf_s[j];
    const float m_fin = fmaxf(m, s_f);
    const float alpha = __expf(m - m_fin), p_f = __expf(s_f - m_fin);
    l = l * alpha + p_f;
    out[((size_t)(q0 + j) * H + h) * D + d] = __float2bfloat16(
        (acc * alpha + p_f * fv_s[j * D + d]) * (l > 0.f ? kscale / l : 0.f));
  };
  if (splits == 1) {
    for (int i = tid; i < qn * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      finish(j, d, block_ctx(j, d), lrow[j]);
    }
    return;
  }
  // with a cluster: each block's partials to rank 0, which adds them in
  // rank order
  for (int i = tid; i < qn * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    send(&ctx_s[(rank * kBeamRows + j) * Dp + d], block_ctx(j, d), &bars[1],
         0);
  }
  if (tid < qn) send(&l_s[rank * kBeamRows + tid], lrow[tid], &bars[1], 0);
  // a block other than rank 0 is done: every write into its shared memory
  // (the maxima) has landed
  if (rank != 0) return;
  mbar_wait(&bars[1], 0);              // every block's partials
  for (int i = tid; i < qn * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    float cp[kMaxSplits], lp[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < splits) {
        cp[r] = ctx_s[(r * kBeamRows + j) * Dp + d];
        lp[r] = l_s[r * kBeamRows + j];
      }
    float acc = cp[0], l = lp[0];
#pragma unroll
    for (int r = 1; r < kMaxSplits; ++r)
      if (r < splits) {
        acc += cp[r];
        l += lp[r];
      }
    finish(j, d, acc, l);
  }
}

// -- the out-projection GEMV ------------------------------------------------
//
// out[b, n] = bf16((sum_k x[b, k] W[layer, k, n]) * scale[n] + bias[n]):
// the TPU kernel's epilogue (:62), a second launch here.  At the path's
// call ([1,1280] x [1280,1280] int8) it is a stream of 1.6 MB read once, so
// what costs is latency: the launch, each dependent round of loads, each
// barrier.  So the bytes are spread over the whole card and requested in
// one round.  A block owns kGemvCols (64) output columns and `rows`
// consecutive rows of K, the blocks of a thread-block cluster of
// `cluster` (1-8) ranks the rows of K in rank order (grid (cluster,
// N / 64, batch tiles), the wrapper's `gemv_plan`: at the path's call 20 x
// 6 = 120 blocks of 214 rows, 13.7 KB each).  Thread (warp, lane) takes
// the 16 columns 16 (lane % 4) of rows warp * 8 + lane / 4 + 32 i of the
// block's rows: one 16-byte load a row, a warp's loads 8 rows of 64
// contiguous bytes, every load of the block issued before any is used.
// The weights do not depend on the attention kernel before it, so the
// GEMV is launched as its programmatic dependent: it starts once that
// kernel's loads are in flight, requests its weights (and the scales and
// biases of its outputs), and waits for that kernel (`griddepcontrol`)
// only before it reads x.  The bytes become floats exactly (the byte xor
// 0x80 set into the mantissa of 2^23, minus 2^23 + 128) and accumulate in
// fp32 against x.  The sums then meet in a fixed order: the 8 lanes of a
// warp that share columns by a butterfly of shuffles (each lane keeps an
// eighth), the 4 warps through shared memory (one barrier), and the ranks
// in rank 0's shared memory by `st.async`, counted on its mbarrier; rank 0
// adds them in rank order, applies scale and bias and rounds once.  Up to
// 8 batch rows a block (`batch`: 1, 2, 4 or 8), more in further blocks
// along z.  Without 16-byte rows (N % 16 or an unaligned weight) each byte
// is loaded alone.
constexpr int kGemvCols = 64;
constexpr int kGemvThreads = 128;
constexpr int kGemvRowLanes = kGemvThreads / (kGemvCols / 16);   // 32
constexpr int kGemvMaxCluster = 8;

// mbar_wait that traps (a launch error) if the phase never completes,
// instead of hanging the card
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar,
                                                  uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > (1ll << 34)) __trap();     // some 10 s
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// byte i of w as a float, exactly: 2^23 + (b + 128) - (2^23 + 128)
template <int I>
__device__ __forceinline__ float byte_f(uint32_t wx) {
  return __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7440 | I)) -
         8388736.f;
}

template <int NB, bool kVec>
__global__ void __launch_bounds__(kGemvThreads)
out_proj_gemv_kernel(const __nv_bfloat16* __restrict__ x,   // [B, K]
                     const int8_t* __restrict__ w,          // [K, N]
                     const float* __restrict__ scale,       // [N]
                     const __nv_bfloat16* __restrict__ bias,  // [N] or null
                     __nv_bfloat16* __restrict__ out,       // [B, N]
                     int B, int K, int N, int rows) {
  // rows of loads a thread keeps in flight (registers: 4 a row, NB x)
  constexpr int kDepth = NB >= 4 ? 4 : 8;
  constexpr int kVals = 16 * NB;                 // a thread's sums
  __shared__ __align__(16) float red[4][4][kVals];      // [warp][cg][..]
  __shared__ float recv[kGemvMaxCluster - 1][4 * kVals];
  __shared__ __align__(8) uint64_t bar;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c16 = lane % 4, q = lane / 4;
  const int col = blockIdx.y * kGemvCols + 16 * c16;
  const int b0 = blockIdx.z * NB;
  const int r_end = min(K, (rank + 1) * rows);

  // the block's outputs: value v = tid + i * kGemvThreads is column
  // 16 (v / kVals) + v % 16, batch row (v % kVals) / 16 of the block's;
  // rank 0 asks for their scales and biases in the loads' round
  constexpr int kPer = (4 * kVals + kGemvThreads - 1) / kGemvThreads;
  float sc[kPer], bi[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int v = tid + i * kGemvThreads;
    const int n = blockIdx.y * kGemvCols + 16 * (v / kVals) + v % 16;
    const bool live = rank == 0 && v < 4 * kVals && n < N;
    sc[i] = live ? scale[n] : 0.f;
    bi[i] = live && bias ? __bfloat162float(bias[n]) : 0.f;
  }

  // a round: up to kDepth rows of the thread's, each one 16-byte load of
  // the weight, then each row's x
  uint4 wv[kDepth];
  uint32_t xv[kDepth][NB];                         // bf16 bits
  auto load_w = [&](int r0) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int k = r0 + kGemvRowLanes * d;
      const bool live = k < r_end && col < N;
      const int8_t* src = w + static_cast<size_t>(k) * N + col;
      if (kVec) {
        wv[d] = live ? __ldg(reinterpret_cast<const uint4*>(src))
                     : make_uint4(0, 0, 0, 0);
      } else {
        uint32_t u[4] = {0, 0, 0, 0};
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (live && col + e < N)
            u[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[e]))
                        << (8 * (e % 4));
        wv[d] = make_uint4(u[0], u[1], u[2], u[3]);
      }
    }
  };
  auto load_x = [&](int r0) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int k = r0 + kGemvRowLanes * d;
#pragma unroll
      for (int b = 0; b < NB; ++b)
        xv[d][b] = k < r_end && b0 + b < B
                       ? static_cast<uint32_t>(__bfloat16_as_ushort(
                             x[static_cast<size_t>(b0 + b) * K + k]))
                       : 0u;
    }
  };
  float acc[kVals];
#pragma unroll
  for (int i = 0; i < kVals; ++i) acc[i] = 0.f;
  auto fma = [&]() {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const uint32_t words[4] = {wv[d].x ^ 0x80808080u, wv[d].y ^ 0x80808080u,
                                 wv[d].z ^ 0x80808080u,
                                 wv[d].w ^ 0x80808080u};
      float f[16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[4 * j + 0] = byte_f<0>(words[j]);
        f[4 * j + 1] = byte_f<1>(words[j]);
        f[4 * j + 2] = byte_f<2>(words[j]);
        f[4 * j + 3] = byte_f<3>(words[j]);
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float xb = __uint_as_float(xv[d][b] << 16);
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[16 * b + e] += xb * f[e];
      }
    }
  };
  // the first round's weights before anything else (they do not depend on
  // the kernel this one may overlap), then x once that kernel is done
  int r0 = rank * rows + warp * 8 + q;
  load_w(r0);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  load_x(r0);
  if (csize > 1) {
    if (tid == 0 && rank == 0) {
      mbar_init(&bar, 1);
      mbar_expect_tx(&bar, static_cast<uint32_t>((csize - 1) * 4 * kVals *
                                                 sizeof(float)));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_arrive_relaxed();
  }
  for (;;) {
    fma();
    r0 += kGemvRowLanes * kDepth;
    if (r0 >= r_end) break;
    load_w(r0);
    load_x(r0);
  }

  // the 8 lanes of the warp that share these columns (lane bits 2-4): at
  // each level a lane keeps one half and receives its partner's share of
  // it; lane q keeps sums [q * 2NB, q * 2NB + 2NB) of its 16 NB
#pragma unroll
  for (int lv = 0; lv < 3; ++lv) {
    const int o = 16 >> lv, half = kVals >> (lv + 1);
    const bool upper = lane & o;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float keep = upper ? acc[half + i] : acc[i];
      const float give = upper ? acc[i] : acc[half + i];
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, give, o);
    }
  }
#pragma unroll
  for (int i = 0; i < 2 * NB; ++i) red[warp][c16][2 * NB * q + i] = acc[i];
  __syncthreads();
  // the block's sums, the warps in order: value v = (c16, b, e) of
  // red[.][c16][16 b + e]
  float mine[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int v = tid + i * kGemvThreads;
    if (v < 4 * kVals) {
      const float* r = &red[0][0][0] + v;
      mine[i] = ((r[0] + r[4 * kVals]) + r[8 * kVals]) + r[12 * kVals];
    }
  }
  if (csize > 1) {
    cluster_wait();
    if (rank != 0) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int v = tid + i * kGemvThreads;
        if (v < 4 * kVals) send(&recv[rank - 1][v], mine[i], &bar, 0);
      }
      return;
    }
    mbar_wait_bounded(&bar, 0);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int v = tid + i * kGemvThreads;
    if (v < 4 * kVals) {
      float s = mine[i];
      for (int r = 1; r < csize; ++r) s += recv[r - 1][v];
      const int n = blockIdx.y * kGemvCols + 16 * (v / kVals) + v % 16;
      const int b = (v % kVals) / 16;
      if (n < N && b0 + b < B)
        out[static_cast<size_t>(b0 + b) * N + n] =
            __float2bfloat16(s * sc[i] + bi[i]);
    }
  }
}

template <int NB, bool kVec>
int launch_gemv(const void* x, const int8_t* w, const float* scale,
                const void* bias, void* out, int B, int K, int N,
                int cluster, int rows, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (N + kGemvCols - 1) / kGemvCols,
                     (B + NB - 1) / NB);
  cfg.blockDim = dim3(kGemvThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // it may start while the kernel before it runs (its weights do not
  // depend on it); it waits for that kernel before it reads x
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, out_proj_gemv_kernel<NB, kVec>,
      static_cast<const __nv_bfloat16*>(x), w, scale,
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), B, K, N, rows);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int NB>
int dispatch_gemv(bool vec, const void* x, const int8_t* w,
                  const float* scale, const void* bias, void* out, int B,
                  int K, int N, int cluster, int rows, cudaStream_t st) {
  return vec ? launch_gemv<NB, true>(x, w, scale, bias, out, B, K, N,
                                     cluster, rows, st)
             : launch_gemv<NB, false>(x, w, scale, bias, out, B, K, N,
                                      cluster, rows, st);
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
                int D, int S, int splits, int W, int cols, int rs, int rows,
                const int* seq_len, const int* start, const float* kscale,
                float scale, const void* fresh_k, const void* fresh_v,
                const int* ind, int bw, void* out, cudaStream_t st) {
  const size_t smem = beam_layout(bw < kBeamRows ? bw : kBeamRows, rows, D,
                                  cols, (int)sizeof(CT), splits * rs).bytes;
  if (smem > kBeamMaxSmem) return (int)cudaErrorInvalidValue;
  // cache columns a copy: 8 where every row, slice and round keeps them on
  // their size, 4 where the cache's start keeps 4 on theirs (S and the
  // slices are multiples of 4), else 1
  const uintptr_t base = reinterpret_cast<uintptr_t>(cache);
  const int cc = S % 8 == 0 && W % 8 == 0 && base % (8 * sizeof(CT)) == 0
                     ? 8
                     : base % (4 * sizeof(CT)) == 0 ? 4 : 1;
  const bool wide = cc == 8;
  auto kernel = wide ? beam_decode_attention_kernel<CT, true>
                     : beam_decode_attention_kernel<CT, false>;
  // the shared memory each instantiation may take, raised once per size
  static size_t smem_allowed[2] = {48 * 1024, 48 * 1024};
  if (smem > smem_allowed[wide]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed[wide] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B / bw * ((bw + kBeamRows - 1) / kBeamRows),
                     splits * rs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits * rs;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(q),
      static_cast<const CT*>(cache), layer, H, D, S, W, cols, rs, rows, cc,
      seq_len, start, kscale, scale, static_cast<const CT*>(fresh_k),
      static_cast<const CT*>(fresh_v), ind, bw,
      static_cast<__nv_bfloat16*>(out));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One cluster launch: grid (H, B, splits), cluster (1, 1, splits), splits
// in [1, 8] (the wrapper's `decode_splits(S)`); the cache holds B rows, of
// kind 0 (bf16), 1 (int8) or 2 (e4m3).  Returns the launch's CUDA error
// (0 = launched).
int decode_attention(const void* q, const void* cache, int kind,
                     int layer, int B, int H, int D, int S,
                     int splits, const int* seq_len, const int* start,
                     const float* kscale, float scale, const void* fresh_k,
                     const void* fresh_v, void* out, void* stream) {
  if (D > kMaxD || S % 4 || splits < 1 || splits > kMaxSplits
      || (fresh_k == nullptr) != (fresh_v == nullptr) || kind < 0
      || kind > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (kind == 2)
    return launch_split<e4m3_t>(q, cache, layer, B, H, D, S, splits, seq_len,
                                start, kscale, scale, fresh_k, fresh_v, out,
                                st);
  return kind == 1
      ? launch_split<int8_t>(q, cache, layer, B, H, D, S, splits, seq_len,
                             start, kscale, scale, fresh_k, fresh_v, out, st)
      : launch_split<__nv_bfloat16>(q, cache, layer, B, H, D, S, splits,
                                    seq_len, start, kscale, scale, fresh_k,
                                    fresh_v, out, st);
}

// Beam search: B = groups * bw query rows over B cache rows, any bw (a
// block takes 16 query beams, the mma's m); ind [B, S] int32 (the [groups,
// bw, S] table, 16-byte aligned) holds beams in [0, bw); the cache may
// start on any element.  The fresh K/V is required.  The plan is the
// wrapper's `beam_plan`: `splits` column slices of `W` columns (a multiple
// of 4; the slices cover S), each walked in `rounds` = ceil(W / cols)
// rounds of `cols` columns (a multiple of 16, at most 256), times `rs`
// splits of the group's source rows (1 to bw), splits * rs blocks a
// cluster (at most 8), each block's rows staged `rows` at a time (1 to
// ceil(bw / rs)), the panels fitting in shared memory.  Any other plan is
// refused.  The cache's kind as decode_attention's.  One cluster launch;
// returns its CUDA error (0 = launched).
int beam_decode_attention(const void* q, const void* cache,
                          int kind, int layer, int B, int H, int D,
                          int S, int splits, int W, int cols, int rounds,
                          int rs, int rows,
                          const int* seq_len, const int* start,
                          const float* kscale, float scale,
                          const void* fresh_k, const void* fresh_v,
                          const int* ind, int bw, void* out, void* stream) {
  if (bw < 1 || B % bw ||
      (long long)(B / bw) * ((bw + kBeamRows - 1) / kBeamRows) > 65535 ||
      !fresh_k || !fresh_v || !ind || D < 1 || D > kMaxD || S < 4 || S % 4 ||
      splits < 1 || rs < 1 || rs > bw || splits * rs > kMaxSplits || W < 4 ||
      W % 4 ||
      (long long)splits * W < S || (long long)(splits - 1) * W >= S ||
      cols < 16 || cols % 16 || cols > kBeamMaxCols ||
      rounds != (W + cols - 1) / cols || rows < 1 ||
      rows > (bw + rs - 1) / rs || kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (kind == 2)
    return launch_beam<e4m3_t>(q, cache, layer, B, H, D, S, splits, W, cols,
                               rs, rows, seq_len, start, kscale, scale,
                               fresh_k, fresh_v, ind, bw, out, st);
  return kind == 1
      ? launch_beam<int8_t>(q, cache, layer, B, H, D, S, splits, W, cols, rs,
                            rows, seq_len, start, kscale, scale, fresh_k,
                            fresh_v, ind, bw, out, st)
      : launch_beam<__nv_bfloat16>(q, cache, layer, B, H, D, S, splits, W,
                                   cols, rs, rows, seq_len, start, kscale,
                                   scale, fresh_k, fresh_v, ind, bw, out,
                                   st);
}

// The out-projection GEMV.  x [B, K] bf16; w [L, K, N] int8, layer
// `layer`; scale fp32 [N]; bias bf16 [N] or null; out [B, N] bf16.  The
// plan (the wrapper's `gemv_plan`): a cluster of `cluster` blocks (1-8)
// along K for every 64 output columns, each `rows` rows of K (cluster *
// rows >= K > (cluster - 1) * rows), `batch` rows of x a block (1, 2, 4 or
// 8).  Returns the launch's CUDA error (0 = launched); any other plan is
// refused.
int out_proj_gemv(const void* x, const void* w, int layer,
                  const float* scale, const void* bias, void* out, int B,
                  int K, int N, int cluster, int rows, int batch,
                  void* stream) {
  if (B < 1 || K < 1 || N < 1 || layer < 0 || cluster < 1 ||
      cluster > kGemvMaxCluster || rows < 1 ||
      (long long)cluster * rows < K || (long long)(cluster - 1) * rows >= K ||
      (batch != 1 && batch != 2 && batch != 4 && batch != 8) ||
      (B + batch - 1) / batch > 65535 ||
      (N + kGemvCols - 1) / kGemvCols > 65535)
    return (int)cudaErrorInvalidValue;
  const int8_t* wl = static_cast<const int8_t*>(w) + (size_t)layer * K * N;
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(wl) % 16 == 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (batch) {
    case 1: return dispatch_gemv<1>(vec, x, wl, scale, bias, out, B, K, N,
                                    cluster, rows, st);
    case 2: return dispatch_gemv<2>(vec, x, wl, scale, bias, out, B, K, N,
                                    cluster, rows, st);
    case 4: return dispatch_gemv<4>(vec, x, wl, scale, bias, out, B, K, N,
                                    cluster, rows, st);
    default: return dispatch_gemv<8>(vec, x, wl, scale, bias, out, B, K, N,
                                     cluster, rows, st);
  }
}

}  // extern "C"
