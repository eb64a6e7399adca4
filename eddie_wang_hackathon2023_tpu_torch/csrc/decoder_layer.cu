// The whole decode step of a decoder (every layer) in ONE launch, at
// batch 1: Whisper's decoder (cross-attention; int8 or int4 weight-only
// panels, or bf16 panels) and the decoder-only families (GPT-2, OPT,
// LLaMA, GPT-J, GPT-NeoX: int8 weight-only or bf16 panels).
//
// Replaces the TPU kernel eddie_wang_hackathon2023_tpu/ops/
// pallas_decoder_layer.py:306 `_kernel` (entry `fused_decoder_stack`,
// :865) in these modes: LayerNorm or RMSNorm (no mean, no bias), the q/k/v,
// out, cross-q, cross-out, fc1 (and, gated, the gate) and fc2 GEMVs (int8
// weights with per-channel scales, or bf16 weights with unit scales),
// self-attention over the bf16 (or int8) seq-minor cache with the fresh
// token's K/V in fp32, keys below the start index masked, RoPE on q and
// the fresh k (GPT-NeoX halves or GPT-J interleaved pairs over the first
// rotary channels), cross-attention (optional) over the int8 (or bf16)
// cross cache with per-layer scales, the activation (tanh GELU, ReLU, erf
// GELU, SiLU), the gated MLP act(fc(x)) * gate(x), the sequential or the
// parallel residual (the MLP reads the input norm: x + attn + mlp) and
// the bf16 residual stream, at head dim 64 or 128.  It returns the hidden
// state before the final norm and every layer's fresh K/V in the self
// cache's type; it does not write the cache.
//
// The grouped (MQA/GQA) mode of the decoder-only set (the TPU kernel's
// `grouped`, :510-521 and :568-700): a self cache of Hkv KV heads under H
// query heads (rep = H / Hkv; SantaCoder / StarCoder's one KV head).  The
// qkv stage's items cover d + 2 dkv output columns (dkv = Hkv x head dim:
// q, then k, then v; its scales and biases are the packer's pair rows,
// k's and v's zero-padded to d each).  An attention item is still one
// query head h and a slice: it reads the K and V rows of KV head h / rep,
// so the rep items of a slice read the same rows (from L2 after the
// first); the fresh k and v come from qkv + d + (h / rep) D and qkv + d +
// dkv + (h / rep) D, the fresh k rotated in each head's finish, and the
// fresh K/V of a KV head are written once, by the finish of its group's
// first query head (v by the qkv stage's epilogue).  Whisper's set has
// Hkv = H and compiles the same code as before.
//
// The int8 self cache (the TPU kernel's `self_quant`, :523-554): the fresh
// K and V leave as int8, each value times the layer's kv_oq in fp32,
// rounded half away from zero and clipped to [-128, 127] (as
// ops/attention.py quantises a cache write), and the fresh column's score
// and value use those integers; the cache's columns and the fresh one are
// scaled by the layer's kv_qo where the cross cache takes its scale: the
// score times scale * kv_qo, the context times kv_qo at the end.  Each
// (cross, self, weight, head dim) type set is its own instantiation; the
// decoder-only set (MEGA_DECODER_ONLY) and the Whisper set (with
// cross-attention: int8, int4 or bf16 weights, chosen at run time) are
// built into two libraries from this file, in parallel.
//
// The fp8 self cache (the TPU kernel's `self_fp8`, :533-539, 554): the
// self cache's type is e4m3_t (e4m3.cuh); the fresh K and V leave as e4m3,
// each value times the layer's kv_oq in fp32, rounded by the saturating
// cvt.rn.satfinite.e4m3x2.f32, and the fresh column's score and value use
// the values stored (decoded back exactly), as a write and a read would
// give them; the cache's columns (decoded by cvt.rn.f16x2.e4m3x2, exact)
// and the fresh one are scaled by kv_qo as int8's are.  The e4m3
// instantiations of each set are built apart, into a library of their own
// (MEGA_SELF_E4M3), in parallel with the others, whose code is as it was
// without the macro.
//
// The int4 panels of Whisper's set (the TPU kernel's `w4`, :441-498): the
// tiles hold each column's K rows as nibbles, a 4-byte word 8 rows (nibble
// p row 2p, nibble p + 4 row 2p + 1, each the value plus 8, 0..15), so that
// (word >> 4p) & 0x000F000F | 0x43004300 is the bf16 pair 128 + 8 + value
// of rows 2p and 2p + 1, and one bf16 subtraction of 136 gives the values
// exactly (the sign extension of unpack_int4: [-8, 7]).  With group scales
// the item's bytes end with its columns' scales in bf16 ([c, K / G], as the
// TPU kernel rounds them to the activation type, :488), streamed through
// the ring with the weights; each value pair is multiplied by its group's
// scale in bf16 (the product rounded, as the TPU kernel's `plane * gs`),
// then the products with the input row are summed in fp32 (the group sums
// in another order than the TPU kernel's: fp32 rounding apart).  Per
// channel the scale is 1 and the per-channel scales ride the epilogue as
// int8's do.  Whisper's int8 and int4 items are whole (one load each, the
// epilogue's scale and bias in the finishing warps' registers); its bf16
// items (up to 102 KB at large-v2) are streamed in pieces as the
// decoder-only set's, the epilogue staged in shared memory.
//
// Bound: bytes.  A step reads the whole weight image once (14 d*d int8 a
// layer at large-v2, 734 MB; LLaMA-1B's 16 layers of bf16, 1.62 GB) plus
// the caches and does about 2 flops per weight.  The TPU kernel walked a
// (layer, stage) grid in order with the hidden state in VMEM and a ring
// of panel DMAs.  On Hopper the blocks of a grid run in parallel, so here:
//   * one persistent grid, one block per SM, all co-resident (cooperative
//     launch); a grid barrier separates dependent stages, 8 a layer with
//     cross-attention and 5 without: one `red.release.gpu` add a block on a
//     counter that only grows, then `ld.acquire.gpu` polls until it reaches
//     the grid times the barrier's index in the launch (no reset, no
//     second atomic);
//   * the weights are repacked once, at blob build (`megakernel_tiles`),
//     into item-contiguous tiles: a GEMV stage's output columns are cut
//     into `items` items of `c` columns by ALL of K, each item c rows of K
//     contiguous (the stage's weight transposed), one item a block (the
//     gated MLP's fc1 item is its c fc columns, then the same c gate
//     columns).  The plan (the wrapper's `megakernel_plan`: c, items and
//     the columns of a piece per stage) makes each stage about one wave
//     over the grid; the C entry checks it.  The sums are whole: the stage
//     after a GEMV reads one finished fp32 value an output;
//   * the weights do not depend on the activations, so each block streams
//     its own items of every stage, layer after layer, into a ring in
//     shared memory with `cp.async.bulk` (the TMA's 1D copy, completion
//     counted in bytes on one of 16 mbarriers), as far ahead as the ring
//     holds: the copies run on through barriers and the attention stages,
//     and a block waits on an mbarrier only when it needs the bytes.  An
//     item is streamed in pieces of whole columns of at most 64 KB (a
//     bf16 item at d 2048 is 192 KB, more than the 227 KB of shared
//     memory leaves for the ring), each its own load;
//   * a piece's GEMV: thread t takes 16-byte vectors t, t + 256, ... of the
//     piece (column-major: 16 int8 or 8 bf16 weights), each times the input
//     row's floats into a fresh fp32 sum (int8 -> float by a byte permute
//     into the mantissa of 2^23 and one subtraction; bf16 -> float by a
//     shift: both exact), written to shared memory; a warp then adds a
//     column's vectors in order.  The input row is kept with 4 floats of
//     padding every 32, so the 16-float reads of 8 threads fall on distinct
//     banks;
//   * the block that owns an item also applies its columns' epilogue (scale
//     and bias, requested at the stage's start: in Whisper's set held by
//     the warps that finish the columns, in the decoder-only set put in
//     shared memory before the GEMV; the activation after fc1, times the
//     gate's finished column when gated; the fresh V out after q/k/v) and
//     writes finished values: a stage after a GEMV reads one value an
//     output and no parameters;
//   * every block keeps the residual row in shared memory and recomputes
//     the norm and residual updates itself (identical arithmetic in every
//     block), which saves a barrier per update; under the parallel residual
//     the MLP's input is the input norm of the residual before the
//     attention's update, recomputed before that update is added;
//   * a stage is latency-bound (a dependent round trip to L2 or memory
//     costs about a microsecond), so each stage requests everything it
//     reads in one round, before it uses any of it: the residual's update
//     and the norm's parameters together; an attention item's q (and its
//     rotary partner) and its share of the keys together (then its share
//     of the values); a head's slices together;
//   * attention splits heads and 256-column slices of the cache over the
//     blocks, read in 4-byte words of 2 (bf16) or 4 (int8) columns; each
//     item writes its max, sum and P*V partial, and the last of a head's
//     items to finish (an arrival counter a head) combines the slices
//     (past 8, a cache longer than 2048 columns, which the decoder-only
//     set takes, it first folds the 8th and later ones into one),
//     rotates, quantises and writes the fresh K, adds the fresh token's
//     column and writes the head's context, so the stage after the barrier
//     reads one value an output;
//   * RoPE: the rotation of q and the fresh k needs pairs of columns that
//     other blocks' items finish, so it is applied where the attention
//     stage reads them: each attention item rotates its head's q, and the
//     head's last item the fresh k.  The angle is position x the rotary
//     frequency (fp32, `cosf`/`sinf`), the position max(write_index -
//     start, 0) with the start read from the device;
//   * before a barrier, a block asks L2 to prefetch what the stages after
//     it read from memory and not from another block: its next attention
//     item's K and V rows, the next norm's and epilogue's parameters;
//   * data written before a barrier is read after it with L1-bypassing
//     loads (__ldcg), so no block reads a stale line.
// Rounding points follow the TPU kernel: GEMV sums in fp32, scaled in
// fp32, rounded to bf16, plus the bias rounded to bf16 (:500-508,
// :765-766); the norms in fp32, rounded (:416-427); the residual in bf16;
// q and the fresh k rotated in fp32 and rounded (:383-394); P rounded to
// bf16 before P*V (:631-634); the cross context times kscale / denominator
// at the end (:641-647); the fresh self score and value in fp32
// (:700-746; with an int8 self cache (ctx * alpha * kscale + v * (kscale
// * pf)) / denominator, :740-743); the activation in fp32, rounded; the
// gate's product of two bf16 values rounded (:855-861); fc2's panels summed
// in fp32 before the scale (:797-809: an fc2 item spans all of its K).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "e4m3.cuh"

// the GEMV stages of a layer, in order (the gated MLP's gate rides the
// fc1 stage: its item holds the fc and gate columns)
enum Stage { kQkv = 0, kDense, kCrossQ, kCrossDense, kFc1, kFc2, kStages };

// the kernel's operands, filled by the Python wrapper (a ctypes Structure
// of the same layout) and passed by value
struct MegaArgs {
  const void* x;               // [d] bf16, embedded token (+ position)
  const void* tiles;           // [L, layer_bytes] item-contiguous weights
  const float* pair_scale;     // [L, nq, d]: q, k, v (, cross-q)
  const float* pair_bias;
  const float* flat_scale;     // [L, nflat, d]: dense (, cross-dense), fc1..
  const float* flat_bias;      // (, gate..), fc2
  const float* ln_par;         // [L, 2 n_ln, d]: weight, bias of each norm
  const void* self_cache;      // [L, 1, 2, Hkv, D, S] bf16, int8 or e4m3
  const void* cross_cache;     // [L, 1, 2, H, D, Sc] int8 or bf16, or null
  const float* cross_scale;    // [L] or null
  const float* kv_oq;          // [L] the quantised self cache's quantise and
  const float* kv_qo;          // dequantise scales (null for bf16)
  const int* seq_len;          // [1], including the fresh token
  const int* start;            // [1] the first key column, or null (0)
  const float* inv_freq;       // [rope_dim / 2] rotary frequencies, or null
  void* hid;                   // [d] bf16 out
  void* fresh;                 // [L, 2, Hkv, D] out, the self cache's type
  float* act_a;                // finished GEMV outputs: q, k, v (d + 2 dkv)
                               // / cross-q /
                               // act(fc1) (* gate)
  float* act_b;                // ... dense / cross-dense / fc2
  float* att;                  // attention partials [H, splits, D + 2]
  float* ctx;                  // [d] the attention stage's context row
  unsigned int* barrier;       // [1] zero: arrivals, only growing
  unsigned int* heads;         // [2, L, H] zeros: a head's slices done
  long long layer_bytes;       // bytes of one layer's tiles
  int n_layer, d, n_head, n_kv_head, head_dim, s_self, s_cross, nq, nflat,
      nf, n_ln;
  int f_dense, f_crossdense, f_fc1, f_gate, f_fc2;
  int with_cross, cross_int8;
  int self_kind;               // 0 bf16, 1 int8, 2 e4m3 (MEGA_SELF_E4M3)
  int weight_bf16;
  int norm_rms;                // 0: LayerNorm, 1: RMSNorm
  int act;                     // 0 tanh GELU, 1 ReLU, 2 erf GELU, 3 SiLU
  int gated, parallel;
  int rope_dim, rope_neox;     // rotated channels of a head (0: no RoPE)
  int write_index;             // the fresh token's cache column
  int ring_bytes;              // the plan's cap on the ring (0: none); the
                               // kernel gets the ring's size
  // the plan, per GEMV stage: columns of an item, items, rows of K, the
  // stage's byte offset in a layer's tiles, and the columns of a piece
  int item_c[kStages], items[kStages], item_k[kStages], tile_off[kStages];
  int piece_c[kStages];
  float scale, eps;
  int weight_int4;             // int4 panels (Whisper's set)
  int n_groups;                // their scale groups a panel (0: per channel)
};

namespace {

// the library's set: decoders without cross-attention (and their modes:
// RoPE, RMSNorm, the gated MLP, the other activations), or Whisper's
// decoder.  A set compiles only its own code: the kernel is latency-bound
// stage by stage and every stage runs from a cold instruction cache.
#ifdef MEGA_DECODER_ONLY
constexpr bool kDecoderOnly = true;
#else
constexpr bool kDecoderOnly = false;
#endif

// int4 weights, two a byte (the tiles' layout above): the weight type of
// the int4 instantiations
struct int4x2_t {
  uint8_t v;
};
template <typename WT>
constexpr bool kInt4 = std::is_same<WT, int4x2_t>::value;
// weights streamed in pieces, the epilogue staged in shared memory: the
// decoder-only set, and Whisper's bf16 panels
template <typename WT>
constexpr bool kPieced =
    kDecoderOnly || std::is_same<WT, __nv_bfloat16>::value;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = kThreads; // cache columns of one attention item
constexpr int kMaxHeads = 32;
constexpr int kMaxSplits = 8;    // slices a head's finish combines (more:
                                 // folded first, fold_slices)
constexpr int kSlots = 16;       // mbarriers of the weight ring
constexpr int kLayerStages = 8;  // a layer's stages, each ending in a barrier
// a d-row's elements a thread holds, and fc2's input row's (nf * d) in
// one round of loads: d <= 2048 and nf * d <= 6144 for the decoder-only
// set (up to 8192, SantaCoder-1B's, the rest in a second round), d <= 1280
// and ffn <= 5120 for Whisper's (each loop over them is unrolled: code
// size)
constexpr int kPer = kDecoderOnly ? 8 : 5;
constexpr int kPerFc = kDecoderOnly ? 24 : 20;
constexpr int kMaxFc = kDecoderOnly ? 8192 : kPerFc * kThreads;
constexpr int kColsWarp = 6;     // a piece's columns a warp sums
constexpr int kPieceCols = kWarps * kColsWarp;
// an item's columns: Whisper's items are whole pieces; the decoder-only
// set's up to 64 (8192 columns, SantaCoder-1B's fc1, over 128 SMs), in
// pieces of at most kPieceCols
constexpr int kItemCols = kDecoderOnly ? 64 : kPieceCols;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
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

// Grid-wide barrier of a co-resident grid: every block adds one to the
// counter (release: its writes before it), then polls (acquire) until the
// counter reaches gridDim.x times the barriers passed so far.
__device__ void grid_sync(unsigned int* bar, unsigned int& gen) {
  __syncthreads();
  gen += gridDim.x;
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(bar)
                 : "memory");
    unsigned int v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v) : "l"(bar) : "memory");
    } while (v < gen);
  }
  __syncthreads();
}

// the input row's float k sits at vpos(k): 4 floats of padding every 32
__device__ __forceinline__ int vpos(int k) { return k + ((k >> 5) << 2); }

// fp32 sum * fp32 scale, rounded, plus the bias rounded (bf16 arithmetic)
__device__ __forceinline__ float affine(float acc, float s, float b) {
  return bf16r(bf16r(acc * s) + bf16r(b));
}

// a fresh K/V value into the int8 self cache: times the layer's scale in
// fp32, rounded half away from zero, clipped (no fused multiply-add: the
// product is rounded before the half is added, as in ops/attention.py)
__device__ __forceinline__ float quant_kv(float v, float oq) {
  const float s = __fmul_rn(v, oq);
  return fminf(fmaxf(truncf(__fadd_rn(s, s >= 0.f ? .5f : -.5f)), -128.f),
               127.f);
}

// the activation after fc1, in fp32 (a: MegaArgs::act)
__device__ __forceinline__ float activate(float x, int a) {
  switch (a) {
    case 1: return fmaxf(x, 0.f);
    case 2: return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
    case 3: return x / (1.f + expf(-x));
    default:
      return 0.5f * x *
             (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
  }
}

// The residual update and the norm: xs[i] = bf16(xs[i] + delta[i]) (delta:
// a GEMV stage's finished output, or null), then vin = bf16(norm(xs) * w +
// b) at vpos, statistics in fp32 (RMSNorm: no mean; its packed bias rows
// are zeros).  With `after` the norm reads xs before the update (the
// parallel residual's MLP input).  The update and the parameters are
// requested in one round; thread t holds i = t + 256 k.
__device__ void residual_norm(const float* delta, bool after, const float* w,
                              const float* b, float* xs, float* vin, int d,
                              float eps, bool rms, float* red) {
  const int tid = threadIdx.x;
  float dv[kPer], wv[kPer], bv[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = tid + k * kThreads;
    if (i < d) {
      dv[k] = delta ? __ldcg(delta + i) : 0.f;
      wv[k] = __ldg(w + i);
      bv[k] = __ldg(b + i);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = tid + k * kThreads;
    if (i < d) {
      if (delta && !after) xs[i] = bf16r(xs[i] + dv[k]);
      s += xs[i];
    }
  }
  const float mean = rms ? 0.f : block_reduce<false>(s, red) / d;
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = tid + k * kThreads;
    if (i < d) {
      const float c = xs[i] - mean;
      v += c * c;
    }
  }
  const float r = rsqrtf(block_reduce<false>(v, red) / d + eps);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = tid + k * kThreads;
    if (i < d) {
      vin[vpos(i)] = bf16r((xs[i] - mean) * r * wv[k] + bv[k]);
      if (delta && after) xs[i] = bf16r(xs[i] + dv[k]);
    }
  }
  __syncthreads();
}

// -- the weight ring --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the block's loads of stage g: mats (the gated fc1 stage's fc, then its
// gate) x pieces of piece_c whole columns each, none for a block without
// an item or a stage the model does not have
__device__ __forceinline__ int stage_mats(const MegaArgs& a, int g) {
  return (int)blockIdx.x < a.items[g]
             ? (kDecoderOnly && g == kFc1 && a.gated ? 2 : 1) : 0;
}
template <typename WT>
__device__ __forceinline__ int stage_pieces(const MegaArgs& a, int g) {
  // Whisper's int8 and int4 items are whole (its plan; the C entry checks
  // it)
  if (!kPieced<WT> || a.piece_c[g] >= a.item_c[g]) return 1;
  return (a.item_c[g] + a.piece_c[g] - 1) / a.piece_c[g];
}
__device__ __forceinline__ int wbytes(const MegaArgs& a) {
  return a.weight_bf16 ? 2 : 1;
}
// an int4 item's bytes: its columns' nibbles, then their group scales in
// bf16 (K / G a column), padded to 16 bytes
__host__ __device__ __forceinline__ uint32_t int4_item_bytes(
    const MegaArgs& a, int g) {
  const int ngc = a.n_groups * (a.item_k[g] / a.d);
  return (uint32_t)(a.item_c[g] * a.item_k[g] / 2 +
                    (a.item_c[g] * ngc * 2 + 15) / 16 * 16);
}
// the K/V columns of the self-attention (Hkv x head dim; d in Whisper's
// set) and the query heads a KV head serves
__device__ __forceinline__ int kv_width(const MegaArgs& a) {
  return kDecoderOnly ? a.n_kv_head * a.head_dim : a.d;
}
__device__ __forceinline__ int kv_rep(const MegaArgs& a) {
  return kDecoderOnly ? a.n_head / a.n_kv_head : 1;
}
// column n of stage g's output as an index of its parameter rows: the qkv
// stage's v columns follow k's d-row pair row, not its dkv columns
__device__ __forceinline__ int param_col(const MegaArgs& a, int g, int n) {
  if (!kDecoderOnly || g != kQkv) return n;
  const int dkv = kv_width(a);
  return n < a.d + dkv ? n : n + a.d - dkv;
}
// piece p's columns and bytes
template <typename WT>
__device__ __forceinline__ int piece_cols(const MegaArgs& a, int g, int p) {
  if (!kPieced<WT>) return a.item_c[g];
  return min(a.piece_c[g], a.item_c[g] - p * a.piece_c[g]);
}
template <typename WT>
__device__ __forceinline__ uint32_t piece_bytes(const MegaArgs& a, int g,
                                                int p) {
  if constexpr (kInt4<WT>) return int4_item_bytes(a, g);
  return (uint32_t)(piece_cols<WT>(a, g, p) * a.item_k[g] * wbytes(a));
}

// Each block streams its pieces of every GEMV stage, in (layer, stage,
// matrix, piece) order, into a ring of `bytes` bytes.  Load i uses mbarrier
// i % kSlots, whose phase (i / kSlots) & 1 completes when its bytes have
// landed.  Every thread tracks the consumer's side identically; thread 0
// also starts the copies, walking the block's loads of a layer from a
// table in shared memory (`Loads`: each load's bytes and byte offset in a
// layer's tiles, made once at the start), layer after layer.
constexpr int kMaxLoads = 32;    // a block's loads in a layer, at most

struct Loads {
  uint32_t off[kMaxLoads], sz[kMaxLoads];
  int n;
};

template <typename WT>
__device__ void loads_init(const MegaArgs& a, Loads& t) {
  const int wb = wbytes(a);
  int n = 0;
  for (int g = 0; g < kStages; ++g) {
    const uint32_t item = kInt4<WT>
                              ? int4_item_bytes(a, g)
                              : (uint32_t)(a.item_c[g] * a.item_k[g] * wb);
    for (int m = 0; m < stage_mats(a, g); ++m)
      for (int p = 0; p < stage_pieces<WT>(a, g); ++p, ++n) {
        t.off[n] = a.tile_off[g] + (blockIdx.x * stage_mats(a, g) + m) * item +
                   p * a.piece_c[g] * a.item_k[g] * wb;
        t.sz[n] = piece_bytes<WT>(a, g, p);
      }
  }
  t.n = n;
}

struct Ring {
  int8_t* buf;
  uint64_t* bars;
  uint32_t bytes;
  uint32_t head, tail;         // bytes issued, bytes released (monotonic)
  int next, done;              // loads issued, loads released
  int l, i;                    // the cursor: the next load's layer and load
};

// thread 0: issue every load that fits (the ring's bytes and slots)
__device__ void ring_pump(const MegaArgs& a, const Loads& t, Ring& r) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  while (r.l < a.n_layer && r.next - r.done < kSlots) {
    const uint32_t sz = t.sz[r.i];
    if (r.head + sz - r.tail > r.bytes) break;
    const uint32_t bar = smem_u32(&r.bars[r.next % kSlots]);
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(sz) : "memory");
    const int8_t* src = static_cast<const int8_t*>(a.tiles) +
                        (size_t)r.l * a.layer_bytes + t.off[r.i];
    const uint32_t pos = r.head % r.bytes;
    const uint32_t first = min(sz, r.bytes - pos);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(r.buf + pos)),
        "l"(src), "r"(first), "r"(bar) : "memory");
    if (first < sz)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
          "bytes [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(r.buf)),
          "l"(src + first), "r"(sz - first), "r"(bar) : "memory");
    r.head += sz;
    ++r.next;
    if (++r.i == t.n) {
      r.i = 0;
      ++r.l;
    }
  }
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

// every thread: wait for the next load's bytes (sz of them; every load
// has some); returns its ring offset
__device__ __forceinline__ uint32_t ring_wait(Ring& r, uint32_t sz) {
  if (sz) mbar_wait(&r.bars[r.done % kSlots], (r.done / kSlots) & 1);
  return r.tail % r.bytes;
}

// every thread, after the block is done with the load: release its bytes;
// thread 0 refills the ring
__device__ __forceinline__ void ring_release(const MegaArgs& a,
                                             const Loads& t, Ring& r,
                                             uint32_t sz) {
  r.tail += sz;
  ++r.done;
  if (threadIdx.x == 0) ring_pump(a, t, r);
}

// -- the GEMV ---------------------------------------------------------------

// byte i of v as an exact float: its sign bit flipped gives b + 128, which
// the permute puts under the exponent of 2^23 (0x4B000000 | (b + 128))
__device__ __forceinline__ float int8_at(uint32_t flipped, int i) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7440 + i)) -
         8388736.f;
}

// one 16-byte vector of weights times the input row's floats at xv, fp32
__device__ __forceinline__ float vec_dot(const uint4 w, const float* xv,
                                         const int8_t*) {
  const uint32_t words[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                             w.z ^ 0x80808080u, w.w ^ 0x80808080u};
  const float4* x4 = reinterpret_cast<const float4*>(xv);
  // four chains of four products, then their sum: a short dependency
  float sq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 x = x4[q];
    float t = x.x * int8_at(words[q], 0);
    t = fmaf(x.y, int8_at(words[q], 1), t);
    t = fmaf(x.z, int8_at(words[q], 2), t);
    sq[q] = fmaf(x.w, int8_at(words[q], 3), t);
  }
  return (sq[0] + sq[1]) + (sq[2] + sq[3]);
}
__device__ __forceinline__ float vec_dot(const uint4 w, const float* xv,
                                         const __nv_bfloat16*) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  const float4* x4 = reinterpret_cast<const float4*>(xv);
  float sq[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float4 x = x4[q];
    float t = x.x * __uint_as_float(words[2 * q] << 16);
    t = fmaf(x.y, __uint_as_float(words[2 * q] & 0xFFFF0000u), t);
    t = fmaf(x.z, __uint_as_float(words[2 * q + 1] << 16), t);
    sq[q] = fmaf(x.w, __uint_as_float(words[2 * q + 1] & 0xFFFF0000u), t);
  }
  return sq[0] + sq[1];
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
  __nv_bfloat162 r;
  memcpy(&r, &u, 4);
  return r;
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

// one 16-byte vector of int4 weights (32 rows of K: word q rows 8q ..
// 8q + 7, pair p of it rows 8q + 2p and 8q + 2p + 1) times the input row's
// floats at xv, fp32; each pair's values (bf16, exact) times the group
// scale gs in bf16 (1 per channel: exact), the product rounded
__device__ __forceinline__ float vec_dot(const uint4 w, const float* xv,
                                         __nv_bfloat162 gs,
                                         const int4x2_t*) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  const float4* x4 = reinterpret_cast<const float4*>(xv);
  const __nv_bfloat162 k136 = __float2bfloat162_rn(136.f);
  float sq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 xa = x4[2 * q], xb = x4[2 * q + 1];
    const float xs[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
    float t = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t m = ((words[q] >> (4 * p)) & 0x000F000Fu) | 0x43004300u;
      const uint32_t u = as_u32(__hmul2(__hsub2(as_bf162(m), k136), gs));
      t = fmaf(xs[2 * p], __uint_as_float(u << 16), t);
      t = fmaf(xs[2 * p + 1], __uint_as_float(u & 0xFFFF0000u), t);
    }
    sq[q] = t;
  }
  return (sq[0] + sq[1]) + (sq[2] + sq[3]);
}

// the epilogue's parameters of stage g in layer l (matrix m: the gate of
// the gated fc1 stage): column n's scale is sc[n], its bias bi[n]
__device__ __forceinline__ void stage_params(const MegaArgs& a, int l, int g,
                                             int m, const float*& sc,
                                             const float*& bi) {
  const size_t pair = (size_t)l * a.nq * a.d;
  const size_t flat = (size_t)l * a.nflat * a.d;
  switch (g) {
    case kQkv: sc = a.pair_scale + pair; bi = a.pair_bias + pair; break;
    case kCrossQ:
      sc = a.pair_scale + pair + 3 * a.d;
      bi = a.pair_bias + pair + 3 * a.d;
      break;
    default: {
      const int f = g == kDense ? a.f_dense : g == kCrossDense
                        ? a.f_crossdense : g == kFc1 ? (m ? a.f_gate : a.f_fc1)
                        : a.f_fc2;
      sc = a.flat_scale + flat + (size_t)f * a.d;
      bi = a.flat_bias + flat + (size_t)f * a.d;
    }
  }
}

// The epilogue's scale and bias, requested at the stage's start so that
// no thread waits for them before the stage's own loads are out.
// Whisper's int8 and int4 items are whole: lane 0 of warp w holds those of
// its columns w + 8 i in registers (ws, wb).  The pieces (the decoder-only
// set's, Whisper's bf16 panels') and the gate move a column between warps:
// thread t < c * mats requests column t % c of matrix t / c (s, b) and puts
// it in shared memory just before the GEMV (epi_store: es[m][j], eb[m][j]).
struct Epi {
  float s, b;
  float ws[kColsWarp], wb[kColsWarp];
};

template <typename WT>
__device__ __forceinline__ void epi_fetch(const MegaArgs& a, int l, int g,
                                          int n_out, Epi& e) {
  const int c = a.item_c[g], tid = threadIdx.x;
  const float *sc, *bi;
  if constexpr (kPieced<WT>) {
    e.s = e.b = 0.f;
    if (tid < c * stage_mats(a, g)) {
      const int m = tid / c, n = blockIdx.x * c + tid % c;
      if (n < n_out) {
        stage_params(a, l, g, m, sc, bi);
        e.s = __ldg(sc + param_col(a, g, n));
        e.b = __ldg(bi + param_col(a, g, n));
      }
    }
  } else {
    const int warp = tid >> 5, col0 = blockIdx.x * c;
    stage_params(a, l, g, 0, sc, bi);
    if ((tid & 31) == 0 && (int)blockIdx.x < a.items[g]) {
#pragma unroll
      for (int i = 0; i < kColsWarp; ++i) {
        const int n = col0 + warp + kWarps * i;
        if (warp + kWarps * i < c && n < n_out) {
          e.ws[i] = __ldg(sc + n);
          e.wb[i] = __ldg(bi + n);
        }
      }
    }
  }
}

template <typename WT>
__device__ __forceinline__ void epi_store(const MegaArgs& a, int g,
                                          const Epi& e,
                                          float (*es)[kItemCols],
                                          float (*eb)[kItemCols]) {
  const int c = a.item_c[g], tid = threadIdx.x;
  if (kPieced<WT> && tid < c * stage_mats(a, g)) {
    es[tid / c][tid % c] = e.s;
    eb[tid / c][tid % c] = e.b;
  }
}

// The sums of one piece of the block's item of stage g: sum_k vin[k] W[k, j]
// for its columns (the piece's bytes at ring offset `off`, its columns' K
// contiguous, wrapping at the ring's end; an int4 item's group scales
// after its columns' weights; `part` holds a vector's sum each).  Lane 0
// of warp w gets column w + 8 i's sum in cs[i].
template <typename WT>
__device__ __forceinline__ void gemv_piece(const MegaArgs& a, const Ring& r,
                                           int g, int cols, uint32_t off,
                                           const float* vin, float* part,
                                           float* cs) {
  // weights a vector
  constexpr int kVals = kInt4<WT> ? 32 : 16 / (int)sizeof(WT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int vk = a.item_k[g] / kVals;
  const int nv = cols * vk;
  // v: the vector's place in its column (f % vk, kept by steps)
  const int v_step = kThreads % vk;
  int v = tid % vk;
  if constexpr (kInt4<WT>) {
    // j: the vector's column (f / vk, kept by steps); its group's scale
    // at `soff` + 2 (j ngc + v / vpg): ngc groups a column, vpg vectors a
    // group
    const int ngc = a.n_groups * (a.item_k[g] / a.d);
    const int vpg = ngc ? vk / ngc : 1;
    const uint32_t soff = off + (uint32_t)(cols * a.item_k[g] / 2);
    const int j_step = kThreads / vk;
    int j = tid / vk;
    const __nv_bfloat162 one = __float2bfloat162_rn(1.f);
#pragma unroll 1
    for (int f = tid; f < nv; f += kThreads) {
      uint32_t pos = off + 16u * f;
      if (pos >= r.bytes) pos -= r.bytes;
      const uint4 w = *reinterpret_cast<const uint4*>(r.buf + pos);
      __nv_bfloat162 gs = one;
      if (ngc) {
        uint32_t sp = soff + 2u * (j * ngc + v / vpg);
        if (sp >= r.bytes) sp -= r.bytes;
        gs = __bfloat162bfloat162(
            *reinterpret_cast<const __nv_bfloat16*>(r.buf + sp));
      }
      part[f] = vec_dot(w, vin + vpos(kVals * v), gs, (const WT*)nullptr);
      v += v_step;
      j += j_step;
      if (v >= vk) {
        v -= vk;
        ++j;
      }
    }
  } else {
    // not unrolled: an unrolled loop's registers spill elsewhere in the
    // kernel, which costs more than the loop gains
#pragma unroll 1
    for (int f = tid; f < nv; f += kThreads) {
      uint32_t pos = off + 16u * f;
      if (pos >= r.bytes) pos -= r.bytes;
      const uint4 w = *reinterpret_cast<const uint4*>(r.buf + pos);
      part[f] = vec_dot(w, vin + vpos(kVals * v), (const WT*)nullptr);
      v += v_step;
      if (v >= vk) v -= vk;
    }
  }
  __syncthreads();
  // a warp's columns side by side, so that their chains interleave; four
  // rounds of their loads at once (the sums in order)
#pragma unroll
  for (int i = 0; i < kColsWarp; ++i) cs[i] = 0.f;
#pragma unroll 4
  for (int t = lane; t < vk; t += 32) {
#pragma unroll
    for (int i = 0; i < kColsWarp; ++i)
      if (warp + kWarps * i < cols) cs[i] += part[(warp + kWarps * i) * vk + t];
  }
#pragma unroll
  for (int i = 0; i < kColsWarp; ++i) cs[i] = warp_sum(cs[i]);
}

// One GEMV stage: the block's item, piece by piece (the gated stage's fc
// pieces, then its gate pieces), each waited for, summed, finished and
// released.  The epilogue (lane 0 of a column's warp): out[n] =
// affine(sum, scale, bias); after fc1 its activation (held in `hold` when
// the gate follows, whose column then writes act * gate); after q/k/v the
// fresh V also to `fresh` (with an int8 self cache quantised, in `fresh`
// and in `out` alike).  All rounded to bf16.  The weights' type WT comes
// from the last argument, a null pointer of that type; `t` is the ring's
// table of loads.
template <typename WT>
__device__ void gemv_stage(const MegaArgs& a, Ring& r, int l, int g,
                           const float* vin, float* part, float* out,
                           int n_out, float (*es)[kItemCols],
                           float (*eb)[kItemCols], float* hold,
                           const Loads& t, const Epi& e, const WT*) {
  const int mats = stage_mats(a, g);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = a.item_c[g], pc = a.piece_c[g];
  const int col0 = blockIdx.x * c;
  const int dkv = kv_width(a);
  for (int m = 0; m < mats; ++m) {
    for (int p = 0; p < stage_pieces<WT>(a, g); ++p) {
      const int cols = piece_cols<WT>(a, g, p);
      const uint32_t sz = piece_bytes<WT>(a, g, p);
      const uint32_t off = ring_wait(r, sz);
      // the epilogue's parameters in registers before the sums
      float cs[kColsWarp], sc[kColsWarp], bi[kColsWarp];
#pragma unroll
      for (int i = 0; i < kColsWarp; ++i) {
        const int j = min(p * pc + warp + kWarps * i, kItemCols - 1);
        sc[i] = kPieced<WT> ? es[m][j] : e.ws[i];
        bi[i] = kPieced<WT> ? eb[m][j] : e.wb[i];
      }
      gemv_piece<WT>(a, r, g, cols, off, vin, part, cs);
#pragma unroll
      for (int i = 0; i < kColsWarp; ++i) {
        const int jl = warp + kWarps * i;
        const int j = p * pc + jl;
        const int n = col0 + j;
        if (lane != 0 || jl >= cols || n >= n_out) continue;
        float v = affine(cs[i], sc[i], bi[i]);
        if (g == kFc1) {
          if (m == 0) {
            v = bf16r(kDecoderOnly ? activate(v, a.act) : activate(v, 0));
            if (mats == 2) {
              hold[j] = v;        // the same thread finishes the gate's j
              continue;
            }
          } else {
            v = bf16r(hold[j] * v);
          }
        }
        if (g == kQkv && n >= a.d + dkv) {  // v: [L, 2, Hkv, D]
          const size_t f = ((size_t)l * 2 + 1) * dkv + n - (a.d + dkv);
#ifdef MEGA_SELF_E4M3
          // this library's self caches are all e4m3: the stored value
          const e4m3_t q8 = to_e4m3(__fmul_rn(v, __ldg(a.kv_oq + l)));
          v = to_f(q8);
          static_cast<e4m3_t*>(a.fresh)[f] = q8;
#else
          if (a.self_kind) {
            v = quant_kv(v, __ldg(a.kv_oq + l));
            static_cast<int8_t*>(a.fresh)[f] = (int8_t)v;
          } else {
            static_cast<__nv_bfloat16*>(a.fresh)[f] = __float2bfloat16(v);
          }
#endif
        }
        __stcg(out + n, v);
      }
      __syncthreads();
      ring_release(a, t, r, sz);
    }
  }
}

// -- prefetching the next stages' operands into L2 --------------------------

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// stage g of layer l: the epilogue's scale and bias of the block's item
// (both matrices of the gated stage) and, m >= 0, norm m's weight and bias
// (lines of 32 floats)
__device__ void prefetch_params(const MegaArgs& a, int l, int g, int m) {
  if (l >= a.n_layer) return;
  const int tid = threadIdx.x, c = a.item_c[g];
  for (int mat = 0; mat < stage_mats(a, g); ++mat) {
    const float *sc, *bi;
    stage_params(a, l, g, mat, sc, bi);
    if (32 * tid < c) {
      const int n = param_col(a, g, blockIdx.x * c + 32 * tid);
      prefetch_l2(sc + n);
      prefetch_l2(bi + n);
    }
  }
  if (m >= 0 && 32 * tid < 2 * a.d)
    prefetch_l2(a.ln_par + ((size_t)l * 2 * a.n_ln + 2 * m) * a.d + 32 * tid);
}

// the block's attention item of this stage (item blockIdx.x, if any): the
// HD rows of its K and V slice (of KV head h / rep of a cache of Hkv
// heads), in lines of 128 bytes
template <typename CT, int HD>
__device__ void prefetch_attn(const CT* cache, int l, int H, int Hkv, int rep,
                              int S, int n_cols, int nslices) {
  const int it = blockIdx.x;
  if (it >= H * nslices) return;
  const int h = it / nslices / rep, c0 = (it % nslices) * kSplit;
  const int n = min(n_cols, c0 + kSplit) - c0;
  constexpr int kPerLine = 128 / sizeof(CT);
  constexpr int kLines = kSplit / kPerLine;
  const size_t head = (size_t)HD * S;
  for (int i = threadIdx.x; i < HD * kLines; i += kThreads) {
    const int row = i / kLines, line = i % kLines;
    if (n <= 0 || line * kPerLine >= n) continue;
    const size_t off = (size_t)row * S + c0 + line * kPerLine;
    prefetch_l2(cache + ((size_t)l * 2 * Hkv + h) * head + off);
    prefetch_l2(cache + ((size_t)(l * 2 + 1) * Hkv + h) * head + off);
  }
}

// -- RoPE ---------------------------------------------------------------------

// The rotary position and frequencies of the step (rope_dim 0: none).
struct Rope {
  int dim, neox, pos;
  const float* inv_freq;
};

// Channel t (< HD) of a head rotated: x is its value, xp its partner's
// (t +- half, or t ^ 1 interleaved), both bf16 values; the result in fp32
// (x1 cos - x2 sin, x2 cos + x1 sin, products and sum not contracted).
__device__ __forceinline__ float rotate(const Rope& rp, int t, float x,
                                        float xp) {
  if (t >= rp.dim) return x;
  const int half = rp.dim / 2;
  const bool first = rp.neox ? t < half : (t & 1) == 0;
  const int i = rp.neox ? t % half : t / 2;
  const float ang = __fmul_rn((float)rp.pos, __ldg(rp.inv_freq + i));
  const float cs = cosf(ang), sn = sinf(ang);
  return first ? __fsub_rn(__fmul_rn(x, cs), __fmul_rn(xp, sn))
               : __fadd_rn(__fmul_rn(x, cs), __fmul_rn(xp, sn));
}
__device__ __forceinline__ int partner(const Rope& rp, int t) {
  if (t >= rp.dim) return t;
  return rp.neox ? (t < rp.dim / 2 ? t + rp.dim / 2 : t - rp.dim / 2)
                 : (t ^ 1);
}

// -- attention ----------------------------------------------------------------

// kVec cache elements of one 4-byte word as floats
__device__ __forceinline__ void word_f(uint32_t w, const __nv_bfloat16*,
                                       float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ void word_f(uint32_t w, const int8_t*, float* f) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = (float)(int8_t)(w >> (8 * e));
}
__device__ __forceinline__ void word_f(uint32_t w, const e4m3_t*, float* f) {
  const float4 v = e4m3x4_to_float4(w);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// One attention item: q ([HD] of q_src, rotated with a rotary step, then
// kept in q_s) against columns [c0, c1) of one head's K and V [HD, S], the
// columns below `start` masked; writes max, sum and P*V.  The cache is
// read in 4-byte words of kVec columns (2 bf16 or 4 int8; S and c0
// multiples of kVec).  Scores: thread t takes word t % (256 / kVec) of
// kVec row groups' rows (HD / kVec rows each, requested in rounds of at
// most 32), its q and the first round's keys requested together, and the
// groups' partial dots meet in `sp` (shared memory, kVec x 256 floats) in
// group order.  P*V: warp w takes rows w, w + 8, ..., a lane words lane,
// lane + 32, ...; the first 8 rows' values requested while the block
// reduces the scores.
template <typename CT, int HD, bool kRope>
__device__ void attn_item(const CT* __restrict__ kp, const CT* __restrict__ vp,
                          int S, int c0, int c1, int start, const float* q_src,
                          const Rope& rp, float qk_scale, float* q_s,
                          float* p_s, float* sp, float* red, float* out) {
  constexpr int kVec = 4 / sizeof(CT);        // columns a word
  constexpr int kWordsRow = kSplit / kVec;    // words of a 256-column row
  constexpr int kRowsG = HD / kVec;           // rows of a score group
  constexpr int kRound = kRowsG < 32 ? kRowsG : 32;  // rows a round
  constexpr int kRows = HD / kWarps;          // P*V rows a warp
  constexpr int kVRound = 8;                  // P*V rows a round
  constexpr int kWordsLane = kWordsRow / 32;  // P*V words a lane
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = c1 - c0;
  float qv = 0.f, qp = 0.f;
  if (tid < HD) {
    qv = __ldcg(q_src + tid);
    if (kRope && rp.dim) qp = __ldcg(q_src + partner(rp, tid));
  }
  const int wi = tid % kWordsRow, rg = tid / kWordsRow;
  const bool wlive = kVec * wi < n;
  float dot[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) dot[e] = 0.f;
#pragma unroll
  for (int r0 = 0; r0 < kRowsG; r0 += kRound) {
    uint32_t kw[kRound];
#pragma unroll
    for (int r = 0; r < kRound; ++r)
      kw[r] = wlive ? *reinterpret_cast<const uint32_t*>(
                          kp + (size_t)(rg * kRowsG + r0 + r) * S + c0 +
                          kVec * wi)
                    : 0u;
    if (r0 == 0) {
      if (tid < HD) {
        if constexpr (kRope) {
          if (rp.dim) qv = bf16r(rotate(rp, tid, qv, qp));
        }
        q_s[tid] = qv;
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kRound; ++r) {
      float f[kVec];
      word_f(kw[r], kp, f);
      const float qd = q_s[rg * kRowsG + r0 + r];
#pragma unroll
      for (int e = 0; e < kVec; ++e) dot[e] += qd * f[e];
    }
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) sp[rg * kSplit + kVec * wi + e] = dot[e];
  // the first round of values, requested before the block reduces the
  // scores
  uint32_t vw[kVRound][kWordsLane];
  auto load_v = [&](int i0) {
#pragma unroll
    for (int i = 0; i < kVRound; ++i)
#pragma unroll
      for (int jj = 0; jj < kWordsLane; ++jj) {
        const int j = kVec * (lane + 32 * jj);
        vw[i][jj] = j < n ? *reinterpret_cast<const uint32_t*>(
                                vp + (size_t)(warp + (i0 + i) * kWarps) * S +
                                c0 + j)
                          : 0u;
      }
  };
  load_v(0);
  __syncthreads();
  const bool valid = tid < n && c0 + tid >= start;
  float s = kNeg;
  if (valid) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < kVec; ++g) t += sp[g * kSplit + tid];
    s = t * qk_scale;
  }
  const float m = block_reduce<true>(s, red);
  const float p = valid ? expf(s - m) : 0.f;
  const float l = block_reduce<false>(p, red);
  p_s[tid] = bf16r(p);
  __syncthreads();
#pragma unroll
  for (int i0 = 0; i0 < kRows; i0 += kVRound) {
    if (i0) load_v(i0);
#pragma unroll
    for (int i = 0; i < kVRound; ++i) {
      float part = 0.f;
#pragma unroll
      for (int jj = 0; jj < kWordsLane; ++jj) {
        const int j = kVec * (lane + 32 * jj);
        if (j < n) {
          float f[kVec];
          word_f(vw[i][jj], vp, f);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float pj = p_s[j + e];
            // a masked column has p == 0 and adds nothing, even if not
            // finite
            part += pj != 0.f ? pj * f[e] : 0.f;
          }
        }
      }
      part = warp_sum(part);
      if (lane == 0) __stcg(out + 2 + warp + (i0 + i) * kWarps, part);
    }
  }
  if (tid == 0) {
    __stcg(out, m);
    __stcg(out + 1, l);
  }
  __syncthreads();
}

// The last item of head h to finish combines the head's ns slices into
// its HD values of the context row (`ctx`, rounded to bf16): the slices'
// max M, weights exp(m_s - M) and weighted sum of their sums; with the
// fresh column (self-attention: q as the item left it in q_s, the fresh k
// from qkv rotated, quantised with an int8 cache (CT) and written to
// `fresh` here, v from qkv; their score in fp32; with an int8 cache the
// score times scale * kscale and the context times kscale) or without
// (cross: the context times kscale / denominator).  The slices' partials,
// k (and its rotary partner) and v are requested in one round.
template <typename CT, int HD, bool kRope>
__device__ void finish_head(const MegaArgs& a, int l, const float* att_h,
                            int ns, int h, const float* qkv, float kscale,
                            const Rope& rp, const float* q_s, float* k_s,
                            float* fin) {
  constexpr int kAtt = HD + 2;
  const int tid = threadIdx.x, lane = tid & 31;
  const bool self = qkv != nullptr;
  const bool qself = self && sizeof(CT) == 1;   // an int8 or e4m3 cache
  float* wts = fin + 4;                      // [kMaxSplits]
  float pv[kMaxSplits];
  float vf = 0.f, kf = 0.f, kp = 0.f;
  // the head's KV head, and whether this head writes its fresh K
  const int rep = kv_rep(a), dkv = kv_width(a);
  const int hk = h / rep;
  if (tid < HD) {
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < ns) pv[s] = __ldcg(att_h + s * kAtt + 2 + tid);
    if (self) {
      kf = __ldcg(qkv + a.d + hk * HD + tid);
      if (kRope && rp.dim)
        kp = __ldcg(qkv + a.d + hk * HD + partner(rp, tid));
      vf = __ldcg(qkv + a.d + dkv + hk * HD + tid);
    }
  }
  float ms = kNeg, ls = 0.f;
  if (tid < 32 && lane < ns) {
    ms = __ldcg(att_h + lane * kAtt);
    ls = __ldcg(att_h + lane * kAtt + 1);
  }
  if (self && tid < HD) {
    if constexpr (kRope) {
      if (rp.dim) kf = bf16r(rotate(rp, tid, kf, kp));
    }
    // [L, 2, Hkv, D]: the group's first query head writes it
    const size_t f = (size_t)l * 2 * dkv + hk * HD + tid;
    const bool writes = h == hk * rep;
    if (qself) {
      if constexpr (std::is_same<CT, e4m3_t>::value) {
        const e4m3_t q8 = to_e4m3(__fmul_rn(kf, __ldg(a.kv_oq + l)));
        kf = to_f(q8);
        if (writes) static_cast<e4m3_t*>(a.fresh)[f] = q8;
      } else {
        kf = quant_kv(kf, __ldg(a.kv_oq + l));
        if (writes) static_cast<int8_t*>(a.fresh)[f] = (int8_t)kf;
      }
    } else if (writes) {
      static_cast<__nv_bfloat16*>(a.fresh)[f] = __float2bfloat16(kf);
    }
    k_s[tid] = kf;
  }
  __syncthreads();
  if (tid < 32) {
    float qk = 0.f;
    if (self) {
#pragma unroll
      for (int j = 0; j < HD / 32; ++j)
        qk += q_s[lane + 32 * j] * k_s[lane + 32 * j];
    }
    const float M = warp_max(ms);
    const float w = lane < ns ? expf(ms - M) : 0.f;
    if (lane < ns) wts[lane] = w;
    const float Lsum = warp_sum(ls * w);
    if (self) {
      const float sf = warp_sum(qk) * (qself ? a.scale * kscale : a.scale);
      const float m_fin = fmaxf(M, sf);
      const float alpha = expf(M - m_fin), pf = expf(sf - m_fin);
      if (lane == 0) {
        fin[0] = alpha;
        fin[1] = pf;
        fin[2] = Lsum * alpha + pf;
      }
    } else if (lane == 0) {
      fin[2] = Lsum;
    }
  }
  __syncthreads();
  if (tid < HD) {
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < ns) acc += pv[s] * wts[s];
    const float v =
        qself ? bf16r((acc * fin[0] * kscale + vf * (kscale * fin[1])) /
                      fin[2])
        : self ? bf16r((acc * fin[0] + vf * fin[1]) / fin[2])
               : bf16r(acc * (kscale / fin[2]));
    __stcg(a.ctx + h * HD + tid, v);
  }
  __syncthreads();
}

// A head of more than kMaxSplits slices (a cache longer than 2048
// columns; the decoder-only set): slices kMaxSplits - 1 .. ns - 1 folded
// into slot kMaxSplits - 1 (their max M, weights exp(m_s - M), the
// weighted sums of their sums and P*V, in slice order), so that the
// finish combines kMaxSplits.  Out of line: a head of kMaxSplits slices
// or fewer never runs it.
template <int HD>
__device__ __noinline__ void fold_slices(float* att_h, int ns, float* red) {
  constexpr int kAtt = HD + 2, s0 = kMaxSplits - 1;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 32) {
    float m = kNeg;
    for (int s = s0 + lane; s < ns; s += 32)
      m = fmaxf(m, __ldcg(att_h + s * kAtt));
    m = warp_max(m);
    if (lane == 0) red[0] = m;
  }
  __syncthreads();
  const float M = red[0];
  float acc = 0.f, lsum = 0.f;
  if (tid < HD) {
#pragma unroll 4
    for (int s = s0; s < ns; ++s) {
      const float w = expf(__ldcg(att_h + s * kAtt) - M);
      acc += __ldcg(att_h + s * kAtt + 2 + tid) * w;
      if (tid == 0) lsum += __ldcg(att_h + s * kAtt + 1) * w;
    }
  }
  __syncthreads();              // every slot read before slot s0 is written
  if (tid < HD) __stcg(att_h + s0 * kAtt + 2 + tid, acc);
  if (tid == 0) {
    __stcg(att_h + s0 * kAtt, M);
    __stcg(att_h + s0 * kAtt + 1, lsum);
  }
  __syncthreads();
}

// Scratch of the attention stages in static shared memory.
template <int HD>
struct AttnSmem {
  float red[kWarps];
  float p_s[kSplit];
  float q_s[HD];
  float k_s[HD];
  float fin[4 + kMaxSplits];     // a head's finish: alpha, pf, denominator,
                                 // weights
  int last;
};

// An attention stage: every item (h, s) of this block (query head h over
// KV head h / rep of a cache of Hkv heads), then, for the last of a head's
// items to finish (an arrival counted on the head's counter; a head of one
// slice needs none), the head's context.
template <typename CT, int HD, bool kRope>
__device__ void attn_stage(const MegaArgs& a, const CT* cache, int l, int S,
                           int n_cols, int ns, int start, const float* q_row,
                           float qk_scale, const float* qkv, float kscale,
                           const Rope& rp, unsigned int* count, float* sp,
                           AttnSmem<HD>& sm, int Hkv, int rep) {
  constexpr int kAtt = HD + 2;
  const int H = a.n_head;
  const size_t head = (size_t)HD * S;
  for (int it = blockIdx.x; it < H * ns; it += gridDim.x) {
    const int h = it / ns, s = it % ns, hk = h / rep;
    float* att_h = a.att + (size_t)h * ns * kAtt;
    attn_item<CT, HD, kRope>(cache + ((size_t)l * 2 * Hkv + hk) * head,
                      cache + ((size_t)(l * 2 + 1) * Hkv + hk) * head, S,
                      s * kSplit, min(n_cols, (s + 1) * kSplit), start,
                      q_row + h * HD, rp, qk_scale, sm.q_s, sm.p_s, sp,
                      sm.red, a.att + ((size_t)h * ns + s) * kAtt);
    if (ns > 1) {
      // the item's partial, then its arrival (release); the last to
      // arrive reads every slice's (acquire)
      if (threadIdx.x == 0) {
        __threadfence();
        sm.last = atomicAdd(count + h, 1u) == (unsigned int)(ns - 1);
        __threadfence();
      }
      __syncthreads();
      if (!sm.last) continue;
    }
    if constexpr (kDecoderOnly) {   // Whisper's caches take 8 slices
      if (ns > kMaxSplits) fold_slices<HD>(att_h, ns, sm.red);
    }
    finish_head<CT, HD, kRope>(a, l, att_h, min(ns, kMaxSplits), h, qkv,
                               kscale, rp, sm.q_s, sm.k_s, sm.fin);
  }
}

// the dynamic shared memory: the residual row, the input row (padded), a
// vector's sum each of the largest piece (or an attention item's partial
// dots), then the ring
struct Smem {
  size_t vin, part, ring;
};

template <typename WT>
__host__ __device__ inline Smem smem_layout(const MegaArgs& a) {
  const int vals = kInt4<WT> ? 32 : a.weight_bf16 ? 8 : 16;
  size_t vin_n = 0, part_n = 0;
  for (int g = 0; g < kStages; ++g) {
    if (a.items[g] == 0) continue;
    const size_t k = a.item_k[g];
    vin_n = vin_n > k ? vin_n : k;
    const size_t p = (size_t)a.piece_c[g] * (k / vals);
    part_n = part_n > p ? part_n : p;
  }
  // part also holds an attention item's partial dots (4 groups x 256)
  part_n = part_n > 4 * kSplit ? part_n : 4 * kSplit;
  vin_n = vin_n + (vin_n / 32) * 4;
  Smem s;
  s.vin = (size_t)a.d * 4;
  s.part = s.vin + vin_n * 4;
  s.ring = (s.part + part_n * 4 + 127) / 128 * 128;
  return s;
}

// CT: the cross cache's element type, ST: the self cache's, WT: the
// weights', HD: the head dim
template <typename CT, typename ST, typename WT, int HD>
__global__ void __launch_bounds__(kThreads, 1)
megakernel(const MegaArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem lay = smem_layout<WT>(a);
  float* xs = reinterpret_cast<float*>(smem);             // [d] residual
  float* vin = reinterpret_cast<float*>(smem + lay.vin);  // the input row
  float* part = reinterpret_cast<float*>(smem + lay.part);
  __shared__ AttnSmem<HD> sm;
  __shared__ float es[2][kItemCols], eb[2][kItemCols];  // the epilogue's
  __shared__ float hold[kItemCols];       // act(fc) of the gated stage
  __shared__ __align__(8) uint64_t bars[kSlots];
  __shared__ Loads loads;

  const int tid = threadIdx.x;
  const int d = a.d, H = a.n_head, S = a.s_self, Sc = a.s_cross;
  const int nf = a.nf;
  const int Hkv = kDecoderOnly ? a.n_kv_head : H, rep = kv_rep(a);
  const int n_valid = min(max(a.seq_len[0] - 1, 0), S);  // cache columns
  const int ns = max(1, (n_valid + kSplit - 1) / kSplit);
  const int nsc = (Sc + kSplit - 1) / kSplit;
  const int start = a.start ? a.start[0] : 0;
  const Rope rope{a.rope_dim, a.rope_neox, max(a.write_index - start, 0),
                  a.inv_freq};
  const Rope no_rope{0, 0, 0, nullptr};
  constexpr bool kSelfInt8 = sizeof(ST) == 1;
  const ST* selfc = static_cast<const ST*>(a.self_cache);
  const CT* crossc = static_cast<const CT*>(a.cross_cache);
  const __nv_bfloat16* x_in = static_cast<const __nv_bfloat16*>(a.x);
  const bool rms = kDecoderOnly && a.norm_rms != 0;
  unsigned int gen = 0;                   // the barrier counter's target

  Ring ring{reinterpret_cast<int8_t*>(smem + lay.ring), bars,
            (uint32_t)a.ring_bytes, 0u, 0u, 0, 0, 0, 0};
  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          smem_u32(&bars[i])));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    loads_init<WT>(a, loads);
    if (loads.n == 0) ring.l = a.n_layer;          // a block with no items
    ring_pump(a, loads, ring);
  }
  for (int i = tid; i < d; i += kThreads) xs[i] = to_f(x_in[i]);
  __syncthreads();

  // The layer as a loop over its stages, each component written once:
  // the kernel's code has to stay small for the instruction cache (written
  // out stage by stage it is twice as large, and every stage runs from a
  // cold cache).  Stage st ends with GEMV g (none for the attention stages
  // 1 and 4) and a grid barrier; without cross-attention stages 3-5 are
  // skipped:
  //   0. the previous layer's fc2 into the residual; norm 0; q, k, v -> A
  //      (and the fresh V out)
  //   1. self-attention slices over the cache; each head's last slice
  //      rotates, writes the fresh K and combines them with the fresh
  //      column -> ctx
  //   2. out-projection of ctx -> B
  //   3. residual; norm 1; cross-q -> A
  //   4. cross-attention slices; each head's last slice combines them,
  //      times kscale / denominator -> ctx
  //   5. cross-out of ctx -> B
  //   6. residual; the MLP's norm (norm 2 with cross-attention, 1
  //      without; under the parallel residual norm 0 of the residual
  //      before this update); fc1 (, the gate) and the activation -> A
  //      (nf * d outputs)
  //   7. fc2 (K = nf * d) over fc1's finished row -> B
  const bool parallel = kDecoderOnly && a.parallel;
  const int mlp_norm = !kDecoderOnly ? 2 : parallel ? 0 : 1;
  for (int l = 0; l < a.n_layer; ++l) {
    const float* ln = a.ln_par + (size_t)l * 2 * a.n_ln * d;
    const float kscale = a.cross_scale ? a.cross_scale[l] : 1.f;
    const float kqo = kSelfInt8 ? a.kv_qo[l] : 1.f;
    for (int st = 0; st < kLayerStages; ++st) {
      if (kDecoderOnly && st >= 3 && st <= 5) continue;
      const int g = st == 0 ? kQkv : st == 2 ? kDense : st == 3 ? kCrossQ
                  : st == 5 ? kCrossDense : st == 6 ? kFc1
                  : st == 7 ? kFc2 : -1;
      const int n_out =
          g == kQkv ? d + 2 * kv_width(a) : g == kFc1 ? nf * d : d;
      Epi ep;
      if (g >= 0) epi_fetch<WT>(a, l, g, n_out, ep);
      if (st == 0 || st == 3 || st == 6) {
        const int m = st == 0 ? 0 : st == 3 ? 1 : mlp_norm;
        residual_norm(st == 0 && l == 0 ? nullptr : a.act_b,
                      st == 6 && parallel, ln + 2 * m * d,
                      ln + (2 * m + 1) * d, xs, vin, d, a.eps, rms, sm.red);
      } else if (st == 2 || st == 5 || st == 7) {
        // the finished row the GEMV reads: the context, or act(fc1)
        const float* row = st == 7 ? a.act_a : a.ctx;
        const int n = st == 7 ? nf * d : d;
        float f[kPerFc];
#pragma unroll
        for (int k = 0; k < kPerFc; ++k) {
          const int i = tid + k * kThreads;
          if (i < n) f[k] = __ldcg(row + i);
        }
#pragma unroll
        for (int k = 0; k < kPerFc; ++k) {
          const int i = tid + k * kThreads;
          if (i < n) vin[vpos(i)] = f[k];
        }
        if constexpr (kDecoderOnly) {   // past 6144 (SantaCoder-1B's 8192)
#pragma unroll 1
          for (int i = kPerFc * kThreads + tid; i < n; i += kThreads)
            vin[vpos(i)] = __ldcg(row + i);
        }
        __syncthreads();
      } else if (st == 1) {
        attn_stage<ST, HD, kDecoderOnly>(
            a, selfc, l, S, n_valid, ns, start, a.act_a,
            kSelfInt8 ? a.scale * kqo : a.scale, a.act_a, kqo, rope,
            a.heads + (size_t)l * H, part, sm, Hkv, rep);
      } else if constexpr (!kDecoderOnly) {
        attn_stage<CT, HD, false>(a, crossc, l, Sc, Sc, nsc, 0, a.act_a,
                                  a.scale * kscale, nullptr, kscale, no_rope,
                                  a.heads + (size_t)(a.n_layer + l) * H, part,
                                  sm, H, 1);
      }
      if (g >= 0) {
        const bool to_a = g == kQkv || g == kCrossQ || g == kFc1;
        // (the decoder-only set) read by the epilogue after the GEMV's
        // first __syncthreads
        epi_store<WT>(a, g, ep, es, eb);
        gemv_stage(a, ring, l, g, vin, part, to_a ? a.act_a : a.act_b,
                   n_out, es, eb, hold, loads, ep,
                   static_cast<const WT*>(nullptr));
      }
      // what the stages after the barrier read from memory, into L2
      if (st == 0) {
        prefetch_attn<ST, HD>(selfc, l, H, Hkv, rep, S, n_valid, ns);
        prefetch_params(a, l, kDense, -1);
      } else if (st == 1) {
        prefetch_params(a, l, kDecoderOnly ? kFc1 : kCrossQ,
                        kDecoderOnly ? mlp_norm : 1);
      } else if (st == 2) {
        if constexpr (kDecoderOnly) prefetch_params(a, l, kFc2, -1);
        else prefetch_attn<CT, HD>(crossc, l, H, H, 1, Sc, Sc, nsc);
      } else if (st == 3) {
        prefetch_params(a, l, kCrossDense, -1);
      } else if (st == 4) {
        prefetch_params(a, l, kFc1, 2);
      } else if (st == 5) {
        prefetch_params(a, l, kFc2, -1);
      } else if (st == 6) {
        prefetch_params(a, l + 1, kQkv, 0);
      }
      grid_sync(a.barrier, gen);
    }
  }

  // the last layer's fc2 into the residual: the hidden state out
  if (blockIdx.x == 0) {
    __nv_bfloat16* hid = static_cast<__nv_bfloat16*>(a.hid);
    for (int i = tid; i < d; i += kThreads)
      hid[i] = __float2bfloat16(xs[i] + __ldcg(a.act_b + i));
  }
}

// the plan checked against the model's widths and the grid: per stage the
// model has (the qkv stage's d + 2 dkv columns), items of c columns
// covering its columns, at most one a block,
// K a multiple of 16 (int4: 32, a group of a multiple of 32 rows dividing
// d/2), pieces of 1..c columns, the tiles contiguous in stage order (the
// gated fc1 item twice as long; an int4 item int4_item_bytes); a stage it
// has not, no items
template <typename WT>
bool plan_ok(const MegaArgs* a, int grid) {
  if constexpr (kInt4<WT>) {
    if (a->n_groups < 0 || a->d % 32) return false;
    if (a->n_groups) {
      const int gsz = a->d % a->n_groups ? 0 : a->d / a->n_groups;
      if (!gsz || gsz % 32 || (a->d / 2) % gsz) return false;
    }
  }
  const long long cols[kStages] = {
      a->d + 2LL * a->n_kv_head * a->head_dim, a->d, a->d, a->d,
      (long long)a->nf * a->d, a->d};
  const int ks[kStages] = {a->d, a->d, a->d, a->d, a->d, a->nf * a->d};
  const int wb = a->weight_bf16 ? 2 : 1;
  long long off = 0;
  for (int g = 0; g < kStages; ++g) {
    const long long c = a->item_c[g], n = a->items[g];
    const bool has = a->with_cross || (g != kCrossQ && g != kCrossDense);
    if (!has) {
      if (c != 0 || n != 0 || a->tile_off[g] != off) return false;
      continue;
    }
    if (c < 1 || c > kItemCols || n < 1 || n > grid || c * n < cols[g] ||
        c * (n - 1) >= cols[g] || a->item_k[g] != ks[g] || ks[g] % 16 ||
        a->piece_c[g] < 1 || a->piece_c[g] > c ||
        a->piece_c[g] > kPieceCols || a->tile_off[g] != off)
      return false;
    if constexpr (kInt4<WT>) {
      if (ks[g] % 32 || a->piece_c[g] != c) return false;
      off += n * int4_item_bytes(*a, g);
      continue;
    }
    off += c * n * ks[g] * wb * (g == kFc1 && a->gated ? 2 : 1);
  }
  return off == a->layer_bytes;
}

template <typename CT, typename ST, typename WT, int HD>
int launch(const MegaArgs* a, void* stream) {
  auto kernel = megakernel<CT, ST, WT, HD>;
  cudaError_t e;
  int dev = 0, sms = 0, coop = 0, optin = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (!coop) return (int)cudaErrorNotSupported;
  const int grid = sms;              // one block per SM, all co-resident
  if (!plan_ok<WT>(a, grid)) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  if ((e = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess) return (int)e;
  // the ring takes what the block's shared memory has left
  const size_t smem = (size_t)optin - fa.sharedSizeBytes;
  const Smem lay = smem_layout<WT>(*a);
  MegaArgs args = *a;
  long long ring = ((long long)smem - (long long)lay.ring) / 16 * 16;
  // the plan's cap on the ring (0: all that is left)
  if (a->ring_bytes > 0 && a->ring_bytes < ring) ring = a->ring_bytes / 16 * 16;
  const int wb = a->weight_bf16 ? 2 : 1;
  long long largest = 0;
  for (int g = 0; g < kStages; ++g)
    largest = max(largest, kInt4<WT> ? (long long)int4_item_bytes(*a, g)
                                     : (long long)a->piece_c[g] *
                                           a->item_k[g] * wb);
  if (ring < largest) return (int)cudaErrorInvalidValue;
  // a block's loads of a layer fit the table of the ring's walk
  int n_loads = 0;
  for (int g = 0; g < kStages; ++g)
    if (a->items[g])
      n_loads += (g == kFc1 && a->gated ? 2 : 1) *
                 ((a->item_c[g] + a->piece_c[g] - 1) / a->piece_c[g]);
  if (n_loads > kMaxLoads) return (int)cudaErrorInvalidValue;
  args.ring_bytes = (int)ring;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                  dim3(kThreads), params, smem,
                                  reinterpret_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#ifndef MEGA_DECODER_ONLY
// Whisper's set at one weight type: heads of 64, a bf16 or int8 cross and
// self cache
template <typename WT>
int launch_whisper(const MegaArgs* a, void* stream) {
  // whole int8 and int4 items, one load each (bf16 items in pieces)
  if (!kPieced<WT>)
    for (int g = 0; g < kStages; ++g)
      if (a->piece_c[g] != a->item_c[g]) return (int)cudaErrorInvalidValue;
#ifdef MEGA_SELF_E4M3
  return a->cross_int8 ? launch<int8_t, e4m3_t, WT, 64>(a, stream)
                       : launch<__nv_bfloat16, e4m3_t, WT, 64>(a, stream);
#else
  if (a->self_kind)
    return a->cross_int8 ? launch<int8_t, int8_t, WT, 64>(a, stream)
                         : launch<__nv_bfloat16, int8_t, WT, 64>(a, stream);
  return a->cross_int8 ? launch<int8_t, __nv_bfloat16, WT, 64>(a, stream)
                       : launch<__nv_bfloat16, __nv_bfloat16, WT, 64>(
                             a, stream);
#endif
}
#else
// the decoder-only set: no cross cache (its type is a placeholder)
template <typename ST, typename WT>
int launch_hd(const MegaArgs* a, void* stream) {
  return a->head_dim == 128
             ? launch<__nv_bfloat16, ST, WT, 128>(a, stream)
             : launch<__nv_bfloat16, ST, WT, 64>(a, stream);
}
#endif

}  // namespace

extern "C" {

// Returns 0 when the cooperative launch was enqueued, else the CUDA error
// (cudaErrorInvalidValue for shapes, modes or a plan it does not take).
// The library built with MEGA_DECODER_ONLY takes decoders without
// cross-attention (int8 or bf16 weights, head dim 64 or 128, Hkv KV heads
// under the query heads, the grouped mode at head dim 128); the other,
// Whisper's decoder (int8, int4 or bf16 weights, head dim 64, equal
// heads).
int decoder_megakernel(const MegaArgs* a, void* stream) {
  if ((a->head_dim != 64 && a->head_dim != 128) || a->d % a->head_dim ||
      a->d / a->head_dim > kMaxHeads || a->n_head * a->head_dim != a->d ||
      a->n_kv_head < 1 || a->n_head % a->n_kv_head ||
      (a->n_kv_head != a->n_head &&
       (a->with_cross || a->head_dim != 128)) ||
      a->nf < 1 ||
      a->d > kPer * kThreads || a->nf * a->d > kMaxFc ||
      a->s_self % (a->self_kind ? 4 : 2) ||
      (a->self_kind && (!a->kv_oq || !a->kv_qo)) ||
#ifdef MEGA_SELF_E4M3
      a->self_kind != 2 ||
#else
      a->self_kind < 0 || a->self_kind > 1 ||
#endif
      (a->rope_dim && (!a->inv_freq || a->rope_dim % 2 ||
                       a->rope_dim > a->head_dim)) ||
      a->act < 0 || a->act > 3 || a->n_ln < 1 || a->n_ln > 3)
    return (int)cudaErrorInvalidValue;
#ifdef MEGA_DECODER_ONLY
  if (a->with_cross || a->weight_int4) return (int)cudaErrorInvalidValue;
#ifdef MEGA_SELF_E4M3
  return a->weight_bf16 ? launch_hd<e4m3_t, __nv_bfloat16>(a, stream)
                        : launch_hd<e4m3_t, int8_t>(a, stream);
#else
  if (a->weight_bf16)
    return a->self_kind ? launch_hd<int8_t, __nv_bfloat16>(a, stream)
                        : launch_hd<__nv_bfloat16, __nv_bfloat16>(a, stream);
  return a->self_kind ? launch_hd<int8_t, int8_t>(a, stream)
                      : launch_hd<__nv_bfloat16, int8_t>(a, stream);
#endif
#else
  // Whisper's set: LayerNorm, tanh GELU, the sequential residual, no RoPE
  if (!a->with_cross || (a->weight_bf16 && a->weight_int4) ||
      a->head_dim != 64 ||
      a->s_self > kMaxSplits * kSplit ||
      a->s_cross > kMaxSplits * kSplit ||
      a->s_cross % (a->cross_int8 ? 4 : 2) || a->norm_rms || a->act ||
      a->gated || a->parallel || a->rope_dim)
    return (int)cudaErrorInvalidValue;
  if (a->weight_int4) return launch_whisper<int4x2_t>(a, stream);
  return a->weight_bf16 ? launch_whisper<__nv_bfloat16>(a, stream)
                        : launch_whisper<int8_t>(a, stream);
#endif
}

}  // extern "C"
