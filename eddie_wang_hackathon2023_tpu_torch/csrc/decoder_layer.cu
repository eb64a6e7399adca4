// The whole decode step of a Whisper decoder (every layer) in ONE launch,
// at batch 1 with int8 weight-only panels.
//
// Replaces the TPU kernel eddie_wang_hackathon2023_tpu/ops/
// pallas_decoder_layer.py:306 `_kernel` (entry `fused_decoder_stack`,
// :865) in the modes of the Whisper int8 recipe: LayerNorm, the q/k/v,
// out, cross-q, cross-out, fc1 and fc2 GEMVs (int8 weights, per-channel
// scales), self-attention over the bf16 (or int8) seq-minor cache with the
// fresh token's K/V in fp32, cross-attention over the int8 (or bf16) cross
// cache with per-layer scales, tanh GELU and the bf16 residual stream.  It
// returns the hidden state before the final LN and every layer's fresh
// K/V in the self cache's type; it does not write the cache.
//
// The int8 self cache (the TPU kernel's `self_quant`, :523-554): the fresh
// K and V leave the q/k/v epilogue as int8, each value times the layer's
// kv_oq in fp32, rounded half away from zero and clipped to [-128, 127]
// (as ops/attention.py quantises a cache write), and the fresh column's
// score and value use those integers; the cache's columns and the fresh
// one are scaled by the layer's kv_qo where the cross cache takes its
// scale: the score times scale * kv_qo, the context times kv_qo at the
// end.  Each (cross, self) type pair is its own instantiation.
//
// Bound: bytes.  A step reads the whole weight image once (14 d*d int8 a
// layer, 734 MB at large-v2) plus the cross cache (123 MB) and does about
// 2 flops per weight byte.  The TPU kernel walked a (layer, stage) grid in
// order with the hidden state in VMEM and a ring of panel DMAs.  On Hopper
// the blocks of a grid run in parallel, so here:
//   * one persistent grid, one block per SM, all co-resident (cooperative
//     launch); a grid barrier separates dependent stages, 8 a layer: one
//     `red.release.gpu` add a block on a counter that only grows, then
//     `ld.acquire.gpu` polls until it reaches the grid times the barrier's
//     index in the launch (no reset, no second atomic);
//   * the weights are repacked once, at blob build (`megakernel_tiles`),
//     into item-contiguous tiles: a GEMV stage's output columns are cut
//     into `items` items of `c` columns by ALL of K, each item c rows of K
//     contiguous int8 (the stage's weight transposed), one item a block.
//     The plan (the wrapper's `megakernel_plan`: c and items per stage)
//     makes each stage about one wave over the grid; the C entry checks it.
//     The sums are whole: the stage after a GEMV reads one finished fp32
//     value an output;
//   * the weights do not depend on the activations, so each block streams
//     its own items of every stage, layer after layer, into a ring in
//     shared memory with `cp.async.bulk` (the TMA's 1D copy, completion
//     counted in bytes on one of 16 mbarriers), as far ahead as the ring
//     holds (about a layer): the copies run on through barriers and the
//     attention stages, and a block waits on an mbarrier only when it
//     needs the bytes;
//   * an item's GEMV: thread t takes 16-byte vectors t, t + 256, ... of the
//     item (column-major), each times the input row's 16 floats into a
//     fresh fp32 sum (int8 -> float by a byte permute into the mantissa of
//     2^23 and one subtraction: exact), written to shared memory; a warp
//     then adds a column's vectors in order.  The input row is kept with 4
//     floats of padding every 32, so the 16-float reads of 8 threads fall on
//     distinct banks;
//   * the block that owns an item also applies its columns' epilogue (scale
//     and bias; GELU after fc1; the fresh K/V out after q/k/v) and writes
//     finished values: a stage after a GEMV reads one value an output and
//     no parameters;
//   * every block keeps the residual row in shared memory and recomputes
//     the LayerNorm and residual updates itself (identical arithmetic in
//     every block), which saves a barrier per update;
//   * a stage is latency-bound (a dependent round trip to L2 or memory
//     costs about a microsecond), so each stage requests everything it
//     reads in one round, before it uses any of it: the residual's update,
//     the LayerNorm's parameters and the epilogue's scale and bias
//     together; an attention item's q and its share of the keys together
//     (then its share of the values); a head's slices together;
//   * attention splits heads and 256-column slices of the cache over the
//     blocks, read in 4-byte words of 2 (bf16) or 4 (int8) columns; each
//     item writes its max, sum and P*V partial, and the last of a head's
//     items to finish (an arrival counter a head) combines the slices,
//     adds the fresh token's column and writes the head's context, so the
//     stage after the barrier reads one value an output;
//   * before a barrier, a block asks L2 to prefetch what the stages after
//     it read from memory and not from another block: its next attention
//     item's K and V rows, the next LayerNorm's and epilogue's parameters;
//   * data written before a barrier is read after it with L1-bypassing
//     loads (__ldcg), so no block reads a stale line.
// Rounding points follow the TPU kernel: GEMV sums in fp32, scaled in
// fp32, rounded to bf16, plus the bias rounded to bf16 (:500-508,
// :765-766); LayerNorm in fp32, rounded (:416-427); the residual in bf16;
// P rounded to bf16 before P*V (:631-634); the cross context times
// kscale / denominator at the end (:641-647); the fresh self score and
// value in fp32 (:700-746; with an int8 self cache (ctx * alpha * kscale +
// v * (kscale * pf)) / denominator, :740-743); fc2's four panels summed in
// fp32 before the scale (:797-809: an fc2 item spans all of its K).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// the GEMV stages of a layer, in order
enum Stage { kQkv = 0, kDense, kCrossQ, kCrossDense, kFc1, kFc2, kStages };

// the kernel's operands, filled by the Python wrapper (a ctypes Structure
// of the same layout) and passed by value
struct MegaArgs {
  const void* x;               // [d] bf16, embedded token + position
  const int8_t* tiles;         // [L, layer_bytes] item-contiguous weights
  const float* pair_scale;     // [L, 4, d]: q, k, v, cross-q
  const float* pair_bias;
  const float* flat_scale;     // [L, nflat, d]: dense, cross-dense, fc1.., fc2
  const float* flat_bias;
  const float* ln_par;         // [L, 6, d]: weight, bias of the three LNs
  const void* self_cache;      // [L, 1, 2, H, D, S] bf16 or int8
  const void* cross_cache;     // [L, 1, 2, H, D, Sc] int8 or bf16
  const float* cross_scale;    // [L] or null
  const float* kv_oq;          // [L] the int8 self cache's quantise and
  const float* kv_qo;          // dequantise scales (null for bf16)
  const int* seq_len;          // [1], including the fresh token
  void* hid;                   // [d] bf16 out
  void* fresh;                 // [L, 2, H, D] out, the self cache's type
  float* act_a;                // finished GEMV outputs: q, k, v / cross-q /
                               // GELU(fc1)
  float* act_b;                // ... dense / cross-dense / fc2
  float* att;                  // attention partials [H, splits, kAtt]
  float* ctx;                  // [d] the attention stage's context row
  unsigned int* barrier;       // [1] zero: arrivals, only growing
  unsigned int* heads;         // [2, L, H] zeros: a head's slices done
  long long layer_bytes;       // bytes of one layer's tiles
  int n_layer, d, n_head, s_self, s_cross, nflat, nf;
  int f_dense, f_crossdense, f_fc1, f_fc2;
  int cross_int8, self_int8;
  int ring_bytes;              // the plan's cap on the ring (0: none); the
                               // kernel gets the ring's size
  // the plan, per GEMV stage: columns of an item, items, rows of K, and
  // the stage's byte offset in a layer's tiles
  int item_c[kStages], items[kStages], item_k[kStages], tile_off[kStages];
  float scale, eps;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kD = 64;           // head dim
constexpr int kSplit = kThreads; // cache columns of one attention item
constexpr int kMaxHeads = 32;
constexpr int kMaxSplits = 8;
constexpr int kAtt = kD + 2;     // one attention partial: max, sum, P*V
constexpr int kSlots = 16;       // mbarriers of the weight ring
constexpr int kLayerStages = 8;  // a layer's stages, each ending in a barrier
constexpr int kPer = 5;          // a d-row's elements a thread holds
constexpr int kPerFc = 20;       // fc2's input row's (nf * d)
constexpr int kColsWarp = 6;     // an item's columns a warp sums
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

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x *
         (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

// The residual update and the LayerNorm: xs[i] = bf16(xs[i] + delta[i])
// (delta: a GEMV stage's finished output, or null), then vin = bf16(
// LayerNorm(xs) * w + b) at vpos, statistics in fp32.  The update and the
// parameters are requested in one round; thread t holds i = t + 256 k.
__device__ void residual_ln(const float* delta, const float* w,
                            const float* b, float* xs, float* vin, int d,
                            float eps, float* red) {
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
      if (delta) xs[i] = bf16r(xs[i] + dv[k]);
      s += xs[i];
    }
  }
  const float mean = block_reduce<false>(s, red) / d;
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
    if (i < d) vin[vpos(i)] = bf16r((xs[i] - mean) * r * wv[k] + bv[k]);
  }
  __syncthreads();
}

// -- the weight ring --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Each block streams its items of every GEMV stage, in (layer, stage)
// order, into a ring of `bytes` bytes.  Load i uses mbarrier i % kSlots,
// whose phase (i / kSlots) & 1 completes when its bytes have landed.  Every
// thread tracks the consumer's side identically; thread 0 also issues.
struct Ring {
  int8_t* buf;
  uint64_t* bars;
  uint32_t bytes;
  uint32_t head, tail;         // bytes issued, bytes released (monotonic)
  int next, done;              // loads issued, loads released
  int total;                   // loads in the launch
};

__device__ __forceinline__ int load_bytes(const MegaArgs& a, int g) {
  return blockIdx.x < a.items[g] ? a.item_c[g] * a.item_k[g] : 0;
}

// thread 0: issue every load that fits (the ring's bytes and slots)
__device__ void ring_pump(const MegaArgs& a, Ring& r) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  while (r.next < r.total && r.next - r.done < kSlots) {
    const int l = r.next / kStages, g = r.next % kStages;
    const uint32_t sz = load_bytes(a, g);
    if (r.head + sz - r.tail > r.bytes) break;
    const uint32_t bar = smem_u32(&r.bars[r.next % kSlots]);
    if (sz == 0) {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                   : "memory");
    } else {
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar), "r"(sz) : "memory");
      const int8_t* src = a.tiles + (size_t)l * a.layer_bytes +
                          a.tile_off[g] + (size_t)blockIdx.x * sz;
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
    }
    r.head += sz;
    ++r.next;
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

// every thread: wait for the next load's bytes; returns its ring offset
__device__ __forceinline__ uint32_t ring_wait(Ring& r, uint32_t sz) {
  if (sz) mbar_wait(&r.bars[r.done % kSlots], (r.done / kSlots) & 1);
  return r.tail % r.bytes;
}

// every thread, after the block is done with the load: release its bytes;
// thread 0 refills the ring
__device__ __forceinline__ void ring_release(const MegaArgs& a, Ring& r,
                                             uint32_t sz) {
  r.tail += sz;
  ++r.done;
  if (threadIdx.x == 0) ring_pump(a, r);
}

// -- the GEMV ---------------------------------------------------------------

// byte i of v as an exact float: its sign bit flipped gives b + 128, which
// the permute puts under the exponent of 2^23 (0x4B000000 | (b + 128))
__device__ __forceinline__ float int8_at(uint32_t flipped, int i) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7440 + i)) -
         8388736.f;
}

// the epilogue's parameters of stage g in layer l: column n's scale is
// sc[n], its bias bi[n]
__device__ __forceinline__ void stage_params(const MegaArgs& a, int l,
                                             int g, const float*& sc,
                                             const float*& bi) {
  const size_t pair = (size_t)l * 4 * a.d;
  const size_t flat = (size_t)l * a.nflat * a.d;
  switch (g) {
    case kQkv: sc = a.pair_scale + pair; bi = a.pair_bias + pair; break;
    case kCrossQ:
      sc = a.pair_scale + pair + 3 * a.d;
      bi = a.pair_bias + pair + 3 * a.d;
      break;
    default: {
      const int f = g == kDense ? a.f_dense : g == kCrossDense
                        ? a.f_crossdense : g == kFc1 ? a.f_fc1 : a.f_fc2;
      sc = a.flat_scale + flat + (size_t)f * a.d;
      bi = a.flat_bias + flat + (size_t)f * a.d;
    }
  }
}

// the scale and bias of the columns lane 0 of a warp finishes: j = warp +
// 8 i of the block's item, and at q/k/v with an int8 self cache the
// layer's kv_oq, requested at the stage's start
struct Epi {
  float s[kColsWarp], b[kColsWarp];
  float oq;
};

__device__ __forceinline__ void epi_load(const MegaArgs& a, int l, int g,
                                         int n_out, Epi& e) {
  const int warp = threadIdx.x >> 5, c = a.item_c[g];
  const int col0 = blockIdx.x * c;
  const float *sc, *bi;
  stage_params(a, l, g, sc, bi);
  if ((threadIdx.x & 31) == 0 && (int)blockIdx.x < a.items[g]) {
    if (g == kQkv && a.self_int8) e.oq = __ldg(a.kv_oq + l);
#pragma unroll
    for (int i = 0; i < kColsWarp; ++i) {
      const int n = col0 + warp + kWarps * i;
      if (warp + kWarps * i < c && n < n_out) {
        e.s[i] = __ldg(sc + n);
        e.b[i] = __ldg(bi + n);
      }
    }
  }
}

// The block's item of GEMV stage g in layer l: sum_k vin[k] W[k, n] for
// the item's c columns n (those below n_out), the item's bytes at ring
// offset `off` (c columns of K contiguous int8, wrapping at the ring's
// end; `part` holds a vector's sum each), then the epilogue: out[n] =
// affine(sum, scale, bias), after fc1 its GELU, all rounded to bf16; after
// q/k/v the fresh K and V also to `fresh` (with an int8 self cache
// quantised, in `fresh` and in `out` alike).
__device__ void gemv_item(const MegaArgs& a, const Ring& r, int l, int g,
                          uint32_t off, const float* vin, float* part,
                          float* out, int n_out, const Epi& e) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = a.item_c[g], K = a.item_k[g], vk = K / 16;
  const int col0 = blockIdx.x * c;
  const int nv = c * vk;
  // v: the vector's place in its column (f % vk, kept by steps)
  const int v_step = kThreads % vk;
  int v = tid % vk;
  // not unrolled: an unrolled loop's registers spill elsewhere in the
  // kernel, which costs more than the loop gains
#pragma unroll 1
  for (int f = tid; f < nv; f += kThreads) {
    uint32_t pos = off + 16u * f;
    if (pos >= r.bytes) pos -= r.bytes;
    const uint4 w = *reinterpret_cast<const uint4*>(r.buf + pos);
    const float4* xv = reinterpret_cast<const float4*>(vin + vpos(16 * v));
    v += v_step;
    if (v >= vk) v -= vk;
    const uint32_t words[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                               w.z ^ 0x80808080u, w.w ^ 0x80808080u};
    // four chains of four products, then their sum: a short dependency
    float sq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 x = xv[q];
      float t = x.x * int8_at(words[q], 0);
      t = fmaf(x.y, int8_at(words[q], 1), t);
      t = fmaf(x.z, int8_at(words[q], 2), t);
      sq[q] = fmaf(x.w, int8_at(words[q], 3), t);
    }
    part[f] = (sq[0] + sq[1]) + (sq[2] + sq[3]);
  }
  __syncthreads();
  // a warp's columns side by side, so that their chains interleave
  float cs[kColsWarp];
#pragma unroll
  for (int i = 0; i < kColsWarp; ++i) cs[i] = 0.f;
  for (int t = lane; t < vk; t += 32) {
#pragma unroll
    for (int i = 0; i < kColsWarp; ++i)
      if (warp + kWarps * i < c) cs[i] += part[(warp + kWarps * i) * vk + t];
  }
#pragma unroll
  for (int i = 0; i < kColsWarp; ++i) cs[i] = warp_sum(cs[i]);
#pragma unroll
  for (int i = 0; i < kColsWarp; ++i) {
    const int j = warp + kWarps * i;
    const float s = cs[i];
    const int n = col0 + j;
    if (lane == 0 && j < c && n < n_out) {
      float v = affine(s, e.s[i], e.b[i]);
      if (g == kFc1) v = bf16r(gelu_tanh(v));
      if (g == kQkv && n >= a.d) {     // k or v: [L, 2, H, D] = [L, 2, d]
        const size_t f = ((size_t)l * 2 + n / a.d - 1) * a.d + n % a.d;
        if (a.self_int8) {
          v = quant_kv(v, e.oq);
          static_cast<int8_t*>(a.fresh)[f] = (int8_t)v;
        } else {
          static_cast<__nv_bfloat16*>(a.fresh)[f] = __float2bfloat16(v);
        }
      }
      __stcg(out + n, v);
    }
  }
}

// one GEMV stage: wait for the block's item, run it, release its bytes
__device__ void gemv_stage(const MegaArgs& a, Ring& r, int l, int g,
                           const float* vin, float* part, float* out,
                           int n_out, const Epi& e) {
  const uint32_t sz = load_bytes(a, g);
  const uint32_t off = ring_wait(r, sz);
  if (sz) gemv_item(a, r, l, g, off, vin, part, out, n_out, e);
  __syncthreads();
  ring_release(a, r, sz);
}

// -- prefetching the next stages' operands into L2 --------------------------

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// stage g of layer l: the epilogue's scale and bias of the block's item
// and, m >= 0, LayerNorm m's weight and bias (lines of 32 floats)
__device__ void prefetch_params(const MegaArgs& a, int l, int g, int m) {
  if (l >= a.n_layer) return;
  const int tid = threadIdx.x, c = a.item_c[g];
  const float *sc, *bi;
  stage_params(a, l, g, sc, bi);
  if ((int)blockIdx.x < a.items[g] && 32 * tid < c) {
    const int n = blockIdx.x * c + 32 * tid;
    prefetch_l2(sc + n);
    prefetch_l2(bi + n);
  }
  if (m >= 0 && 32 * tid < 2 * a.d)
    prefetch_l2(a.ln_par + ((size_t)l * 6 + 2 * m) * a.d + 32 * tid);
}

// the block's attention item of this stage (item blockIdx.x, if any): the
// 64 rows of its K and V slice, 128 bytes a thread
template <typename CT>
__device__ void prefetch_attn(const CT* cache, int l, int H, int S, int n_cols,
                              int nslices) {
  const int it = blockIdx.x;
  if (it >= H * nslices) return;
  const int h = it / nslices, c0 = (it % nslices) * kSplit;
  const int n = min(n_cols, c0 + kSplit) - c0;
  constexpr int kPerLine = 128 / sizeof(CT);
  const int row = threadIdx.x / 4, line = threadIdx.x % 4;
  if (n <= 0 || line * kPerLine >= n) return;
  const size_t head = (size_t)kD * S;
  const size_t off = (size_t)row * S + c0 + line * kPerLine;
  prefetch_l2(cache + ((size_t)l * 2 * H + h) * head + off);
  prefetch_l2(cache + ((size_t)(l * 2 + 1) * H + h) * head + off);
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

// One attention item: q (unscaled, [kD] of q_src) against columns [c0, c1)
// of one head's K and V [kD, S]; writes max, sum and P*V.  The cache is
// read in 4-byte words of kVec columns (2 bf16 or 4 int8; S and c0
// multiples of kVec).  Scores: thread t takes word t % (256 / kVec) of
// kVec rows-groups' rows (64 / kVec rows each), its q and keys requested
// in one round, and the groups' partial dots meet in `sp` (shared memory,
// kVec x 256 floats) in group order.  P*V: warp w takes rows w, w + 8, ...,
// a lane words lane, lane + 32, ...; the slice of the values requested
// while the block reduces the scores.
template <typename CT>
__device__ void attn_item(const CT* __restrict__ kp, const CT* __restrict__ vp,
                          int S, int c0, int c1, const float* q_src,
                          float qk_scale, float* q_s, float* p_s, float* sp,
                          float* red, float* out) {
  constexpr int kVec = 4 / sizeof(CT);        // columns a word
  constexpr int kWordsRow = kSplit / kVec;    // words of a 256-column row
  constexpr int kRowsG = kD / kVec;           // rows of a score group
  constexpr int kRows = kD / kWarps;          // P*V rows a warp
  constexpr int kWordsLane = kWordsRow / 32;  // P*V words a lane
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = c1 - c0;
  const float qv = tid < kD ? __ldcg(q_src + tid) : 0.f;
  const int wi = tid % kWordsRow, rg = tid / kWordsRow;
  const bool wlive = kVec * wi < n;
  uint32_t kw[kRowsG];
#pragma unroll
  for (int r = 0; r < kRowsG; ++r)
    kw[r] = wlive ? *reinterpret_cast<const uint32_t*>(
                        kp + (size_t)(rg * kRowsG + r) * S + c0 + kVec * wi)
                  : 0u;
  if (tid < kD) q_s[tid] = qv;
  __syncthreads();
  float dot[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) dot[e] = 0.f;
#pragma unroll
  for (int r = 0; r < kRowsG; ++r) {
    float f[kVec];
    word_f(kw[r], kp, f);
    const float qd = q_s[rg * kRowsG + r];
#pragma unroll
    for (int e = 0; e < kVec; ++e) dot[e] += qd * f[e];
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) sp[rg * kSplit + kVec * wi + e] = dot[e];
  // the values, requested before the block reduces the scores
  uint32_t vw[kRows][kWordsLane];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int jj = 0; jj < kWordsLane; ++jj) {
      const int j = kVec * (lane + 32 * jj);
      vw[i][jj] = j < n ? *reinterpret_cast<const uint32_t*>(
                              vp + (size_t)(warp + i * kWarps) * S + c0 + j)
                        : 0u;
    }
  __syncthreads();
  const bool valid = tid < n;
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
  for (int i = 0; i < kRows; ++i) {
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
    if (lane == 0) __stcg(out + 2 + warp + i * kWarps, part);
  }
  if (tid == 0) {
    __stcg(out, m);
    __stcg(out + 1, l);
  }
  __syncthreads();
}

// The last item of head h to finish combines the head's ns slices into
// its 64 values of the context row (`ctx`, rounded to bf16): the slices'
// max M, weights exp(m_s - M) and weighted sum of their sums; with the
// fresh column (self-attention: q and the fresh k, v from qkv, their score
// in fp32; with an int8 cache (CT) the score times scale * kscale and the
// context times kscale) or without (cross: the context times kscale /
// denominator).  The slices' partials, q, k and v are requested in one
// round.
template <typename CT>
__device__ void finish_head(const MegaArgs& a, const float* att_h, int ns,
                            int h, const float* qkv, float kscale,
                            float* fin) {
  const int tid = threadIdx.x, lane = tid & 31;
  const bool self = qkv != nullptr;
  const bool qself = self && sizeof(CT) == 1;   // the int8 self cache
  float* wts = fin + 4;                      // [kMaxSplits]
  float pv[kMaxSplits];
  float vf = 0.f;
  if (tid < kD) {
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < ns) pv[s] = __ldcg(att_h + s * kAtt + 2 + tid);
    if (self) vf = __ldcg(qkv + 2 * a.d + h * kD + tid);
  }
  if (tid < 32) {
    const float* e = att_h + lane * kAtt;
    const float ms = lane < ns ? __ldcg(e) : kNeg;
    const float ls = lane < ns ? __ldcg(e + 1) : 0.f;
    float qk = 0.f;
    if (self) {
      const float* q = qkv + h * kD;
      qk = __ldcg(q + lane) * __ldcg(q + a.d + lane) +
           __ldcg(q + lane + 32) * __ldcg(q + a.d + lane + 32);
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
  if (tid < kD) {
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < ns) acc += pv[s] * wts[s];
    const float v =
        qself ? bf16r((acc * fin[0] * kscale + vf * (kscale * fin[1])) /
                      fin[2])
        : self ? bf16r((acc * fin[0] + vf * fin[1]) / fin[2])
               : bf16r(acc * (kscale / fin[2]));
    __stcg(a.ctx + h * kD + tid, v);
  }
  __syncthreads();
}

// An attention stage: every item (h, s) of this block, then, for the
// last of a head's items to finish (an arrival counted on the head's
// counter; a head of one slice needs none), the head's context.
template <typename CT>
__device__ void attn_stage(const MegaArgs& a, const CT* cache, int l,
                           int S, int n_cols, int ns, const float* q_row,
                           float qk_scale, const float* qkv, float kscale,
                           unsigned int* count, float* q_s, float* p_s,
                           float* sp, float* red, float* fin, int* last_s) {
  const int H = a.n_head;
  const size_t head = (size_t)kD * S;
  for (int it = blockIdx.x; it < H * ns; it += gridDim.x) {
    const int h = it / ns, s = it % ns;
    const float* att_h = a.att + (size_t)h * ns * kAtt;
    attn_item<CT>(cache + ((size_t)l * 2 * H + h) * head,
                  cache + ((size_t)(l * 2 + 1) * H + h) * head, S,
                  s * kSplit, min(n_cols, (s + 1) * kSplit),
                  q_row + h * kD, qk_scale, q_s, p_s, sp, red,
                  a.att + ((size_t)h * ns + s) * kAtt);
    if (ns > 1) {
      // the item's partial, then its arrival (release); the last to
      // arrive reads every slice's (acquire)
      if (threadIdx.x == 0) {
        __threadfence();
        *last_s = atomicAdd(count + h, 1u) == (unsigned int)(ns - 1);
        __threadfence();
      }
      __syncthreads();
      if (!*last_s) continue;
    }
    finish_head<CT>(a, att_h, ns, h, qkv, kscale, fin);
  }
}

// the dynamic shared memory: the residual row, the input row (padded), a
// vector's sum each of the largest item (or an attention item's partial
// dots), then the ring
struct Smem {
  size_t vin, part, ring;
};

__host__ __device__ inline Smem smem_layout(const MegaArgs& a) {
  size_t vin_n = 0, part_n = 0;
  for (int g = 0; g < kStages; ++g) {
    const size_t k = a.item_k[g];
    vin_n = vin_n > k ? vin_n : k;
    const size_t p = (size_t)a.item_c[g] * (k / 16);
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

// CT: the cross cache's element type, ST: the self cache's
template <typename CT, typename ST>
__global__ void __launch_bounds__(kThreads, 1)
megakernel(const MegaArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem lay = smem_layout(a);
  float* xs = reinterpret_cast<float*>(smem);             // [d] residual
  float* vin = reinterpret_cast<float*>(smem + lay.vin);  // the input row
  float* part = reinterpret_cast<float*>(smem + lay.part);
  __shared__ float red[kWarps];
  __shared__ float p_s[kSplit];
  __shared__ float q_s[kD];
  __shared__ float fin[4 + kMaxSplits];     // a head's finish: alpha, pf,
                                            // denominator, weights
  __shared__ int last_s;
  __shared__ __align__(8) uint64_t bars[kSlots];

  const int tid = threadIdx.x;
  const int d = a.d, H = a.n_head, S = a.s_self, Sc = a.s_cross;
  const int nf = a.nf;
  const int n_valid = min(max(a.seq_len[0] - 1, 0), S);  // cache columns
  const int ns = max(1, (n_valid + kSplit - 1) / kSplit);
  const int nsc = (Sc + kSplit - 1) / kSplit;
  constexpr bool kSelfInt8 = sizeof(ST) == 1;
  const ST* selfc = static_cast<const ST*>(a.self_cache);
  const CT* crossc = static_cast<const CT*>(a.cross_cache);
  const __nv_bfloat16* x_in = static_cast<const __nv_bfloat16*>(a.x);
  unsigned int gen = 0;                   // the barrier counter's target

  Ring ring{reinterpret_cast<int8_t*>(smem + lay.ring), bars,
            (uint32_t)a.ring_bytes, 0u, 0u, 0, 0, a.n_layer * kStages};
  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          smem_u32(&bars[i])));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    ring_pump(a, ring);
  }
  for (int i = tid; i < d; i += kThreads) xs[i] = to_f(x_in[i]);
  __syncthreads();

  // The layer as a loop over its 8 stages, each component written once:
  // the kernel's code has to stay small for the instruction cache (written
  // out stage by stage it is twice as large, and every stage runs from a
  // cold cache).  Stage st ends with GEMV g (none for the attention stages
  // 1 and 4) and a grid barrier:
  //   0. the previous layer's fc2 into the residual; LN1; q, k, v -> A
  //      (and the fresh K/V out)
  //   1. self-attention slices over the cache; each head's last slice
  //      combines them with the fresh column -> ctx
  //   2. out-projection of ctx -> B
  //   3. residual; LN2; cross-q -> A
  //   4. cross-attention slices; each head's last slice combines them,
  //      times kscale / denominator -> ctx
  //   5. cross-out of ctx -> B
  //   6. residual; LN3; fc1 and its GELU -> A (nf * d outputs)
  //   7. fc2 (K = nf * d) over fc1's finished row -> B
  Epi ep;
  for (int l = 0; l < a.n_layer; ++l) {
    const float* ln = a.ln_par + (size_t)l * 6 * d;
    const float kscale = a.cross_scale ? a.cross_scale[l] : 1.f;
    const float kqo = kSelfInt8 ? a.kv_qo[l] : 1.f;
    for (int st = 0; st < kLayerStages; ++st) {
      const int g = st == 0 ? kQkv : st == 2 ? kDense : st == 3 ? kCrossQ
                  : st == 5 ? kCrossDense : st == 6 ? kFc1
                  : st == 7 ? kFc2 : -1;
      const int n_out = g == kQkv ? 3 * d : g == kFc1 ? nf * d : d;
      if (g >= 0) epi_load(a, l, g, n_out, ep);
      if (st == 0 || st == 3 || st == 6) {
        const int m = st / 3;                 // LayerNorm m
        residual_ln(st == 0 && l == 0 ? nullptr : a.act_b,
                    ln + 2 * m * d, ln + (2 * m + 1) * d, xs, vin, d, a.eps,
                    red);
      } else if (st == 2 || st == 5 || st == 7) {
        // the finished row the GEMV reads: the context, or GELU(fc1)
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
        __syncthreads();
      } else if (st == 1) {
        attn_stage<ST>(a, selfc, l, S, n_valid, ns, a.act_a,
                       kSelfInt8 ? a.scale * kqo : a.scale, a.act_a, kqo,
                       a.heads + (size_t)l * H, q_s, p_s, part, red, fin,
                       &last_s);
      } else {
        attn_stage<CT>(a, crossc, l, Sc, Sc, nsc, a.act_a, a.scale * kscale,
                       nullptr, kscale,
                       a.heads + (size_t)(a.n_layer + l) * H, q_s, p_s,
                       part, red, fin, &last_s);
      }
      if (g >= 0) {
        const bool to_a = g == kQkv || g == kCrossQ || g == kFc1;
        gemv_stage(a, ring, l, g, vin, part, to_a ? a.act_a : a.act_b,
                   n_out, ep);
      }
      // what the stages after the barrier read from memory, into L2
      if (st == 0) {
        prefetch_attn(selfc, l, H, S, n_valid, ns);
        prefetch_params(a, l, kDense, -1);
      } else if (st == 2) {
        prefetch_attn(crossc, l, H, Sc, Sc, nsc);
      } else if (st != 7) {
        const int gn = st == 1 ? kCrossQ : st == 3 ? kCrossDense
                     : st == 4 ? kFc1 : st == 5 ? kFc2 : kQkv;
        const int m = st == 1 ? 1 : st == 4 ? 2 : st == 6 ? 0 : -1;
        prefetch_params(a, st == 6 ? l + 1 : l, gn, m);
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

// the plan checked against the model's widths and the grid: per stage,
// items of c columns covering its columns, at most one a block, K a
// multiple of 16, the tiles contiguous in stage order
bool plan_ok(const MegaArgs* a, int grid) {
  const long long cols[kStages] = {3LL * a->d, a->d, a->d, a->d,
                                   (long long)a->nf * a->d, a->d};
  const int ks[kStages] = {a->d, a->d, a->d, a->d, a->d, a->nf * a->d};
  long long off = 0;
  for (int g = 0; g < kStages; ++g) {
    const long long c = a->item_c[g], n = a->items[g];
    if (c < 1 || c > kWarps * kColsWarp || n < 1 || n > grid ||
        c * n < cols[g] ||
        c * (n - 1) >= cols[g] || a->item_k[g] != ks[g] ||
        ks[g] % 16 || a->tile_off[g] != off)
      return false;
    off += c * n * ks[g];
  }
  return off == a->layer_bytes;
}

template <typename CT, typename ST>
int launch(const MegaArgs* a, void* stream) {
  auto kernel = megakernel<CT, ST>;
  cudaError_t e;
  int dev = 0, sms = 0, coop = 0, optin = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (!coop) return (int)cudaErrorNotSupported;
  const int grid = sms;              // one block per SM, all co-resident
  if (!plan_ok(a, grid)) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  if ((e = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess) return (int)e;
  // the ring takes what the block's shared memory has left
  const size_t smem = (size_t)optin - fa.sharedSizeBytes;
  const Smem lay = smem_layout(*a);
  MegaArgs args = *a;
  long long ring = ((long long)smem - (long long)lay.ring) / 16 * 16;
  // the plan's cap on the ring (0: all that is left)
  if (a->ring_bytes > 0 && a->ring_bytes < ring) ring = a->ring_bytes / 16 * 16;
  int largest = 0;
  for (int g = 0; g < kStages; ++g)
    largest = max(largest, a->item_c[g] * a->item_k[g]);
  if (ring < largest) return (int)cudaErrorInvalidValue;
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

}  // namespace

extern "C" {

// Returns 0 when the cooperative launch was enqueued, else the CUDA error
// (cudaErrorInvalidValue for shapes or a plan it does not take).
int decoder_megakernel(const MegaArgs* a, void* stream) {
  if (a->d % kD || a->d / kD > kMaxHeads || a->n_head * kD != a->d ||
      a->s_cross > kMaxSplits * kSplit || a->s_self > kMaxSplits * kSplit ||
      a->nf < 1 || a->d > kPer * kThreads || a->nf * a->d > kPerFc * kThreads ||
      a->s_self % (a->self_int8 ? 4 : 2) ||
      a->s_cross % (a->cross_int8 ? 4 : 2) ||
      (a->self_int8 && (!a->kv_oq || !a->kv_qo)))
    return (int)cudaErrorInvalidValue;
  if (a->self_int8)
    return a->cross_int8 ? launch<int8_t, int8_t>(a, stream)
                         : launch<__nv_bfloat16, int8_t>(a, stream);
  return a->cross_int8 ? launch<int8_t, __nv_bfloat16>(a, stream)
                       : launch<__nv_bfloat16, __nv_bfloat16>(a, stream);
}

}  // extern "C"
