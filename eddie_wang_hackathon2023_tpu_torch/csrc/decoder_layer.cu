// The whole decode step of a Whisper decoder (every layer) in ONE launch,
// at batch 1 with int8 weight-only panels.
//
// Replaces the TPU kernel eddie_wang_hackathon2023_tpu/ops/
// pallas_decoder_layer.py:306 `_kernel` (entry `fused_decoder_stack`,
// :865) in the modes of the Whisper int8 recipe: LayerNorm, the q/k/v,
// out, cross-q, cross-out, fc1 and fc2 GEMVs from the packed int8 K-major
// [d, d] panels (per-channel scales), self-attention over the bf16
// seq-minor cache with the fresh token's K/V in fp32, cross-attention over
// the int8 (or bf16) cross cache with per-layer scales, tanh GELU and the
// bf16 residual stream.  It returns the hidden state before the final LN
// and every layer's fresh K/V; it does not write the cache.
//
// Bound: bytes.  A step reads the whole weight image once (14 panels of
// d*d int8 per layer, 734 MB at large-v2) plus the cross cache (123 MB)
// and does about 2 flops per weight byte.  The TPU kernel walked a
// (layer, stage) grid in order with the hidden state in VMEM and a ring of
// panel DMAs.  On Hopper the blocks of a grid run in parallel, so here:
//   * one persistent grid, one block per SM, all co-resident (cooperative
//     launch); a grid-wide barrier (a generation counter in device memory,
//     with device-scope fences) separates dependent stages, 8 per layer;
//   * each GEMV stage splits its panels into items of 32 output columns by
//     a quarter of K; a block reads its item's rows with 16-byte loads,
//     accumulates in fp32 and writes the partial sums; the stage after the
//     barrier adds the quarters in order and applies scale and bias;
//   * every block keeps the residual row in shared memory and recomputes
//     the LayerNorm and residual updates itself (identical arithmetic in
//     every block), which saves a barrier per update;
//   * attention splits heads and 256-column slices of the cache over the
//     blocks (one column per thread); each item writes its max, sum and
//     P*V partial, and the stage after the barrier combines the slices and
//     adds the fresh token's column;
//   * data written before a barrier is read after it with L1-bypassing
//     loads (__ldcg), so no block reads a stale line.
// Rounding points follow the TPU kernel: GEMV sums in fp32, scaled in
// fp32, rounded to bf16, plus the bias rounded to bf16 (:500-508,
// :765-766); LayerNorm in fp32, rounded (:416-427); the residual in bf16;
// P rounded to bf16 before P*V (:631-634); the cross context times
// kscale / denominator at the end (:641-647); the fresh self score and
// value in fp32 (:700-746); fc2's panels summed in fp32 before the scale
// (:797-809).  Making it fast (TMA weight streaming, fewer barriers) is
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// the kernel's operands, filled by the Python wrapper (a ctypes Structure
// of the same layout) and passed by value
struct MegaArgs {
  const void* x;               // [d] bf16, embedded token + position
  const int8_t* wblob;         // [L, npan, d, d] int8 K-major panels
  const float* pair_scale;     // [L, 4, d]: q, k, v, cross-q
  const float* pair_bias;
  const float* flat_scale;     // [L, nflat, d]: dense, cross-dense, fc1.., fc2
  const float* flat_bias;
  const float* ln_par;         // [L, 6, d]: weight, bias of the three LNs
  const void* self_cache;      // [L, 1, 2, H, D, S] bf16
  const void* cross_cache;     // [L, 1, 2, H, D, Sc] int8 or bf16
  const float* cross_scale;    // [L] or null
  const int* seq_len;          // [1], including the fresh token
  void* hid;                   // [d] bf16 out
  void* fresh;                 // [L, 2, H, D] bf16 out
  float* part_a;               // GEMV partials, ping ...
  float* part_b;               // ... and pong
  float* att;                  // attention partials [H, splits, kAtt]
  unsigned int* barrier;       // [2] zeros: arrivals, generation
  int n_layer, d, n_head, s_self, s_cross, npan, nflat, nf;
  int p_qkv, p_dense, p_crossq, p_crossdense, p_fc1, p_fc2;
  int f_dense, f_crossdense, f_fc1, f_fc2;
  int cross_int8;
  float scale, eps;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kD = 64;           // head dim
constexpr int kTile = 32;        // output columns of one GEMV item
constexpr int kKSplit = 4;       // K quarters of one GEMV panel
constexpr int kSplit = kThreads; // cache columns of one attention item
constexpr int kMaxHeads = 32;
constexpr int kMaxSplits = 8;
constexpr int kAtt = kD + 2;     // one attention partial: max, sum, P*V
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

// Grid-wide barrier of a co-resident grid.  The generation is read before
// arriving: it can only move once every block, this one included, arrived.
__device__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();                   // this block's writes, then arrive
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// sum over the K quarters of output n of panel slot `slot`
__device__ __forceinline__ float part_sum(const float* part, int slot, int n,
                                          int d) {
  float s = 0.f;
#pragma unroll
  for (int ks = 0; ks < kKSplit; ++ks)
    s += __ldcg(part + ((size_t)slot * kKSplit + ks) * d + n);
  return s;
}

// fp32 sum * fp32 scale, rounded, plus the bias rounded (bf16 arithmetic)
__device__ __forceinline__ float affine(float acc, float s, float b) {
  return bf16r(bf16r(acc * s) + bf16r(b));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x *
         (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

// out = bf16(LayerNorm(xs) * w + b), statistics in fp32
__device__ void layer_norm(const float* xs, float* out, const float* w,
                           const float* b, int d, float eps, float* red) {
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) s += xs[i];
  const float mean = block_reduce<false>(s, red) / d;
  float v = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float c = xs[i] - mean;
    v += c * c;
  }
  const float r = rsqrtf(block_reduce<false>(v, red) / d + eps);
  for (int i = threadIdx.x; i < d; i += kThreads)
    out[i] = bf16r((xs[i] - mean) * r * w[i] + b[i]);
  __syncthreads();
}

// out[ct*32 + j] = sum_{k in [k0, k1)} vin[k] * W[k, ct*32 + j]: 128 row
// groups x 2 column halves of 16 bytes each
__device__ void gemv_tile(const int8_t* __restrict__ W, const float* vin,
                          int d, int ct, int k0, int k1, float* out,
                          float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kg = tid >> 1, n0 = ct * kTile + (tid & 1) * 16;
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int k = k0 + kg; k < k1; k += kThreads / 2) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(W + (size_t)k * d + n0));
    const int8_t* wb = reinterpret_cast<const int8_t*>(&w);
    const float xv = vin[k];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] += xv * (float)wb[i];
  }
  // the 16 row groups of a warp that share a column half
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int o = 2; o < 32; o <<= 1)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  }
  if (lane < 2) {
#pragma unroll
    for (int i = 0; i < 16; ++i) red[warp * kTile + lane * 16 + i] = acc[i];
  }
  __syncthreads();
  if (tid < kTile) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * kTile + tid];
    __stcg(out + ct * kTile + tid, s);
  }
  __syncthreads();
}

// The GEMV of vin with n_pan consecutive panels from `first` of one layer,
// partial sums into part slots 0..n_pan-1.
__device__ void gemv_stage(const int8_t* wl, int first, int n_pan,
                           const float* vin, int d, float* part, float* red) {
  const int n_ct = d / kTile, kc = d / kKSplit;
  const int n_items = n_pan * n_ct * kKSplit;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int p = it / (n_ct * kKSplit), rem = it % (n_ct * kKSplit);
    const int ct = rem / kKSplit, ks = rem % kKSplit;
    gemv_tile(wl + (size_t)(first + p) * d * d, vin, d, ct, ks * kc,
              (ks + 1) * kc, part + ((size_t)p * kKSplit + ks) * d, red);
  }
}

// One attention item: q (unscaled, [kD] in shared memory) against columns
// [c0, c1) of one head's K and V [kD, S]; writes max, sum and P*V.
template <typename CT>
__device__ void attn_item(const CT* __restrict__ kp, const CT* __restrict__ vp,
                          int S, int c0, int c1, const float* q_s,
                          float qk_scale, float* p_s, float* red,
                          float* out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = c0 + tid;
  float s = kNeg;
  if (col < c1) {
    float dot = 0.f;
#pragma unroll 16
    for (int dd = 0; dd < kD; ++dd) dot += q_s[dd] * to_f(kp[(size_t)dd * S + col]);
    s = dot * qk_scale;
  }
  const float m = block_reduce<true>(s, red);
  const float p = col < c1 ? expf(s - m) : 0.f;
  const float l = block_reduce<false>(p, red);
  p_s[tid] = bf16r(p);
  __syncthreads();
  const int n = c1 - c0;
  for (int dd = warp; dd < kD; dd += kWarps) {
    const CT* vr = vp + (size_t)dd * S + c0;
    float part = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float pj = p_s[j];
      // a masked column has p == 0 and adds nothing, even if not finite
      part += pj != 0.f ? pj * to_f(vr[j]) : 0.f;
    }
    part = warp_sum(part);
    if (lane == 0) __stcg(out + 2 + dd, part);
  }
  if (tid == 0) {
    __stcg(out, m);
    __stcg(out + 1, l);
  }
  __syncthreads();
}

// Per head h < H: the weights exp(m_s - M) of its ns slices (into wts),
// returns M and the weighted sum of the slices' sums (lanes agree).
__device__ __forceinline__ void combine_stats(const float* att, int h, int ns,
                                              float* wts, float& M,
                                              float& Lsum) {
  M = kNeg;
  for (int s = 0; s < ns; ++s)
    M = fmaxf(M, __ldcg(att + ((size_t)h * ns + s) * kAtt));
  Lsum = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float* e = att + ((size_t)h * ns + s) * kAtt;
    const float w = expf(__ldcg(e) - M);
    if ((threadIdx.x & 31) == 0) wts[h * kMaxSplits + s] = w;
    Lsum += __ldcg(e + 1) * w;
  }
}

template <typename CT>
__global__ void __launch_bounds__(kThreads, 1)
megakernel(const MegaArgs a) {
  extern __shared__ float smem[];
  float* xs = smem;              // [d] residual row (bf16 values)
  float* vin = smem + a.d;       // [d] GEMV input row
  __shared__ float red[kWarps * kTile];
  __shared__ float p_s[kSplit];
  __shared__ float q_s[kD];
  __shared__ float wts[kMaxHeads * kMaxSplits];
  __shared__ float alpha_s[kMaxHeads], pf_s[kMaxHeads], den_s[kMaxHeads];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = a.d, H = a.n_head, S = a.s_self, Sc = a.s_cross;
  const int nf = a.nf;
  const int n_valid = min(max(a.seq_len[0] - 1, 0), S);  // cache columns
  const int ns = max(1, (n_valid + kSplit - 1) / kSplit);
  const int nsc = (Sc + kSplit - 1) / kSplit;
  const __nv_bfloat16* selfc = static_cast<const __nv_bfloat16*>(a.self_cache);
  const CT* crossc = static_cast<const CT*>(a.cross_cache);
  __nv_bfloat16* fresh = static_cast<__nv_bfloat16*>(a.fresh);
  const __nv_bfloat16* x_in = static_cast<const __nv_bfloat16*>(a.x);

  for (int i = tid; i < d; i += kThreads) xs[i] = to_f(x_in[i]);
  __syncthreads();

  for (int l = 0; l < a.n_layer; ++l) {
    const int8_t* wl = a.wblob + (size_t)l * a.npan * d * d;
    const float* ps = a.pair_scale + (size_t)l * 4 * d;
    const float* pb = a.pair_bias + (size_t)l * 4 * d;
    const float* fs = a.flat_scale + (size_t)l * a.nflat * d;
    const float* fb = a.flat_bias + (size_t)l * a.nflat * d;
    const float* ln = a.ln_par + (size_t)l * 6 * d;

    // 1. the previous layer's fc2 into the residual; LN1; q, k, v -> A
    if (l > 0) {
      const float* fsp = fs - (size_t)a.nflat * d;
      const float* fbp = fb - (size_t)a.nflat * d;
      for (int i = tid; i < d; i += kThreads) {
        float acc = 0.f;
        for (int j = 0; j < nf; ++j) acc += part_sum(a.part_b, j, i, d);
        xs[i] = bf16r(xs[i] + affine(acc, fsp[a.f_fc2 * d + i],
                                     fbp[a.f_fc2 * d + i]));
      }
      __syncthreads();
    }
    layer_norm(xs, vin, ln, ln + d, d, a.eps, red);
    gemv_stage(wl, a.p_qkv, 3, vin, d, a.part_a, red);
    grid_sync(a.barrier);

    // 2. self-attention slices over the cache; the fresh K/V out
    for (int it = blockIdx.x; it < H * ns; it += gridDim.x) {
      const int h = it / ns, s = it % ns;
      if (tid < kD) {
        const int n = h * kD + tid;
        q_s[tid] = affine(part_sum(a.part_a, 0, n, d), ps[n], pb[n]);
        if (s == 0) {
          const size_t f = ((size_t)l * 2 * H + h) * kD + tid;
          fresh[f] = __float2bfloat16(
              affine(part_sum(a.part_a, 1, n, d), ps[d + n], pb[d + n]));
          fresh[f + (size_t)H * kD] = __float2bfloat16(
              affine(part_sum(a.part_a, 2, n, d), ps[2 * d + n],
                     pb[2 * d + n]));
        }
      }
      __syncthreads();
      const size_t head = (size_t)kD * S;
      attn_item<__nv_bfloat16>(
          selfc + ((size_t)l * 2 * H + h) * head,
          selfc + ((size_t)(l * 2 + 1) * H + h) * head, S, s * kSplit,
          min(n_valid, (s + 1) * kSplit), q_s, a.scale, p_s, red,
          a.att + ((size_t)h * ns + s) * kAtt);
    }
    grid_sync(a.barrier);

    // 3. combine the slices with the fresh column; out-projection -> B
    for (int h = warp; h < H; h += kWarps) {
      float M, Lsum;
      combine_stats(a.att, h, ns, wts, M, Lsum);
      float part = 0.f;
      for (int dd = lane; dd < kD; dd += 32) {
        const int n = h * kD + dd;
        const float qv = affine(part_sum(a.part_a, 0, n, d), ps[n], pb[n]);
        const float kv = affine(part_sum(a.part_a, 1, n, d), ps[d + n],
                                pb[d + n]);
        part += qv * kv;
      }
      const float sf = warp_sum(part) * a.scale;
      const float m_fin = fmaxf(M, sf);
      const float alpha = expf(M - m_fin), pf = expf(sf - m_fin);
      if (lane == 0) {
        alpha_s[h] = alpha;
        pf_s[h] = pf;
        den_s[h] = Lsum * alpha + pf;
      }
    }
    __syncthreads();
    for (int i = tid; i < d; i += kThreads) {
      const int h = i / kD, dd = i % kD;
      float acc = 0.f;
      for (int s = 0; s < ns; ++s)
        acc += __ldcg(a.att + ((size_t)h * ns + s) * kAtt + 2 + dd) *
               wts[h * kMaxSplits + s];
      const float vf = affine(part_sum(a.part_a, 2, i, d), ps[2 * d + i],
                              pb[2 * d + i]);
      vin[i] = bf16r((acc * alpha_s[h] + vf * pf_s[h]) / den_s[h]);
    }
    __syncthreads();
    gemv_stage(wl, a.p_dense, 1, vin, d, a.part_b, red);
    grid_sync(a.barrier);

    // 4. residual; LN2; cross-q -> A
    for (int i = tid; i < d; i += kThreads)
      xs[i] = bf16r(xs[i] + affine(part_sum(a.part_b, 0, i, d),
                                   fs[a.f_dense * d + i],
                                   fb[a.f_dense * d + i]));
    __syncthreads();
    layer_norm(xs, vin, ln + 2 * d, ln + 3 * d, d, a.eps, red);
    gemv_stage(wl, a.p_crossq, 1, vin, d, a.part_a, red);
    grid_sync(a.barrier);

    // 5. cross-attention slices
    const float kscale = a.cross_scale ? a.cross_scale[l] : 1.f;
    for (int it = blockIdx.x; it < H * nsc; it += gridDim.x) {
      const int h = it / nsc, s = it % nsc;
      if (tid < kD) {
        const int n = h * kD + tid;
        q_s[tid] = affine(part_sum(a.part_a, 0, n, d), ps[3 * d + n],
                          pb[3 * d + n]);
      }
      __syncthreads();
      const size_t head = (size_t)kD * Sc;
      attn_item<CT>(crossc + ((size_t)l * 2 * H + h) * head,
                    crossc + ((size_t)(l * 2 + 1) * H + h) * head, Sc,
                    s * kSplit, min(Sc, (s + 1) * kSplit), q_s,
                    a.scale * kscale, p_s, red,
                    a.att + ((size_t)h * nsc + s) * kAtt);
    }
    grid_sync(a.barrier);

    // 6. combine; context times kscale / denominator; cross-out -> B
    for (int h = warp; h < H; h += kWarps) {
      float M, Lsum;
      combine_stats(a.att, h, nsc, wts, M, Lsum);
      if (lane == 0) den_s[h] = Lsum;
    }
    __syncthreads();
    for (int i = tid; i < d; i += kThreads) {
      const int h = i / kD, dd = i % kD;
      float acc = 0.f;
      for (int s = 0; s < nsc; ++s)
        acc += __ldcg(a.att + ((size_t)h * nsc + s) * kAtt + 2 + dd) *
               wts[h * kMaxSplits + s];
      vin[i] = bf16r(acc * (kscale / den_s[h]));
    }
    __syncthreads();
    gemv_stage(wl, a.p_crossdense, 1, vin, d, a.part_b, red);
    grid_sync(a.barrier);

    // 7. residual; LN3; fc1 -> A (nf panels)
    for (int i = tid; i < d; i += kThreads)
      xs[i] = bf16r(xs[i] + affine(part_sum(a.part_b, 0, i, d),
                                   fs[a.f_crossdense * d + i],
                                   fb[a.f_crossdense * d + i]));
    __syncthreads();
    layer_norm(xs, vin, ln + 4 * d, ln + 5 * d, d, a.eps, red);
    gemv_stage(wl, a.p_fc1, nf, vin, d, a.part_a, red);
    grid_sync(a.barrier);

    // 8. GELU of the fc1 slice an item needs; fc2 -> B (nf panels)
    {
      const int n_ct = d / kTile, kc = d / kKSplit;
      const int n_items = nf * n_ct * kKSplit;
      for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
        const int j = it / (n_ct * kKSplit), rem = it % (n_ct * kKSplit);
        const int ct = rem / kKSplit, ks = rem % kKSplit;
        const int k0 = ks * kc, k1 = k0 + kc;
        const float* fsj = fs + (size_t)(a.f_fc1 + j) * d;
        const float* fbj = fb + (size_t)(a.f_fc1 + j) * d;
        for (int k = k0 + tid; k < k1; k += kThreads)
          vin[k] = bf16r(gelu_tanh(
              affine(part_sum(a.part_a, j, k, d), fsj[k], fbj[k])));
        __syncthreads();
        gemv_tile(wl + (size_t)(a.p_fc2 + j) * d * d, vin, d, ct, k0, k1,
                  a.part_b + ((size_t)j * kKSplit + ks) * d, red);
      }
    }
    grid_sync(a.barrier);
  }

  // the last layer's fc2 into the residual: the hidden state out
  if (blockIdx.x == 0) {
    const size_t off = (size_t)(a.n_layer - 1) * a.nflat * d;
    const float* fs = a.flat_scale + off;
    const float* fb = a.flat_bias + off;
    __nv_bfloat16* hid = static_cast<__nv_bfloat16*>(a.hid);
    for (int i = tid; i < d; i += kThreads) {
      float acc = 0.f;
      for (int j = 0; j < nf; ++j) acc += part_sum(a.part_b, j, i, d);
      hid[i] = __float2bfloat16(
          xs[i] + affine(acc, fs[a.f_fc2 * d + i], fb[a.f_fc2 * d + i]));
    }
  }
}

template <typename CT>
int launch(const MegaArgs* a, void* stream) {
  auto kernel = megakernel<CT>;
  const size_t smem = 2 * (size_t)a->d * sizeof(float);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = sms;              // one block per SM, all co-resident
  MegaArgs args = *a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                  dim3(kThreads), params, smem,
                                  reinterpret_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 when the cooperative launch was enqueued, else the CUDA error.
int decoder_megakernel(const MegaArgs* a, void* stream) {
  if (a->d % (kTile * kKSplit) || a->d / kD > kMaxHeads ||
      a->n_head * kD != a->d || a->s_cross > kMaxSplits * kSplit ||
      a->s_self > kMaxSplits * kSplit)
    return (int)cudaErrorInvalidValue;
  return a->cross_int8 ? launch<int8_t>(a, stream)
                       : launch<__nv_bfloat16>(a, stream);
}

}  // extern "C"
