// A user-written fused multi-head attention for the port's custom-attention
// hook (`ops.flash_attention.set_custom_mha`): q, k, v [B, H, L, 64] in
// bf16 or fp32 -> o [B, H, Lq, 64] in q's dtype, softmax and sums in fp32.
//
// Replaces the repo's Pallas FMHA, examples/custom_kernel/pallas_fmha.py:23
// `_kernel` (`pallas_call` at :89), and computes what it computes:
//   * scores q.k * scale and P*V with fp32 accumulation, online softmax
//     with the running max starting at -1e30;
//   * keys at or past `kv_valid_len` masked; causal, key c of query row r
//     masked unless c <= r (top-left, as the Pallas kernel: it agrees with
//     `functional.causal_bias`'s bottom-right mask only when Lq == Lk);
//   * the output is acc / max(d, 1e-30), so a row with no live key is 0;
//   * key tiles wholly past the valid keys, or wholly above the diagonal,
//     are skipped (a skipped tile would change no sum).
//
// Two kernels, one per entry.
//
// The bf16 entry (`custom_fmha`) runs on the tensor cores, FlashAttention-2's
// register layout on `mma.sync m16n8k16` (bf16 in, fp32 out).  Bound: at the
// encoder's shape, the tensor cores (three bf16 products, below); at a
// prompt prefill of a few rows, the latency of one round of loads.  What
// held the first design back, and what this one does about it:
//   * short calls: a block took 128 query rows whatever Lq was, converted
//     its tiles one element a thread at a time, and computed a 128 x 64
//     score tile for 3 x 3 live scores.  Here a block has ceil(Lq / 16)
//     warps up to 4, each owning 16 query rows (the m of the mma), so
//     Lq <= 64 is one block per (batch, head) (the "short" variant of
//     the wrapper's `fmha_plan`, which passes warps and row blocks to the
//     entry); rows past Lq are zero-filled by the copy and
//     never read from memory or stored; keys past what the block needs are
//     not read, and only whole 16-key steps that hold a live key are
//     multiplied.  Q and the first K/V tile arrive in one round of 16-byte
//     `cp.async`;
//   * long calls: both products ran in fp32 on the CUDA cores and P made a
//     round trip through shared memory.  Here 64 query rows a block (4
//     warps; the "tiled" variant), K and V tiles of 64 keys through shared
//     memory by 16-byte `cp.async`, two stages (the next tile loads during
//     this tile's products, one block barrier a tile); fragments by
//     `ldmatrix`, K as it is, V [key][d] by `ldmatrix.trans`; rows padded
//     to 144 bytes, so every `ldmatrix` is free of bank conflicts; at most
//     128 registers a thread, so four blocks (16 warps) share an SM;
//   * S = Q K^T from bf16 operands with fp32 accumulation (exact products);
//     the masks, the scale times log2(e), the running max and sum act on
//     the accumulator fragments in registers, with shuffles inside the
//     quad of lanes that owns a row; the masked scores are selected, never
//     subtracted, so a row with no live key gives p = 0, not NaN; a tile
//     with no masked key takes a path without the mask, and O and the sum
//     are rescaled only when a row's max moved;
//   * P enters P*V as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi),
//     two `mma` per V fragment, which keeps the product at about fp32
//     accuracy; S's accumulator fragment becomes P's A fragment in
//     registers, without a trip through shared memory;
//   * causal, the blocks with the most key tiles (the last rows) go first.
//   Rows of q, k, v must start on 16 bytes (the wrapper checks the
//   pointers and the strides and raises otherwise).
//
// The fp32 entry (`custom_fmha_f32`, the SmoothQuant encoder's
// [1, 20, 1536, 64], 32 calls an utterance on the custom path) is held to
// 1e-5 of the largest output of the fp32 plain version.  The first design
// ran both products in fp32 on the CUDA cores, each thread an 8 x 8 patch
// from scalar shared loads: shared-load-bound, P through shared memory,
// two blocks an SM.  Here the products run on the tensor cores in 3xTF32:
//   * each fp32 operand is split into tf32 terms hi = rna(x) and
//     lo = rna(x - hi) (to nearest, ties away, 10 mantissa bits: what
//     cvt.rna.tf32.f32 gives, in two integer operations, for the tensor
//     core would otherwise drop the low 13 bits), and every product is
//     lo*hi + hi*lo + hi*hi on mma.sync.m16n8k8.tf32 (the dropped lo*lo is
//     about 2^-22 of it): Q K^T and P V alike; the split-bf16 route of
//     kernel 2's fp32 entry keeps about 16 bits and holds only 1e-4
//     (tests/test_torch_fmha_split.py emulates both against fp64);
//   * the fragments' k index i stands for d (or key) 2i below 4 and
//     2(i - 4) + 1 past it, so S's accumulators are P's A fragment as they
//     lie and K's B fragment is one 8-byte shared load;
//   * the tensor core truncates each sum it accumulates: each tile's P V
//     goes to fresh accumulators, added to O by rounded fp32 adds, so O's
//     truncations do not pile up over the tiles (summed straight into O,
//     the encoder's 24 tiles missed the 1e-5 gate on the card);
//   * the bf16 entry's plan: 1-4 warps of 16 rows a block; K and V tiles
//     of 64 keys in two stages by cp.async, 16 bytes a copy when every row
//     of q, k and v starts on 16 bytes, else 4 (views on 4-byte rows are
//     computed, not refused); Q in stage 1's space until it is split into
//     registers; rows padded so that the 8-byte K loads and the 4-byte V
//     loads are free of bank conflicts; two blocks an SM.
//   The 4 warps of a block each split the K and V values they read: what
//   is left beyond the tensor work (PERF.md).
//
// Inputs may be strided (the last dim contiguous), as the attention layer
// hands them over: views into the fused QKV projection output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kD = 64;                 // head dim
constexpr int kBN = 64;                // keys per tile
constexpr float kNeg = -1e30f;

struct Strides {
  long long b, h, l;                   // in elements; the last dim is 1
};

// -- the bf16 entry: tensor cores --------------------------------------------

constexpr int kMaxWarps = 4;           // 16 query rows a warp, 64 a block
constexpr int kStages = 2;             // K/V tiles in flight
constexpr int kPitch = kD + 8;         // bf16 a staged row: 144 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst, or 16 zero bytes (nothing read) when !live
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// p's two bf16 terms: hi = bf16(p), lo = bf16(p - hi), two values a word
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
}

// at most 128 registers a thread: four blocks of 4 warps an SM
template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32, 4)
fmha_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int H, int Lq, int kv_lim,
                 int causal, Strides sq, Strides sk, Strides sv, Strides so,
                 float scale_log2) {
  constexpr int kBlock = kWarps * 32, kRows = 16 * kWarps;
  extern __shared__ __align__(128) __nv_bfloat16 smem_bf[];
  __nv_bfloat16* const qs = smem_bf;                     // [kRows][kPitch]
  __nv_bfloat16* const ks = qs + kRows * kPitch;         // [kStages][kBN][kPitch]
  __nv_bfloat16* const vs = ks + kStages * kBN * kPitch; // [kStages][kBN][kPitch]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int m_blk = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int row0 = m_blk * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;

  // keys the block needs: the valid ones, causal up to its last live row
  const int n_keys = causal ? min(kv_lim, min(row0 + kRows, Lq)) : kv_lim;
  const int n_tiles = (n_keys + kBN - 1) / kBN;

  // Q rows [row0, row0 + kRows), 16 bytes a copy; rows past Lq zero-filled
  for (int i = tid; i < kRows * 8; i += kBlock) {
    const int r = i >> 3, c = (i & 7) * 8;
    const bool live = row0 + r < Lq;
    cp_async16(qs + r * kPitch + c,
               qb + (live ? (long long)(row0 + r) * sq.l + c : 0), live);
  }
  // tile t's K and V into stage st: the keys up to the block's last needed
  // one rounded up to 16 (those past it zero-filled, so that P*V meets
  // finite zeros there); the 16-key steps past that are not touched
  auto stage_tile = [&](int t, int st) {
    const int n0 = t * kBN;
    const int rows = min(kBN, (n_keys - n0 + 15) & ~15);
    __nv_bfloat16* kd = ks + st * kBN * kPitch;
    __nv_bfloat16* vd = vs + st * kBN * kPitch;
    for (int i = tid; i < rows * 8; i += kBlock) {
      const int r = i >> 3, c = (i & 7) * 8;
      const bool live = n0 + r < n_keys;
      const long long key = live ? n0 + r : 0;
      cp_async16(kd + r * kPitch + c, kb + (live ? key * sk.l + c : 0), live);
      cp_async16(vd + r * kPitch + c, vb + (live ? key * sv.l + c : 0), live);
    }
  };
  // Q and tile 0 in one group; later tiles one group each, issued one
  // tile ahead
  if (n_tiles > 0) stage_tile(0, 0);
  cp_async_commit();

  // this lane's rows (lane / 4 and lane / 4 + 8 of the warp's 16) and the
  // first of its two columns in each 8-column n-tile
  const int wrow0 = row0 + warp * 16;
  const int ra = wrow0 + (lane >> 2), rb = ra + 8;
  const int c2 = (lane & 3) * 2;
  const int lim_a = causal ? min(kv_lim, ra + 1) : kv_lim;
  const int lim_b = causal ? min(kv_lim, rb + 1) : kv_lim;

  uint32_t qf[4][4];                   // Q's A fragments, 4 steps of 16 d
  float acc[8][4];                     // O, 8 n-tiles of 8 d
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // one tile of 64 keys at n0 from the staged kt, vt; kMasked: some key of
  // it is masked for some row of the warp (past the valid keys, above the
  // diagonal, or in a 16-key step not multiplied), and only the first
  // `steps` steps hold a key the block needs
  auto tile = [&](const auto masked_t, int n0, int steps,
                  const __nv_bfloat16* kt, const __nv_bfloat16* vt) {
    constexpr bool kMasked = decltype(masked_t)::value;
    // S = Q K^T: n-tiles of 8 keys, two an ldmatrix
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (!kMasked || np < steps) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3))
                                   * kPitch
                               + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        }
      }
    }
    // scale into the log2 domain; the masked scores are selected out
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] *= scale_log2;
        s[j][e + 2] *= scale_log2;
        if (kMasked) {
          const int col = n0 + j * 8 + c2 + e;
          if (col >= lim_a) s[j][e] = kNeg;
          if (col >= lim_b) s[j][e + 2] = kNeg;
        }
        mx_a = fmaxf(mx_a, s[j][e]);
        mx_b = fmaxf(mx_b, s[j][e + 2]);
      }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    // O and l are rescaled only when a row's max moved
    if (__any_sync(0xffffffffu, mx_a != m_a || mx_b != m_b)) {
      const float alpha_a = ex2(m_a - mx_a), alpha_b = ex2(m_b - mx_b);
      l_a *= alpha_a;
      l_b *= alpha_b;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= alpha_a;
        acc[j][1] *= alpha_a;
        acc[j][2] *= alpha_b;
        acc[j][3] *= alpha_b;
      }
      m_a = mx_a;
      m_b = mx_b;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float pa = ex2(s[j][e] - m_a), pb = ex2(s[j][e + 2] - m_b);
        if (kMasked) {
          const int col = n0 + j * 8 + c2 + e;
          if (col >= lim_a) pa = 0.f;
          if (col >= lim_b) pb = 0.f;
        }
        s[j][e] = pa;
        s[j][e + 2] = pb;
        l_a += pa;
        l_b += pb;
      }
    }
    // O += P V, each 16-key step: P's A fragment from two n-tiles of S, as
    // hi and lo bf16 terms; V's B fragments by ldmatrix.trans; the hi
    // products of the step first, then the lo ones
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (!kMasked || kk < steps) {
        uint32_t ph[4], pl[4], bv[4][4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          ldmatrix_x4_trans(bv[dp], vt + (kk * 16 + (lane & 7)
                                          + ((lane >> 3) & 1) * 8) * kPitch
                                        + dp * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * dp], ph, bv[dp][0], bv[dp][1]);
          mma_bf16(acc[2 * dp + 1], ph, bv[dp][2], bv[dp][3]);
        }
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          mma_bf16(acc[2 * dp], pl, bv[dp][0], bv[dp][1]);
          mma_bf16(acc[2 * dp + 1], pl, bv[dp][2], bv[dp][3]);
        }
      }
    }
  };

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();                // tile t (and Q): the only group left
    __syncthreads();                   // landed for all; tile t - 1 consumed
    if (t + 1 < n_tiles) stage_tile(t + 1, (t + 1) % kStages);
    cp_async_commit();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * kPitch
                                + kk * 16 + (lane >> 4) * 8);
    }
    const int n0 = t * kBN;
    const __nv_bfloat16* kt = ks + (t % kStages) * kBN * kPitch;
    const __nv_bfloat16* vt = vs + (t % kStages) * kBN * kPitch;
    // 16-key steps of this tile that hold a key the block needs; a warp
    // whose rows all lie above the tile (causal) skips it
    const int steps = min(4, (n_keys - n0 + 15) >> 4);
    if (causal && n0 > min(wrow0 + 15, Lq - 1)) continue;
    if (n0 + kBN > kv_lim || (causal && n0 + kBN - 1 > wrow0))
      tile(std::true_type{}, n0, steps, kt, vt);
    else
      tile(std::false_type{}, n0, steps, kt, vt);
  }
  cp_async_wait<0>();                  // no copy outlives the block

  // the row sums over the quad, the normalisation, the bf16 store
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = j * 8 + c2;
    if (ra < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)ra * so.l + d) =
          __floats2bfloat162_rn(acc[j][0] * inv_a, acc[j][1] * inv_a);
    if (rb < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)rb * so.l + d) =
          __floats2bfloat162_rn(acc[j][2] * inv_b, acc[j][3] * inv_b);
  }
}

template <int kWarps>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                int B, int H, int Lq, int kv_lim, int causal,
                const Strides* s, float scale, int row_blocks,
                cudaStream_t st) {
  const int smem = (16 * kWarps + 2 * kStages * kBN) * kPitch *
                   (int)sizeof(__nv_bfloat16);
  // the shared memory this instantiation may take, raised once
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        fmha_bf16_kernel<kWarps>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  fmha_bf16_kernel<kWarps><<<dim3(row_blocks, B * H), kWarps * 32, smem,
                             st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, Lq, kv_lim, causal != 0, s[0], s[1], s[2], s[3],
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// -- the fp32 entry: 3xTF32 on the tensor cores -----------------------------

constexpr int kKP = kD + 8;            // K row pitch in floats: 8-byte B loads
constexpr int kVP = kD + 4;            // V row pitch: two key rows a B fragment
constexpr int kQP = kD + 8;            // Q row pitch
constexpr int kStageFloats = kBN * (kKP + kVP);
constexpr int kSmemF32 = 2 * kStageFloats * (int)sizeof(float);

// x rounded to tf32 (10 mantissa bits) to nearest, ties away from zero:
// what cvt.rna.tf32.f32 gives for a finite x, in two integer operations
// (the instruction compiles to a longer sequence that also handles NaN);
// the tensor core would otherwise drop the low 13 bits
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as hi + lo, both tf32: hi = rna(x), lo = rna(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// c += a b, m16n8k8, tf32 operands, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b at fp32 accuracy from split operands, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, a_lo, bh0, bh1);
  mma_tf32(c, a_hi, bl0, bl1);
  mma_tf32(c, a_hi, bh0, bh1);
}

// 4 bytes from src to dst, or 4 zero bytes (nothing read) when !live
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(live ? 4 : 0));
}

// One block per 16 * kWarps query rows; warp w owns rows 16w..16w + 15.
// m16n8k8's k index i of a fragment stands for d (or key) 2i for i < 4
// and 2(i - 4) + 1 past it: then S's accumulators (rows g, g + 8; keys
// 2t, 2t + 1) are P's A fragment as they lie, and K's B fragment is one
// 8-byte shared load.  kVec16: every row of q, k and v starts on 16 bytes,
// and the copies move 16 bytes; otherwise 4.
template <int kWarps, bool kVec16>
__global__ void __launch_bounds__(kWarps * 32, 2)
fmha_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int Lq, int kv_lim, int causal, Strides sq, Strides sk,
                 Strides sv, Strides so, float scale_log2) {
  constexpr int kBlock = kWarps * 32, kRows = 16 * kWarps;
  constexpr int kE = kVec16 ? 4 : 1;   // floats a copy
  constexpr int kC = kD / kE;          // copies a row
  extern __shared__ __align__(128) float smem_f[];
  // stage st: K [kBN][kKP], then V [kBN][kVP]; Q [kRows][kQP] lies in
  // stage 1's K, read into registers before stage 1 is first filled
  float* const qs = smem_f + kStageFloats;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int m_blk = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int row0 = m_blk * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  auto copy = [&](float* dst, const float* src, bool live) {
    if constexpr (kVec16)
      cp_async16(dst, src, live);
    else
      cp_async4(dst, src, live);
  };
  // keys the block needs: the valid ones, causal up to its last live row
  const int n_keys = causal ? min(kv_lim, min(row0 + kRows, Lq)) : kv_lim;
  const int n_tiles = (n_keys + kBN - 1) / kBN;

  for (int i = tid; i < kRows * kC; i += kBlock) {
    const int r = i / kC, c = (i % kC) * kE;
    const bool live = row0 + r < Lq;
    copy(qs + r * kQP + c, qb + (live ? (long long)(row0 + r) * sq.l : 0) + c,
         live);
  }
  // tile t's K and V into stage st: the keys up to the block's last needed
  // one rounded up to 8 (those past it zero-filled); the 8-key steps past
  // that are not touched
  auto stage_tile = [&](int t, int st) {
    const int n0 = t * kBN;
    const int rows = min(kBN, (n_keys - n0 + 7) & ~7);
    float* kd = smem_f + st * kStageFloats;
    float* vd = kd + kBN * kKP;
    for (int i = tid; i < rows * kC; i += kBlock) {
      const int r = i / kC, c = (i % kC) * kE;
      const bool live = n0 + r < n_keys;
      const long long key = live ? n0 + r : 0;
      copy(kd + r * kKP + c, kb + key * sk.l + c, live);
      copy(vd + r * kVP + c, vb + key * sv.l + c, live);
    }
  };
  if (n_tiles > 0) stage_tile(0, 0);
  cp_async_commit();

  const int wrow0 = row0 + warp * 16;
  const int ra = wrow0 + g, rb = ra + 8;
  const int lim_a = causal ? min(kv_lim, ra + 1) : kv_lim;
  const int lim_b = causal ? min(kv_lim, rb + 1) : kv_lim;

  uint32_t qh[8][4], ql[8][4];         // Q's A fragments as tf32 terms
  float acc[8][4];                     // O, 8 n-tiles of 8 d
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // one tile of 64 keys at n0 from the staged kt, vt; kMasked: some key of
  // it is masked for some row of the warp, and only the first `steps`
  // 8-key steps hold a key the block needs
  auto tile = [&](const auto masked_t, int n0, int steps, const float* kt,
                  const float* vt) {
    constexpr bool kMasked = decltype(masked_t)::value;
    // S = Q K^T: n-tiles of 8 keys; K's B fragment is keys g, d 2t and
    // 2t + 1 of the step
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (!kMasked || nt < steps) {
          const float2 x = *reinterpret_cast<const float2*>(
              kt + (nt * 8 + g) * kKP + ks * 8 + 2 * t4);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(x.x, bh0, bl0);
          split_tf32(x.y, bh1, bl1);
          mma_3xtf32(s[nt], qh[ks], ql[ks], bh0, bh1, bl0, bl1);
        }
      }
    }
    // scale into the log2 domain; the masked scores are selected out
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] *= scale_log2;
        s[j][e + 2] *= scale_log2;
        if (kMasked) {
          const int col = n0 + j * 8 + 2 * t4 + e;
          if (col >= lim_a) s[j][e] = kNeg;
          if (col >= lim_b) s[j][e + 2] = kNeg;
        }
        mx_a = fmaxf(mx_a, s[j][e]);
        mx_b = fmaxf(mx_b, s[j][e + 2]);
      }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    // O and l are rescaled only when a row's max moved
    if (__any_sync(0xffffffffu, mx_a != m_a || mx_b != m_b)) {
      const float alpha_a = ex2(m_a - mx_a), alpha_b = ex2(m_b - mx_b);
      l_a *= alpha_a;
      l_b *= alpha_b;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= alpha_a;
        acc[j][1] *= alpha_a;
        acc[j][2] *= alpha_b;
        acc[j][3] *= alpha_b;
      }
      m_a = mx_a;
      m_b = mx_b;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float pa = ex2(s[j][e] - m_a), pb = ex2(s[j][e + 2] - m_b);
        if (kMasked) {
          const int col = n0 + j * 8 + 2 * t4 + e;
          if (col >= lim_a) pa = 0.f;
          if (col >= lim_b) pb = 0.f;
        }
        s[j][e] = pa;
        s[j][e + 2] = pb;
        l_a += pa;
        l_b += pb;
      }
    }
    // O += P V.  P's A fragment of 8-key step kk is S's n-tile kk (keys
    // 2t, 2t + 1 of rows g, g + 8); V's B fragment keys 2t and 2t + 1 of
    // the step at d 8 dt + g; both split into tf32 terms.  The tensor core
    // truncates each sum it accumulates, so the tile's products go to
    // fresh accumulators, which join O by rounded adds: O's truncations do
    // not pile up over the tiles.
    float part[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (!kMasked || kk < steps) {
        uint32_t ph[4], pl[4];
        split_tf32(s[kk][0], ph[0], pl[0]);
        split_tf32(s[kk][2], ph[1], pl[1]);
        split_tf32(s[kk][1], ph[2], pl[2]);
        split_tf32(s[kk][3], ph[3], pl[3]);
        const float* vr = vt + (kk * 8 + 2 * t4) * kVP + g;
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(vr[dt * 8], bh0, bl0);
          split_tf32(vr[kVP + dt * 8], bh1, bl1);
          mma_3xtf32(part[dt], ph, pl, bh0, bh1, bl0, bl1);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  };

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();                // tile t (and Q): the only group left
    __syncthreads();                   // landed for all; tile t - 1 consumed
    if (t == 0) {
      // Q's A fragments: rows g and g + 8, d 8 ks + 2t and 2t + 1
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const float2 x0 = *reinterpret_cast<const float2*>(
            qs + (warp * 16 + g) * kQP + ks * 8 + 2 * t4);
        const float2 x1 = *reinterpret_cast<const float2*>(
            qs + (warp * 16 + g + 8) * kQP + ks * 8 + 2 * t4);
        split_tf32(x0.x, qh[ks][0], ql[ks][0]);
        split_tf32(x1.x, qh[ks][1], ql[ks][1]);
        split_tf32(x0.y, qh[ks][2], ql[ks][2]);
        split_tf32(x1.y, qh[ks][3], ql[ks][3]);
      }
      __syncthreads();                 // Q read by all: stage 1 is free
    }
    if (t + 1 < n_tiles) stage_tile(t + 1, (t + 1) % 2);
    cp_async_commit();
    const int n0 = t * kBN;
    const float* kt = smem_f + (t % 2) * kStageFloats;
    const float* vt = kt + kBN * kKP;
    // 8-key steps of this tile that hold a key the block needs; a warp
    // whose rows all lie above the tile (causal) skips it
    const int steps = min(8, (n_keys - n0 + 7) >> 3);
    if (causal && n0 > min(wrow0 + 15, Lq - 1)) continue;
    if (n0 + kBN > kv_lim || (causal && n0 + kBN - 1 > wrow0))
      tile(std::true_type{}, n0, steps, kt, vt);
    else
      tile(std::false_type{}, n0, steps, kt, vt);
  }
  cp_async_wait<0>();                  // no copy outlives the block

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float d_a = fmaxf(l_a, 1e-30f), d_b = fmaxf(l_b, 1e-30f);
  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = j * 8 + 2 * t4;
    if (ra < Lq) {
      ob[(long long)ra * so.l + d] = acc[j][0] / d_a;
      ob[(long long)ra * so.l + d + 1] = acc[j][1] / d_a;
    }
    if (rb < Lq) {
      ob[(long long)rb * so.l + d] = acc[j][2] / d_b;
      ob[(long long)rb * so.l + d + 1] = acc[j][3] / d_b;
    }
  }
}

template <int kWarps, bool kVec16>
int launch_tf32(const void* q, const void* k, const void* v, void* o,
                int B, int H, int Lq, int kv_lim, int causal,
                const Strides* s, float scale, int row_blocks,
                cudaStream_t st) {
  // the shared memory this instantiation takes, raised once
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        fmha_tf32_kernel<kWarps, kVec16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemF32);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  fmha_tf32_kernel<kWarps, kVec16><<<dim3(row_blocks, B * H), kWarps * 32,
                                     kSmemF32, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Lq, kv_lim,
      causal != 0, s[0], s[1], s[2], s[3], scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int kWarps>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int Lq, int Lk, int kv_lim, int causal,
               const Strides* s, float scale, int row_blocks,
               cudaStream_t st) {
  // 16-byte copies when every row of q, k and v starts on 16 bytes (a
  // stride of a dim of extent 1 is never stepped)
  bool vec16 = true;
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int n[3] = {B, H, i ? Lk : Lq};
    const long long st_[3] = {s[i].b, s[i].h, s[i].l};
    vec16 = vec16 && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
    for (int j = 0; j < 3; ++j) vec16 = vec16 && (n[j] == 1 || st_[j] % 4 == 0);
  }
  return vec16 ? launch_tf32<kWarps, true>(q, k, v, o, B, H, Lq, kv_lim,
                                           causal, s, scale, row_blocks, st)
               : launch_tf32<kWarps, false>(q, k, v, o, B, H, Lq, kv_lim,
                                            causal, s, scale, row_blocks,
                                            st);
}

int launch(bool f32, const void* q, const void* k, const void* v, void* o,
           int B, int H, int Lq, int Lk, int D, int kv_lim, int causal,
           int warps, int row_blocks, const long long* strides, float scale,
           void* stream) {
  // the plan is the wrapper's (`fmha_plan`): 1-4 warps of 16 query rows a
  // block, in both entries; every row block must hold a query row, and
  // together they hold Lq
  const int rows = 16 * warps;
  if (D != kD || B < 1 || H < 1 || Lq < 1 || Lk < 1 || B * H > 65535 ||
      kv_lim < 0 || kv_lim > Lk || warps < 1 || warps > kMaxWarps ||
      row_blocks < 1 || (long long)row_blocks * rows < Lq ||
      (row_blocks - 1) * rows >= Lq)
    return (int)cudaErrorInvalidValue;
  Strides s[4];
  for (int i = 0; i < 4; ++i)
    s[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (f32) {
    switch (warps) {
      case 1: return launch_f32<1>(q, k, v, o, B, H, Lq, Lk, kv_lim, causal,
                                   s, scale, row_blocks, st);
      case 2: return launch_f32<2>(q, k, v, o, B, H, Lq, Lk, kv_lim, causal,
                                   s, scale, row_blocks, st);
      case 3: return launch_f32<3>(q, k, v, o, B, H, Lq, Lk, kv_lim, causal,
                                   s, scale, row_blocks, st);
      default: return launch_f32<4>(q, k, v, o, B, H, Lq, Lk, kv_lim,
                                    causal, s, scale, row_blocks, st);
    }
  }
  switch (warps) {
    case 1: return launch_bf16<1>(q, k, v, o, B, H, Lq, kv_lim, causal, s,
                                  scale, row_blocks, st);
    case 2: return launch_bf16<2>(q, k, v, o, B, H, Lq, kv_lim, causal, s,
                                  scale, row_blocks, st);
    case 3: return launch_bf16<3>(q, k, v, o, B, H, Lq, kv_lim, causal, s,
                                  scale, row_blocks, st);
    default: return launch_bf16<4>(q, k, v, o, B, H, Lq, kv_lim, causal, s,
                                   scale, row_blocks, st);
  }
}

}  // namespace

extern "C" {

// q, k, v, o bf16.  Strides are in elements, [b, h, l] for each of q, k, v,
// o (the last dim is contiguous; the rows of q, k, v start on 16 bytes);
// kv_lim = min(kv_valid_len, Lk), clamped at 0; `causal` != 0 masks key c of
// query row r unless c <= r; `warps` (1-4, 16 query rows each) and
// `row_blocks` (ceil(Lq / (16 warps))) are the wrapper's plan.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// or a plan the kernel does not take.
int custom_fmha(const void* q, const void* k, const void* v, void* o, int B,
                int H, int Lq, int Lk, int D, int kv_lim, int causal,
                int warps, int row_blocks, const long long* strides,
                float scale, void* stream) {
  return launch(false, q, k, v, o, B, H, Lq, Lk, D, kv_lim, causal, warps,
                row_blocks, strides, scale, stream);
}

// The same with fp32 q, k, v and o (any 4-byte-aligned rows), and the same
// plan: `warps` (1-4) of 16 query rows a block, ceil(Lq / (16 warps)) row
// blocks.
int custom_fmha_f32(const void* q, const void* k, const void* v, void* o,
                    int B, int H, int Lq, int Lk, int D, int kv_lim,
                    int causal, int warps, int row_blocks,
                    const long long* strides, float scale, void* stream) {
  return launch(true, q, k, v, o, B, H, Lq, Lk, D, kv_lim, causal, warps,
                row_blocks, strides, scale, stream);
}

}  // extern "C"
