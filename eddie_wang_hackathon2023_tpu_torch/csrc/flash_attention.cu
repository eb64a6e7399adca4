// Flash attention with a key-length mask, optionally causal, and fp32
// online softmax: q, k, v [B, H, L, 64] -> o [B, H, Lq, 64], in two entries:
//   * bf16 in and out (`flash_attention`), for the float recipes;
//   * fp32 in and out (`flash_attention_f32`), for the SmoothQuant encoder,
//     whose QKV projection emits fp32 q, k, v.  It computes at fp32
//     accuracy on the tensor cores: each fp32 operand x is split into
//     bf16 hi = bf16(x) and lo = bf16(x - hi), and every product is the sum
//     of three bf16 products, lo*hi + hi*lo + hi*hi (the dropped lo*lo is
//     below 2^-16 of the product), for Q*K^T and for P*V alike.
//
// Replaces the TPU flash-attention kernel reached from
// eddie_wang_hackathon2023_tpu/ops/flash_attention.py:54 `flash_mha`
// (:89-116, jax.experimental.pallas.ops.tpu.flash_attention), which serves
// the Whisper encoder at 1536 padded frames with keys at or past
// `kv_valid_len` masked, and the causal context calls of 128 tokens or
// more (the JAX package's :74-76, :111-113).  The causal mask is
// `functional.causal_bias`'s, bottom-right: query i attends keys
// <= i + (Lk - Lq), what the plain version computes (the callers have
// Lq == Lk, where top-left and bottom-right agree).  The repo's own
// Pallas FMHA (examples/custom_kernel/pallas_fmha.py:23) computes the same
// function with the same algorithm (its causal mask top-left).
//
// Bound: operations (4 * Lq * valid * D flops per head, against about
// 4 * L * D * 2 bytes in bf16; three times the products in fp32).  The
// [Lq, Lk] score matrix never reaches device memory.  At D = 64 the
// softmax's exponent costs as much as the products (one exp2 per score at
// 16 a clock an SM against 4 * 64 flops per score on the tensor cores), so
// a kernel that runs them one after the other cannot reach the tensor
// cores' rate; the bf16 non-causal entry (the encoder's) therefore keeps
// several warpgroups in flight on each SM, whose exponents overlap the
// others' products:
//   * Hopper design (namespace `hopper`): one block per 128 query rows of a
//     (batch, head), two consumer warpgroups of 64 rows and one producer
//     warp; grid ceil(Lq / 128) x B*H (240 blocks at the encoder's
//     [1, 20, 1536, 64]), 83 KB of shared memory, so two blocks share an
//     SM and its 264 slots hold the grid in one wave (0.91);
//     `flash_attention_hopper_config` reports the rows, the stages and the
//     blocks an SM that the runtime finds for the built kernel;
//   * the producer copies Q once and each 64-key tile of K and V by TMA
//     (4-d tensor maps over the strided views, 128-byte swizzle, rows past
//     L read as zeros; the host keeps its last 16 maps by pointer, shape
//     and strides) into a ring of 4 stages, full and empty mbarriers;
//   * S = Q K^T is wgmma m64n64k16 with Q and K from shared memory as
//     they lie (both K-major); O += P V is wgmma with P from registers
//     (the S accumulators rounded to bf16 pairs, relative to the running
//     max) and V from shared memory as it lies, [key][d], MN-major through
//     the descriptor's transpose bit;
//   * a tile's P V and the next tile's S are started together and waited
//     for once, and the two warpgroups take turns to start them (named
//     barriers): one's softmax runs while the other's products do;
//   * the row max is taken on the raw scores and scaled once, so each
//     exponent is one FFMA and one ex2.approx; O is rescaled only when a
//     row's max moved; only the last tile, when `valid` cuts it, is masked.
//     Nine warps at two blocks an SM leave 96 registers a thread (one SM
//     quarter holds five warps), and ptxas serialises some products for
//     want of more; starting the next S before P V, so that the
//     exponentials overlap it, needs more than that, and one block an SM
//     ran slower.
// The causal mode and the fp32 entry keep the first design:
//   * one 128-thread block per 64 query rows of one (batch, head); each of
//     its 4 warps owns 16 rows and keeps its Q fragments in registers;
//   * K and V tiles of 64 keys go through shared memory as they lie in
//     memory, [key][d], rows padded so the fragment loads are free of bank
//     conflicts; in bf16 the P*V operand comes from V through
//     ldmatrix.trans, in fp32 from four scalar loads that are split on the
//     way into registers; two stages, filled with cp.async, so the next
//     tile loads while this one is computed;
//   * both products are mma.sync m16n8k16 bf16 -> fp32; the probabilities
//     stay in registers and become the A operand of P*V;
//   * tiles wholly past `valid` are skipped, columns past it are masked;
//     causal, tiles wholly above the diagonal are skipped too, the tiles
//     across it masked per row, and the blocks with the most tiles (the
//     last query rows) are scheduled first.
// Inputs may be strided (the last dim contiguous), so q, k, v can be
// views into the fused QKV projection output, and the output can be
// written in the [B, L, H, D] layout the out-projection reads.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kD = 64;
constexpr int kBM = 64;                // query rows per block
constexpr int kBN = 64;                // keys per tile
constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;

// padded row of the K and V tiles, in elements: 8 bf16 (16 bytes) keeps
// ldmatrix conflict-free; 4 floats puts the 4 key rows a warp's P*V loads
// touch on distinct banks
template <typename T>
__host__ __device__ constexpr int ld_of() {
  return std::is_same<T, float>::value ? kD + 4 : kD + 8;
}
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * 2 * kBN * ld_of<T>() * (int)sizeof(T);  // 2 stages x (K, V)
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) -> bf16 pairs hi = bf16(a, b) and lo = bf16(a - hi_a, b - hi_b)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b at fp32 accuracy from split operands (small terms first)
__device__ __forceinline__ void mma_split(float* c, const uint32_t* a_hi,
                                          const uint32_t* a_lo, uint32_t bh0,
                                          uint32_t bh1, uint32_t bl0,
                                          uint32_t bl1) {
  mma_bf16(c, a_lo, bh0, bh1);
  mma_bf16(c, a_hi, bl0, bl1);
  mma_bf16(c, a_hi, bh0, bh1);
}

// Two 8x8 b16 matrices per n-tile pair, transposed on the way in: the
// B fragments of two n-tiles of P*V.  ``row`` points at this lane's row.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const __nv_bfloat16* row) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16-byte global -> shared copy; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

struct Strides {
  long long b, h, l;                   // in elements; the last dim is 1
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int Lq, int Lk, int valid, int causal, Strides sq,
                       Strides sk, Strides sv, Strides so, float scale_log2) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kLd = ld_of<T>();
  constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const k_buf = reinterpret_cast<T*>(smem_raw);        // [2][kBN * kLd]
  T* const v_buf = k_buf + 2 * kBN * kLd;                 // [key][d]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // causal: the last query rows, which have the most key tiles, first
  const int m_blk = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int r0 = m_blk * kBM + warp * 16 + g, r1 = r0 + 8;
  // each row's keys end (exclusive) at `valid`, and causal at its diagonal
  const int off = Lk - Lq;
  const int lim0 = causal ? min(valid, r0 + off + 1) : valid;
  const int lim1 = causal ? min(valid, r1 + off + 1) : valid;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  // Q fragments (A operand, row-major 16x16 per k-step of 16 dims); in
  // fp32 as hi and lo halves
  uint32_t qf[kD / 16][4], ql[kD / 16][4];
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    const int c = ks * 16 + t * 2;
    const int rows[4] = {r0, r1, r0, r1};
    const int cols[4] = {c, c, c + 8, c + 8};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool in = rows[i] < Lq;
      if constexpr (kF32) {
        const float2 x = in ? *reinterpret_cast<const float2*>(
                                  qb + rows[i] * sq.l + cols[i])
                            : make_float2(0.f, 0.f);
        split_bf16(x.x, x.y, qf[ks][i], ql[ks][i]);
      } else {
        qf[ks][i] = in ? *reinterpret_cast<const uint32_t*>(
                             qb + rows[i] * sq.l + cols[i])
                       : 0u;
        ql[ks][i] = 0u;
      }
    }
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  // stage `st` <- keys [kt * kBN, kt * kBN + kBN); rows past Lk are zeros
  auto load_tile = [&](int st, int kt) {
    const int n0 = kt * kBN;
    for (int i = tid; i < kBN * kD / kVec; i += kThreads) {
      const int row = i / (kD / kVec), c = (i % (kD / kVec)) * kVec;
      const bool in = n0 + row < Lk;
      const int r = in ? n0 + row : 0;
      cp_async16(&k_buf[st * kBN * kLd + row * kLd + c], kb + r * sk.l + c,
                 in ? 16 : 0);
      cp_async16(&v_buf[st * kBN * kLd + row * kLd + c], vb + r * sv.l + c,
                 in ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // keys this block needs: up to its last row's diagonal when causal
  const int n_keys =
      causal ? min(valid, min(m_blk * kBM + kBM, Lq) + off) : valid;
  const int n_tiles = (n_keys + kBN - 1) / kBN;
  load_tile(0, 0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int n0 = kt * kBN;
    const T* k_s = k_buf + (kt & 1) * kBN * kLd;
    const T* v_s = v_buf + (kt & 1) * kBN * kLd;
    if (kt + 1 < n_tiles) {
      // the other stage was consumed before the barrier that ended the
      // previous iteration
      load_tile((kt + 1) & 1, kt + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();                   // this tile is in shared memory

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const T* kr = k_s + (nt * 8 + g) * kLd + t * 2;
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks) {
        if constexpr (kF32) {
          const float2 x0 = *reinterpret_cast<const float2*>(kr + ks * 16);
          const float2 x1 =
              *reinterpret_cast<const float2*>(kr + ks * 16 + 8);
          uint32_t bh0, bl0, bh1, bl1;
          split_bf16(x0.x, x0.y, bh0, bl0);
          split_bf16(x1.x, x1.y, bh1, bl1);
          mma_split(s[nt], qf[ks], ql[ks], bh0, bh1, bl0, bl1);
        } else {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + ks * 16);
          const uint32_t b1 =
              *reinterpret_cast<const uint32_t*>(kr + ks * 16 + 8);
          mma_bf16(s[nt], qf[ks], b0, b1);
        }
      }
    }

    // mask, scale into the log2 domain, running max per row
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + nt * 8 + t * 2 + (j & 1);
        s[nt][j] = col < (j < 2 ? lim0 : lim1) ? s[nt][j] * scale_log2
                                                : kNeg;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + nt * 8 + t * 2 + (j & 1);
        const float p = col < (j < 2 ? lim0 : lim1)
                            ? exp2f(s[nt][j] - (j < 2 ? mn0 : mn1))
                            : 0.f;
        s[nt][j] = p;
        if (j < 2) ps0 += p; else ps1 += p;
      }
    }
    l0 = l0 * a0 + ps0;                // per-thread partial; quad-summed at the end
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      acc[dt][0] *= a0;
      acc[dt][1] *= a0;
      acc[dt][2] *= a1;
      acc[dt][3] *= a1;
    }

    // O += P V: the S accumulators of two key n-tiles form one A fragment
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      if constexpr (kF32) {
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
        // B fragment of d-tile dt: V[key][dt * 8 + g] at keys
        // kk * 16 + 2t, +1 (b0) and +8, +9 (b1)
        const float* vk = v_s + (kk * 16 + t * 2) * kLd + g;
#pragma unroll
        for (int dt = 0; dt < kD / 8; ++dt) {
          const float* vc = vk + dt * 8;
          uint32_t bh0, bl0, bh1, bl1;
          split_bf16(vc[0], vc[kLd], bh0, bl0);
          split_bf16(vc[8 * kLd], vc[9 * kLd], bh1, bl1);
          mma_split(acc[dt], ph, pl, bh0, bh1, bl0, bl1);
        }
      } else {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        // lanes 0-15 address keys kk*16 + 0..15 at d-tile dt, lanes 16-31
        // the same keys at d-tile dt + 1
        const __nv_bfloat16* vrow =
            v_s + (kk * 16 + (lane & 15)) * kLd + (lane >> 4) * 8;
#pragma unroll
        for (int dt = 0; dt < kD / 8; dt += 2) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vrow + dt * 8);
          mma_bf16(acc[dt], pa, vf[0], vf[1]);
          mma_bf16(acc[dt + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();                   // this stage is consumed
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if constexpr (kF32) {
      if (r0 < Lq)
        *reinterpret_cast<float2*>(ob + r0 * so.l + c) =
            make_float2(acc[dt][0] * inv0, acc[dt][1] * inv0);
      if (r1 < Lq)
        *reinterpret_cast<float2*>(ob + r1 * so.l + c) =
            make_float2(acc[dt][2] * inv1, acc[dt][3] * inv1);
    } else {
      if (r0 < Lq)
        *reinterpret_cast<uint32_t*>(ob + r0 * so.l + c) =
            pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
      if (r1 < Lq)
        *reinterpret_cast<uint32_t*>(ob + r1 * so.l + c) =
            pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Lq, int Lk, int D, int valid, int causal,
           const long long* strides, float scale, void* stream) {
  // causal needs Lq <= Lk: then every row has key 0 and every block a tile
  if (D != kD || valid < 1 || valid > Lk || (causal && Lq > Lk))
    return (int)cudaErrorInvalidValue;
  Strides s[4];
  for (int i = 0; i < 4; ++i) s[i] = {strides[3 * i], strides[3 * i + 1],
                                      strides[3 * i + 2]};
  constexpr int smem = smem_bytes<T>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Lq + kBM - 1) / kBM, B * H);
  flash_attention_kernel<T><<<grid, kThreads, smem,
                              reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Lq, Lk, valid,
      causal != 0, s[0], s[1], s[2], s[3], scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// -- the bf16 non-causal entry on Hopper: wgmma products, TMA loads -------

namespace hopper {

constexpr int kRows = 128;                  // query rows a block
constexpr int kKeys = 64;                   // keys a tile
constexpr int kStages = 4;                  // K/V tiles in flight
constexpr int kTileBytes = 64 * kD * 2;     // one 64-row bf16 tile: 8 KB
constexpr int kConsumerWarps = 8;           // two warpgroups of 64 rows each
constexpr int kThreads = 32 * kConsumerWarps + 32;   // + the producer warp
// 1 KB to align the tiles to the 128-byte swizzle's 1024-byte period, Q
// (128 rows), the K and V rings, the barriers
constexpr int kSmem = 1024 + (2 + 2 * kStages) * kTileBytes + 256;

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
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}
// returns once the phase of parity `parity` has completed; a copy that
// never lands traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > (1ll << 34)) __trap();     // some 10 s
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// A [64 x 64] (or [128 x 64]) bf16 box of a 4-d tensor map into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a tile of 128-byte rows in the 128-byte
// swizzle (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B): groups of 8
// rows 1024 bytes apart (SBO); the leading offset is unused at this width
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// 2^x on the SFU, subnormal results flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of products are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of r across the asynchronous
// products
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[kD / 16][4]) {
#pragma unroll
  for (int i = 0; i < kD / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define EWT_WG_D32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define EWT_WG_OUT32(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (+)= A B, m64n64k16, A and B from shared memory, both K-major
// (S = Q K^T: Q [row][d], K [key][d] as they lie)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " EWT_WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : EWT_WG_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
// d += A B, m64n64k16, A from registers (P as bf16 pairs), B from shared
// memory MN-major (V [key][d] as it lies: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " EWT_WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : EWT_WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Warps 0-7 are two consumer warpgroups of 64 query rows; warp 8 feeds
// them: Q once, then each K/V tile into a ring of kStages by TMA.  A
// consumer warp releases a stage (one arrival of 8) when its products on
// it are done.  The softmax of a row is the row's max as the raw score's
// extreme (max for a positive scale, min for a negative one), scaled once
// into the log2 domain: p = exp2(s * scale_log2 - m) is one FFMA and one
// exp2.  Only the last tile, when `valid` cuts it, is masked.
template <bool kPosScale>
__global__ void __launch_bounds__(kThreads, 2)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   __nv_bfloat16* __restrict__ o, int H, int Lq, int valid,
                   int q_hl, int k_hl, int v_hl, Strides so,
                   float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* const q_s = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* const k_s = q_s + kRows * kD;        // [kStages][64][64]
  __nv_bfloat16* const v_s = k_s + kStages * kKeys * kD;
  uint64_t* const full = reinterpret_cast<uint64_t*>(v_s + kStages * kKeys * kD);
  uint64_t* const empty = full + kStages;
  uint64_t* const q_bar = empty + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * kRows;
  const int n_tiles = (valid + kKeys - 1) / kKeys;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // the producer: one thread starts every copy
    if (lane == 0) {
      mbar_expect_tx(q_bar, kRows * kD * 2);
      tma_load(q_s, &q_map, q_bar, q_hl ? h : m0, q_hl ? m0 : h, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % kStages, n0 = kt * kKeys;
        mbar_wait(&empty[st], ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * kTileBytes);
        tma_load(k_s + st * kKeys * kD, &k_map, &full[st], k_hl ? h : n0,
                 k_hl ? n0 : h, b);
        tma_load(v_s + st * kKeys * kD, &v_map, &full[st], v_hl ? h : n0,
                 v_hl ? n0 : h, b);
      }
    }
    return;
  }

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = m0 + wg * 64 + (warp & 3) * 16 + g, r1 = r0 + 8;
  const uint64_t q_desc = desc_sw128(q_s + wg * 64 * kD);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  // raw-score extremes and the scaled maxima of rows r0 and r1, and the
  // per-thread partial sums (quad-summed at the end)
  float x0 = kPosScale ? -INFINITY : INFINITY, x1 = x0;
  float m_0 = -INFINITY, m_1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  // S = Q K^T of tile kt into s: 64 rows x 64 keys, four k-steps of 16
  // dims (32 bytes); the first step overwrites s.  The caller has waited
  // for the tile and fenced.
  float s[32];
  auto scores = [&](int kt) {
    const uint64_t k_desc = desc_sw128(k_s + (kt % kStages) * kKeys * kD);
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks)
      wgmma_ss(s, q_desc + 2 * ks, k_desc + 2 * ks, ks);
  };
  mbar_wait(q_bar, 0);
  mbar_wait(&full[0], 0);
  fence_regs(s);
  wgmma_fence();
  scores(0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  // the two warpgroups take turns to start their products (named barriers
  // 1 and 2, 256 threads: one warpgroup waits, the other arrives), so that
  // one's softmax runs while the other's products do; warpgroup 0 first
  if (wg == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt % kStages, n0 = kt * kKeys;
    // the row extremes; keys at or past `valid` lose them
    const bool cut = n0 + kKeys > valid;
    if (cut) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = n0 + (i >> 2) * 8 + t * 2 + (i & 1);
        if (col >= valid) s[i] = kPosScale ? -INFINITY : INFINITY;
      }
    }
    float e0 = s[0], e1 = s[2];
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
      if (kPosScale) {
        e0 = fmaxf(e0, fmaxf(s[4 * nt], s[4 * nt + 1]));
        e1 = fmaxf(e1, fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
      } else {
        e0 = fminf(e0, fminf(s[4 * nt], s[4 * nt + 1]));
        e1 = fminf(e1, fminf(s[4 * nt + 2], s[4 * nt + 3]));
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float o0 = __shfl_xor_sync(0xffffffffu, e0, off);
      const float o1 = __shfl_xor_sync(0xffffffffu, e1, off);
      e0 = kPosScale ? fmaxf(e0, o0) : fminf(e0, o0);
      e1 = kPosScale ? fmaxf(e1, o1) : fminf(e1, o1);
    }
    x0 = kPosScale ? fmaxf(x0, e0) : fminf(x0, e0);
    x1 = kPosScale ? fmaxf(x1, e1) : fminf(x1, e1);
    const float mn0 = x0 * scale_log2, mn1 = x1 * scale_log2;
    const float a0 = ex2(m_0 - mn0), a1 = ex2(m_1 - mn1);
    m_0 = mn0;
    m_1 = mn1;
    // p = exp2(s * scale_log2 - m) into s; the cut tile's masked keys get
    // 0 (whatever the scale), the others no test at all
    float ps0 = 0.f, ps1 = 0.f;
    auto probs = [&](auto cut_t) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float p = ex2(fmaf(s[i], scale_log2, (i & 2) ? -mn1 : -mn0));
        if (decltype(cut_t)::value
            && n0 + (i >> 2) * 8 + t * 2 + (i & 1) >= valid)
          p = 0.f;
        s[i] = p;
        if (i & 2) ps1 += p; else ps0 += p;
      }
    };
    if (cut)
      probs(std::true_type{});
    else
      probs(std::false_type{});
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
    // once the rows' maxima settle, most tiles leave them as they were
    if (!__all_sync(0xffffffffu, a0 == 1.f && a1 == 1.f)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= (i & 2) ? a1 : a0;
    }
    // P as the A operand, rounded to bf16 against the running max: key
    // step kk takes the accumulators of key n-tiles 2kk and 2kk + 1
    uint32_t pa[kD / 16][4];   // kKeys == kD: four key steps
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    // O += P V (four key steps of 16 rows of V, 2048 bytes each), and
    // behind it the next tile's S (s is free once P is in pa; the last
    // tile's S again at the end, so that no branch surrounds the
    // products): one wait for both
    const int kn = min(kt + 1, n_tiles - 1);
    mbar_wait(&full[kn % kStages], (kn / kStages) & 1);
    const uint64_t v_desc = desc_sw128(v_s + st * kKeys * kD);
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
    fence_regs(acc);
    fence_regs(pa);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_rs(acc, pa[kk], v_desc + kk * (2048 >> 4));
    scores(kn);
    wgmma_commit();
    if (!(wg == 1 && kt == n_tiles - 1))
      asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (r0 < Lq)
      *reinterpret_cast<uint32_t*>(ob + r0 * so.l + c) =
          pack_bf16(acc[4 * dt] * inv0, acc[4 * dt + 1] * inv0);
    if (r1 < Lq)
      *reinterpret_cast<uint32_t*>(ob + r1 * so.l + c) =
          pack_bf16(acc[4 * dt + 2] * inv1, acc[4 * dt + 3] * inv1);
  }
}

#undef EWT_WG_D32
#undef EWT_WG_OUT32

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, through the runtime's entry
// point query (so the library needs no -lcuda); null if it is missing
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-d map of a [B, H, L, 64] bf16 tensor with element strides s, boxes
// of 64 x `rows`: dims innermost first (d, then l and h in the order of
// their strides, *hl = 1 when h comes first, then b), 128-byte swizzle,
// rows past L read as zeros.  A dim of extent 1 is never stepped; it gets
// a stride TMA accepts.
int encode_map(CUtensorMap* map, const void* ptr, int B, int H, int L,
               Strides s, int rows, int* hl) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  *hl = s.h < s.l;
  cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)(*hl ? H : L),
                        (cuuint64_t)(*hl ? L : H), (cuuint64_t)B};
  long long st[4] = {1, *hl ? s.h : s.l, *hl ? s.l : s.h, s.b};
  cuuint64_t strides[3];
  for (int i = 1; i < 4; ++i) {
    if (dims[i] == 1) st[i] = i == 1 ? kD : st[i - 1] * (long long)dims[i - 1];
    strides[i - 1] = (cuuint64_t)st[i] * 2;
  }
  const cuuint32_t box[4] = {(cuuint32_t)kD, (cuuint32_t)(*hl ? 1 : rows),
                             (cuuint32_t)(*hl ? rows : 1), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Both instantiations take kSmem of dynamic shared memory, an attribute of
// the function on each device: set once per device, not per call.
constexpr int kMaxDevices = 64;

int set_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire)) return 0;
  e = cudaFuncSetAttribute(flash_wgmma_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_wgmma_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices) done[dev].store(true, std::memory_order_release);
  return 0;
}

// A tensor map is a function of (pointer, shape, strides, box) alone, so
// each host thread keeps its last kMapCache maps and a call that repeats
// an operand's layout (every encoder layer) skips the encoding.
struct MapEntry {
  CUtensorMap map;
  const void* ptr;
  int B, H, L, rows, hl;
  Strides s;
  bool used;
};
constexpr int kMapCache = 16;

int cached_map(const CUtensorMap** map, const void* ptr, int B, int H,
               int L, Strides s, int rows, int* hl) {
  static thread_local MapEntry cache[kMapCache];
  static thread_local int next = 0;
  for (const MapEntry& c : cache) {
    if (c.used && c.ptr == ptr && c.B == B && c.H == H && c.L == L
        && c.rows == rows && c.s.b == s.b && c.s.h == s.h && c.s.l == s.l) {
      *map = &c.map;
      *hl = c.hl;
      return 0;
    }
  }
  MapEntry& c = cache[next];
  next = (next + 1) % kMapCache;
  c.used = false;
  const int e = encode_map(&c.map, ptr, B, H, L, s, rows, &c.hl);
  if (e) return e;
  c.ptr = ptr;
  c.B = B;
  c.H = H;
  c.L = L;
  c.rows = rows;
  c.s = s;
  c.used = true;
  *map = &c.map;
  *hl = c.hl;
  return 0;
}

int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Lq, int Lk, int valid, const Strides* s, float scale,
           cudaStream_t stream) {
  const CUtensorMap* maps[3];
  int hl[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int e = cached_map(&maps[i], ptrs[i], B, H, i ? Lk : Lq, s[i],
                             i ? kKeys : kRows, &hl[i]);
    if (e) return e;
  }
  const int e = set_smem();
  if (e) return e;
  auto kernel = scale >= 0.f ? flash_wgmma_kernel<true>
                             : flash_wgmma_kernel<false>;
  dim3 grid((Lq + kRows - 1) / kRows, B * H);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      *maps[0], *maps[1], *maps[2], static_cast<__nv_bfloat16*>(o), H, Lq,
      valid, hl[0], hl[1], hl[2], s[3], scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace hopper

}  // namespace

extern "C" {

// Strides are in elements, [b, h, l] for each of q, k, v, o (the last dim
// is contiguous); `causal` != 0 masks key k of query i unless
// k <= i + (Lk - Lq).  Returns cudaGetLastError() after the launch.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int B, int H, int Lq, int Lk, int D, int valid,
                    int causal, const long long* strides, float scale,
                    void* stream) {
  if (causal)
    return launch<__nv_bfloat16>(q, k, v, o, B, H, Lq, Lk, D, valid, causal,
                                 strides, scale, stream);
  if (D != kD || valid < 1 || valid > Lk) return (int)cudaErrorInvalidValue;
  Strides s[4];
  for (int i = 0; i < 4; ++i) s[i] = {strides[3 * i], strides[3 * i + 1],
                                      strides[3 * i + 2]};
  return hopper::launch(q, k, v, o, B, H, Lq, Lk, valid, s, scale,
                        reinterpret_cast<cudaStream_t>(stream));
}

// The bf16 non-causal entry's design as built, for its callers' reports:
// out[0] query rows a block, out[1] K/V tiles in flight, out[2] blocks of
// the kernel that one SM of the current device holds at its shared memory
// and registers (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Returns
// 0 or the CUDA error.
int flash_attention_hopper_config(int* out) {
  const int e = hopper::set_smem();
  if (e) return e;
  out[0] = hopper::kRows;
  out[1] = hopper::kStages;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], hopper::flash_wgmma_kernel<true>, hopper::kThreads,
      hopper::kSmem);
}

// The same with fp32 q, k, v and output, at fp32 accuracy.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int Lq, int Lk, int D, int valid,
                        int causal, const long long* strides, float scale,
                        void* stream) {
  return launch<float>(q, k, v, o, B, H, Lq, Lk, D, valid, causal, strides,
                       scale, stream);
}

}  // extern "C"
