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
// [Lq, Lk] score matrix never reaches device memory.  Design (simple first;
// wgmma and TMA are later work):
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

extern "C" {

// Strides are in elements, [b, h, l] for each of q, k, v, o (the last dim
// is contiguous); `causal` != 0 masks key k of query i unless
// k <= i + (Lk - Lq).  Returns cudaGetLastError() after the launch.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int B, int H, int Lq, int Lk, int D, int valid,
                    int causal, const long long* strides, float scale,
                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, H, Lq, Lk, D, valid, causal,
                               strides, scale, stream);
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
