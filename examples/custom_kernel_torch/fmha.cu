// A user-written fused multi-head attention for the port's custom-attention
// hook (`ops.flash_attention.set_custom_mha`): q, k, v [B, H, L, 64] in
// bf16 or fp32 -> o [B, H, Lq, 64] in q's dtype, all arithmetic in fp32.
//
// Replaces the repo's Pallas FMHA, examples/custom_kernel/pallas_fmha.py:23
// `_kernel` (`pallas_call` at :89), and computes what it computes:
//   * scores q.k * scale and P*V in fp32, online softmax with the running
//     max starting at -1e30;
//   * keys at or past `kv_valid_len` masked; causal, key c of query row r
//     masked unless c <= r (top-left, as the Pallas kernel: it agrees with
//     `functional.causal_bias`'s bottom-right mask only when Lq == Lk);
//   * the output is acc / max(d, 1e-30), so a row with no live key is 0;
//   * key tiles wholly past the valid keys, or wholly above the diagonal,
//     are skipped (a skipped tile would change no sum).
//
// Bound: operations, 4 * Lq * valid * D flops per head in fp32 on the CUDA
// cores (67 TFLOP/s), against about 4 * L * D * 4 bytes.  Design (simple
// first; wgmma and TMA are later work):
//   * one 128-thread block per 128 query rows of one (batch, head); the Q
//     tile, converted to fp32, stays in shared memory;
//   * K and V tiles of 64 keys go through shared memory in fp32, rows
//     padded so that every fragment load below is free of bank conflicts;
//   * the threads form 16 x 8: each computes an 8 x 8 patch of the score
//     tile (rows ty + 16 i, keys tx + 8 j), which amortises one 16-byte
//     load of Q and of K over 32 FMAs; the 8 threads of a row reduce its
//     max by shuffles; P goes to shared memory and each thread then
//     accumulates 8 rows x 8 output columns of P*V in registers;
//   * causal, the blocks with the most key tiles (the last rows) go first.
// Inputs may be strided (the last dim contiguous), as the attention layer
// hands them over: views into the fused QKV projection output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 64;                 // head dim
constexpr int kBM = 128;               // query rows per block
constexpr int kBN = 64;                // keys per tile
constexpr int kThreads = 128;          // 16 rows x 8 columns of threads
constexpr int kLd = kD + 4;            // padded row of the Q, K, V tiles
constexpr int kLdP = kBN + 8;          // padded row of the P tile
constexpr float kNeg = -1e30f;
constexpr int kSmemBytes =
    (kBM * kLd + 2 * kBN * kLd + kBM * kLdP) * (int)sizeof(float);

struct Strides {
  long long b, h, l;                   // in elements; the last dim is 1
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [row0, row0 + rows) of x (row stride ld) -> tile[rows][kLd] in
// fp32; rows at or past n are zeros
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* x,
                                          long long ld, int row0, int rows,
                                          int n) {
  for (int i = threadIdx.x; i < rows * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    tile[r * kLd + c] =
        row0 + r < n ? to_f32(x[(long long)(row0 + r) * ld + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fmha_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, int H, int Lq,
            int Lk, int kv_lim, int causal, Strides sq, Strides sk,
            Strides sv, Strides so, float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  float* const qs = smem;                   // [kBM][kLd]
  float* const ks = qs + kBM * kLd;         // [kBN][kLd]
  float* const vs = ks + kBN * kLd;         // [kBN][kLd]
  float* const ps = vs + kBN * kLd;         // [kBM][kLdP]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int m_blk = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int row0 = m_blk * kBM;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  load_tile(qs, q + b * sq.b + h * sq.h, sq.l, row0, kBM, Lq);

  // keys the block needs: the valid ones, causal up to its last row
  const int n_keys = causal ? min(kv_lim, min(row0 + kBM, Lq)) : kv_lim;
  const int n_tiles = (n_keys + kBN - 1) / kBN;

  float acc[8][8], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;                        // this thread's columns only
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int n0 = kt * kBN;
    __syncthreads();                   // the last tile's K, V, P consumed
    load_tile(ks, kb, sk.l, n0, kBN, Lk);
    load_tile(vs, vb, sv.l, n0, kBN, Lk);
    __syncthreads();

    // S = Q K^T: rows ty + 16 i, keys tx + 8 j
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < kD; d += 4) {
      float4 kf[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kf[j] = *reinterpret_cast<const float4*>(&ks[(tx + 8 * j) * kLd + d]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qf =
            *reinterpret_cast<const float4*>(&qs[(ty + 16 * i) * kLd + d]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
        }
      }
    }

    // mask, scale into the log2 domain, online softmax per row; P to
    // shared memory
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + ty + 16 * i;
      const int lim = causal ? min(kv_lim, row + 1) : kv_lim;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = n0 + tx + 8 * j < lim ? s[i][j] * scale_log2 : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = n0 + tx + 8 * j < lim ? exp2f(s[i][j] - mn) : 0.f;
        ps[(ty + 16 * i) * kLdP + tx + 8 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + sum;
      m[i] = mn;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();                   // P is in shared memory

    // O += P V: rows ty + 16 i, output columns 4 tx + 32 c + e
#pragma unroll 2
    for (int n = 0; n < kBN; n += 4) {
      float4 vf[4][2];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          vf[kk][c] = *reinterpret_cast<const float4*>(
              &vs[(n + kk) * kLd + 4 * tx + 32 * c]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 pf =
            *reinterpret_cast<const float4*>(&ps[(ty + 16 * i) * kLdP + n]);
        const float p4[4] = {pf.x, pf.y, pf.z, pf.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            acc[i][4 * c + 0] = fmaf(p4[kk], vf[kk][c].x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(p4[kk], vf[kk][c].y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(p4[kk], vf[kk][c].z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(p4[kk], vf[kk][c].w, acc[i][4 * c + 3]);
          }
      }
    }
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float d = l[i];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    d = fmaxf(d, 1e-30f);
    const int row = row0 + ty + 16 * i;
    if (row >= Lq) continue;
    T* orow = ob + (long long)row * so.l;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(orow + 4 * tx + 32 * c + e, acc[i][4 * c + e] / d);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Lq, int Lk, int D, int kv_lim, int causal,
           const long long* strides, float scale, void* stream) {
  if (D != kD || B < 1 || H < 1 || Lq < 1 || Lk < 1 || B * H > 65535 ||
      kv_lim < 0 || kv_lim > Lk)
    return (int)cudaErrorInvalidValue;
  Strides s[4];
  for (int i = 0; i < 4; ++i)
    s[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaError_t e = cudaFuncSetAttribute(
      fmha_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Lq + kBM - 1) / kBM, B * H);
  fmha_kernel<T><<<grid, kThreads, kSmemBytes,
                   reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Lq, Lk, kv_lim,
      causal != 0, s[0], s[1], s[2], s[3], scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o bf16.  Strides are in elements, [b, h, l] for each of q, k, v,
// o (the last dim is contiguous); kv_lim = min(kv_valid_len, Lk), clamped
// at 0; `causal` != 0 masks key c of query row r unless c <= r.  Returns
// cudaGetLastError() after the launch.
int custom_fmha(const void* q, const void* k, const void* v, void* o, int B,
                int H, int Lq, int Lk, int D, int kv_lim, int causal,
                const long long* strides, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, H, Lq, Lk, D, kv_lim, causal,
                               strides, scale, stream);
}

// The same with fp32 q, k, v and o.
int custom_fmha_f32(const void* q, const void* k, const void* v, void* o,
                    int B, int H, int Lq, int Lk, int D, int kv_lim,
                    int causal, const long long* strides, float scale,
                    void* stream) {
  return launch<float>(q, k, v, o, B, H, Lq, Lk, D, kv_lim, causal, strides,
                       scale, stream);
}

}  // extern "C"
