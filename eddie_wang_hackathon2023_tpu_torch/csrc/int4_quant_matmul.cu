// int4 weight-only dequant matmul: out[M, N] = x[M, K] @ dequant(W) in bf16.
//
// Replaces the TPU kernel eddie_wang_hackathon2023_tpu/ops/
// pallas_quant_matmul.py:25 `_kernel_int4` (entry `quant_matmul_int4_pallas`,
// :56).  W is int4 packed [K/2, N] int8 in half-split nibbles: byte i of a
// column holds row i in its low nibble and row i + K/2 in its high nibble;
// each nibble is sign-extended (`(int8)(p << 4) >> 4`, `p >> 4`), so it
// reads [-8, 7].  Numerics, as the TPU kernel's:
//   * one group (per-output-channel fp32 scales [N]): the integers enter the
//     product unscaled, the products accumulate in fp32, and the fp32 scale
//     multiplies the fp32 sum before the single rounding to bf16 (:40-43);
//   * G > 1 groups (scales [G, N], K/G rows each): every weight element
//     becomes bf16(q * bf16(scale[g, n])), the scale rounded to bf16 first
//     (`scale_ref[...].astype(x.dtype)`, :47-49), then the products
//     accumulate in fp32 and round once (:51-52).  Each nibble takes the
//     group of its own row: the low nibble of byte i is in group i / (K/G),
//     the high one in group (i + K/2) / (K/G).
//
// Bound: at decode (M = 8) the work is a stream of packed weights (half a
// byte a weight; 2-8 MB a call on the SantaCoder-1B path), so bytes bound
// it; at the prefill (M = 512) the products do (43 GFLOP a layer).
//
// Design.  A block computes a [16*MT, 128] output tile with 8 warps, 16
// columns each, on the tensor cores (`mma.sync.m16n8k16` bf16 with fp32
// accumulators, fragments loaded by `ldmatrix`).  K is walked in chunks of
// 32 packed rows, which give 64 rows of K: 32 low nibbles (rows p0..p0+31)
// and 32 high ones (rows K/2+p0..), so every packed byte is read once and
// both its nibbles are used.  A chunk's packed bytes [32][128] (a warp reads 4 rows of 128
// contiguous bytes: the packed layout is N-minor), its two scale rows (low
// and high group; a group is a multiple of 32 rows, so one row each) and
// its x tile [16*MT][64] are copied by `cp.async` into a ring of kStages
// shared-memory stages, kStages - 1 chunks ahead of the one being used, so
// that several chunks' loads are in flight.  Each thread then unpacks 16
// columns of one packed row into the bf16 weight panel [64][128]: two
// nibbles at a time, as bf16 pairs (the nibble xor 8 set into the mantissa
// of 128.0, minus 136: exact), times the bf16 pair of their scales (one
// rounding, the TPU kernel's), and the warps run the products from there.
// At decode one tile row covers all of M, so the grid would be N/128 blocks
// (16 at N 2048, on 132 multiprocessors): K is split along chunk boundaries
// into `splits` ranges, one block each.  A split block writes its fp32
// partial tile, and the last block of a tile to finish (an atomic counter
// per tile, which it resets) sums the partials in split order, applies the
// per-channel scale and rounds: one launch, a deterministic sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kTileN = 128;             // output columns a block
constexpr int kWarpN = kTileN / (kThreads / 32);   // 16 columns a warp
constexpr int kNT = kWarpN / 8;                    // its n8 tiles
constexpr int kPack = 32;               // packed rows a chunk
constexpr int kChunkK = 2 * kPack;      // rows of K a chunk (low + high)
constexpr int kWStride = kTileN + 8;    // bf16 a weight-panel row (padded)
constexpr int kXStride = kChunkK + 8;   // bf16 an x-tile row (padded)
static_assert(kThreads % kTileN == 0, "the reduction: a column a thread");

template <int MT>
struct Layout {
  static constexpr int kStages = MT == 1 ? 4 : 3;
  static constexpr int kPanel = kChunkK * kWStride * 2;       // bf16 panel
  static constexpr int kRaw = kPack * kTileN;                 // packed bytes
  static constexpr int kScl = 2 * kTileN * 4;                 // two fp32 rows
  static constexpr int kX = 16 * MT * kXStride * 2;           // bf16 x tile
  static constexpr int kStage = kRaw + kScl + kX;
  static constexpr int kBytes = kPanel + kStages * kStage;
};

struct Problem {
  const __nv_bfloat16* x;               // [M, K]
  const int8_t* qw;                     // [K/2, N]
  const float* scale;                   // [N] or [G, N]
  int M, N, K, gs;                      // gs: rows of K a group
  int chunks_per_split, splits;
  float* ws;                            // [splits, M, N] partials
  int* counters;                        // one per output tile
  __nv_bfloat16* out;                   // [M, N]
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 bits_bf2(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// two nibbles (bits 0-3 and 16-19 of v) -> their signed values as a bf16
// pair: 0x4300 | (n ^ 8) is 128 + (n ^ 8) in bf16, and n ^ 8 - 8 is the
// two's-complement value of n; every step is exact
__device__ __forceinline__ __nv_bfloat162 nibbles_bf2(uint32_t v) {
  const uint32_t u = ((v & 0x000F000Fu) ^ 0x00080008u) | 0x43004300u;
  return __hsub2(bits_bf2(u), __floats2bfloat162_rn(136.f, 136.f));
}

// issue the copies of chunk `chunk` into stage buffer `st` (edge tiles,
// whose rows are not whole 16-byte vectors, are loaded and stored here)
template <int MT, bool kGrouped>
__device__ __forceinline__ void issue_chunk(const Problem& p, int chunk,
                                            int n0, int m0, bool vec,
                                            uint8_t* st) {
  using Ly = Layout<MT>;
  const int t = threadIdx.x;
  const int kh = p.K / 2;
  const int p0 = chunk * kPack;
  int8_t* raw = reinterpret_cast<int8_t*>(st);
  float* scl = reinterpret_cast<float*>(st + Ly::kRaw);
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(st + Ly::kRaw + Ly::kScl);
  const int col = 16 * (t % 8);
#pragma unroll
  for (int r = t / 8; r < kPack; r += kThreads / 8) {
    const int8_t* src = p.qw + static_cast<size_t>(p0 + r) * p.N + n0 + col;
    int8_t* dst = raw + r * kTileN + col;
    if (vec) {
      cp_async16(dst, src, 16);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        dst[e] = n0 + col + e < p.N ? src[e] : 0;
    }
  }
  if (kGrouped && t < 64) {
    // row 0: the group of rows p0.. (low nibbles); row 1: of K/2 + p0...
    // Columns 4q..4q+3 go to slot 8 (q % 4) + q / 4 of their row, so that
    // the 8 threads that unpack 16 columns each read 8 adjacent slots
    const int row = t / 32, q = t % 32, c4 = 4 * q;
    const int g = (row ? kh + p0 : p0) / p.gs;
    const float* src = p.scale + static_cast<size_t>(g) * p.N + n0 + c4;
    float* dst = scl + row * kTileN + 4 * (8 * (q % 4) + q / 4);
    if (vec) {
      cp_async16(dst, src, 16);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = n0 + c4 + e < p.N ? src[e] : 0.f;
    }
  }
  // the x tile: 16*MT rows x (32 low + 32 high columns), 8 bf16 a copy;
  // rows past M are zero-filled
#pragma unroll
  for (int idx = t; idx < 16 * MT * 8; idx += kThreads) {
    const int row = idx / 8, half = (idx / 4) % 2, v = idx % 4;
    const int m = m0 + row;
    const __nv_bfloat16* src =
        m < p.M ? p.x + static_cast<size_t>(m) * p.K + (half ? kh + p0 : p0) +
                      8 * v
                : p.x;
    cp_async16(xs + row * kXStride + half * kPack + 8 * v, src,
               m < p.M ? 16 : 0);
  }
}

// unpack, scale and round one staged chunk into the bf16 weight panel
template <int MT, bool kGrouped>
__device__ __forceinline__ void dequant_chunk(const uint8_t* st,
                                              __nv_bfloat16* panel) {
  using Ly = Layout<MT>;
  const int t = threadIdx.x;
  const int col = 16 * (t % 8);
  const int8_t* raw = reinterpret_cast<const int8_t*>(st);
  const float4* scl = reinterpret_cast<const float4*>(st + Ly::kRaw);
  __nv_bfloat162 slo[8], shi[8];
  if (kGrouped) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {     // columns col + 4q .. col + 4q + 3
      const float4 a = scl[8 * q + t % 8];
      const float4 b = scl[kTileN / 4 + 8 * q + t % 8];
      slo[2 * q] = __floats2bfloat162_rn(a.x, a.y);
      slo[2 * q + 1] = __floats2bfloat162_rn(a.z, a.w);
      shi[2 * q] = __floats2bfloat162_rn(b.x, b.y);
      shi[2 * q + 1] = __floats2bfloat162_rn(b.z, b.w);
    }
  }
#pragma unroll
  for (int r = t / 8; r < kPack; r += kThreads / 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * kTileN + col);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      // bytes (0, 1) and (2, 3) of the word into the two halves
      const uint32_t pairs[2] = {__byte_perm(words[w], 0, 0x4140),
                                 __byte_perm(words[w], 0, 0x4342)};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * w + h;        // columns col + 2j, col + 2j + 1
        __nv_bfloat162 ql = nibbles_bf2(pairs[h]);
        __nv_bfloat162 qh = nibbles_bf2(pairs[h] >> 4);
        if (kGrouped) {
          ql = __hmul2(ql, slo[j]);     // one rounding of q * bf16(scale)
          qh = __hmul2(qh, shi[j]);
        }
        lo[j] = bf2_bits(ql);
        hi[j] = bf2_bits(qh);
      }
    }
    uint4* dl = reinterpret_cast<uint4*>(panel + r * kWStride + col);
    uint4* dh = reinterpret_cast<uint4*>(panel + (kPack + r) * kWStride + col);
    dl[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    dl[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    dh[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    dh[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
  }
}

// four 8x8 bf16 matrices from shared memory, the row addresses given by
// lanes 0-7, 8-15, 16-23 and 24-31; `.trans` hands each lane a column pair
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

template <int MT, bool kGrouped>
__global__ void __launch_bounds__(kThreads)
int4_mm_kernel(const Problem p) {
  using Ly = Layout<MT>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last;
  __nv_bfloat16* panel = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* stages = smem + Ly::kPanel;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int n0 = blockIdx.x * kTileN;
  const int m0 = blockIdx.y * 16 * MT;
  const int chunks = p.K / kChunkK;
  const int c_begin = blockIdx.z * p.chunks_per_split;
  const int c_end = min(c_begin + p.chunks_per_split, chunks);
  const bool vec = (p.N % 16 == 0) && (n0 + kTileN <= p.N);

  float acc[MT][kNT][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < kNT; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  // kStages - 1 chunks in flight; one commit group per chunk, empty past
  // the end, so that wait_group counts chunks
#pragma unroll
  for (int s = 0; s < Ly::kStages - 1; ++s) {
    if (c_begin + s < c_end)
      issue_chunk<MT, kGrouped>(p, c_begin + s, n0, m0, vec,
                                stages + s * Ly::kStage);
    cp_async_commit();
  }
  for (int ch = c_begin; ch < c_end; ++ch) {
    const int j = ch - c_begin;
    cp_async_wait<Ly::kStages - 2>();   // this thread's copies of chunk ch
    __syncthreads();                    // everyone's; the panel is free
    const uint8_t* st = stages + (j % Ly::kStages) * Ly::kStage;
    dequant_chunk<MT, kGrouped>(st, panel);
    // the next chunk into the stage that chunk ch - 1 used
    const int ahead = ch + Ly::kStages - 1;
    if (ahead < c_end)
      issue_chunk<MT, kGrouped>(
          p, ahead, n0, m0, vec,
          stages + ((j + Ly::kStages - 1) % Ly::kStages) * Ly::kStage);
    cp_async_commit();
    __syncthreads();
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(st + Ly::kRaw + Ly::kScl);
    // lane l addresses row l % 8 of matrix l / 8: matrices 0 and 1 are
    // rows 0-7 and 8-15 at the first 8 columns, 2 and 3 the next 8
    const int lr = lane % 8 + 8 * ((lane / 8) & 1), lc = 8 * (lane / 16);
#pragma unroll
    for (int ks = 0; ks < kChunkK / 16; ++ks) {
      // B [k][n] transposed: b[nt] = rows 16 ks.. of columns 8 nt..
      uint32_t b[kNT][2];
#pragma unroll
      for (int np = 0; np < kNT; np += 2)
        ldmatrix_x4_trans(&b[np][0], panel + (16 * ks + lr) * kWStride +
                                         kWarpN * warp + 8 * np + lc);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, xs + (16 * mt + lr) * kXStride + 16 * ks + lc);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
      }
    }
  }
  cp_async_wait<0>();

  // the accumulator's element (mt, nt, e) is row 16 mt + gid (+8 for e >= 2),
  // column kWarpN warp + 8 nt + 2 tig + e % 2 of the tile
  if (p.splits == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + 16 * mt + gid + 8 * (e / 2);
          const int n = n0 + kWarpN * warp + 8 * nt + 2 * tig + e % 2;
          if (m < p.M && n < p.N) {
            float v = acc[mt][nt][e];
            if (!kGrouped) v *= __ldg(p.scale + n);
            p.out[static_cast<size_t>(m) * p.N + n] = __float2bfloat16_rn(v);
          }
        }
    return;
  }
  float* part = p.ws + static_cast<size_t>(blockIdx.z) * p.M * p.N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 16 * mt + gid + 8 * (e / 2);
        const int n = n0 + kWarpN * warp + 8 * nt + 2 * tig + e % 2;
        if (m < p.M && n < p.N)
          __stcg(part + static_cast<size_t>(m) * p.N + n, acc[mt][nt][e]);
      }
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (t == 0) last = atomicAdd(p.counters + tile, 1) == p.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block of the tile: the partials summed in split order.  A
  // thread takes one column and 16 rows at a time (the threads of the
  // second half of the block the second 16 rows); its loads of 4 splits
  // are issued before any of their sums (branch-free: rows past M and
  // columns past N read a clamped address and are not written), so that
  // 64 loads are in flight instead of one
  const int n = n0 + t % kTileN;
  const int nc = min(n, p.N - 1);
  const int rows = min(16 * MT, p.M - m0);
  const size_t plane = static_cast<size_t>(p.M) * p.N;
  const float s_n = kGrouped ? 1.f : __ldg(p.scale + nc);
  for (int r0 = 16 * (t / kTileN); r0 < rows;
       r0 += 16 * (kThreads / kTileN)) {
    size_t off[16];
    float v[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      off[r] = static_cast<size_t>(m0 + r0 + min(r, rows - r0 - 1)) * p.N +
               nc;
      v[r] = 0.f;
    }
    for (int s = 0; s < p.splits; s += 4) {
      float part[4][16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* src = p.ws + min(s + j, p.splits - 1) * plane;
#pragma unroll
        for (int r = 0; r < 16; ++r) part[j][r] = __ldcg(src + off[r]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 16; ++r)
          v[r] = s + j < p.splits ? v[r] + part[j][r] : v[r];
    }
    if (n < p.N) {
#pragma unroll
      for (int r = 0; r < 16; ++r)
        if (r0 + r < rows)
          p.out[static_cast<size_t>(m0 + r0 + r) * p.N + n] =
              __float2bfloat16_rn(kGrouped ? v[r] : v[r] * s_n);
    }
  }
  if (t == 0) p.counters[tile] = 0;
}

template <int MT, bool kGrouped>
int launch(const Problem& p, cudaStream_t st) {
  constexpr int kSmem = Layout<MT>::kBytes;
  static bool attr_set = false;         // raised once, above 48 KB
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        int4_mm_kernel<MT, kGrouped>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((p.N + kTileN - 1) / kTileN, (p.M + 16 * MT - 1) / (16 * MT),
            p.splits);
  int4_mm_kernel<MT, kGrouped><<<grid, kThreads, kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [M, K] bf16 (16-byte aligned); qw [K/2, N] int8 packed; scale fp32 [N]
// (groups 1) or [groups, N]; mt the m-tiles of 16 rows a block (1 or 4); K
// split into `splits` ranges of `chunks_per_split` chunks of 64 rows; ws
// [splits, M, N] fp32 and counters (one int32 a tile, zero) when splits > 1;
// out [M, N] bf16.  Needs K % 64 == 0 and (K / groups) % 32 == 0.  Returns
// cudaGetLastError() after the launch (0 = launched).
int int4_quant_matmul(const void* x, const void* qw, const float* scale,
                      int M, int N, int K, int groups, int mt, int splits,
                      int chunks_per_split, float* ws, int* counters,
                      void* out, void* stream) {
  if (M < 1 || N < 1 || K < kChunkK || K % kChunkK || groups < 1 ||
      K % groups || (K / groups) % kPack || splits < 1 ||
      chunks_per_split < 1 ||
      static_cast<long long>(splits) * chunks_per_split * kChunkK < K ||
      (splits > 1 && (ws == nullptr || counters == nullptr)) ||
      (mt != 1 && mt != 4) || reinterpret_cast<uintptr_t>(x) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Problem p{static_cast<const __nv_bfloat16*>(x),
            static_cast<const int8_t*>(qw), scale, M, N, K, K / groups,
            chunks_per_split, splits, ws, counters,
            static_cast<__nv_bfloat16*>(out)};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool grouped = groups > 1;
  if (mt == 1)
    return grouped ? launch<1, true>(p, st) : launch<1, false>(p, st);
  return grouped ? launch<4, true>(p, st) : launch<4, false>(p, st);
}

}  // extern "C"
