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
// Both entries turn two nibbles into a bf16 pair the same way: the nibble
// xor 8 set into the mantissa of 128.0, minus 136 (exact); grouped, times
// the bf16 pair of their scales (one rounding, the TPU kernel's).
//
// Two entries, one launch a call each; the wrapper picks one by M and passes
// its plan, which the entry checks and refuses otherwise.
//
// The decode entry (`int4_quant_matmul_decode`, M <= 32: the decode
// linears at M 8).  The call is a stream of 2-8 MB read once, so what costs
// is every dependent round trip.  The operands are swapped: out^T = W^T x^T,
// the weight the m16 A operand of `mma.sync.m16n8k16` (16 output columns)
// and x^T the n8 B operand (M 8 fills n8).  A warp owns 128 columns and
// walks K in steps of 8 packed rows: lane (g, t) loads 16 contiguous bytes
// (columns 16g..16g+15) of packed rows r + 2t and r + 2t + 1 with two
// 16-byte loads, and those bytes are its A fragments as they lie.  The k
// order inside an `mma` and the assignment of output columns to A rows are
// free (the fp32 sum order is held against the plain version with a
// tolerance, not pinned): byte (i, n) -- row i in its low nibble, row
// i + K/2 in its high one -- is exactly one bf16x2 A register, column n's
// pair of k.  So byte 2j of row r + 2t is a0 of mma j (A row g <-> column
// 16g + 2j), byte 2j + 1 is a1 (A row g + 8 <-> column 16g + 2j + 1), and
// row r + 2t + 1 gives a2, a3; B is then (x[r+2t], x[r+2t+K/2]) and
// (x[r+2t+1], x[r+2t+1+K/2]), two 4-byte loads of x and two byte permutes.
// The nibbles become bf16 in registers (`prmt`, then the 0x4300 mantissa
// trick below), with no shared-memory panel and no block barrier per step.
// Each warp keeps up to 4 steps of loads in flight (64 KB a block of 8
// warps at most): at the SantaCoder-1B shapes every byte of a block's share
// is requested in the first round or two.  K is split over the warps of a
// block (summed in shared memory in warp order) and over the blocks of a
// thread-block cluster (grid (N/128, C), cluster (1, C)): rank r > 0 sends
// its block's sums into rank 0's shared memory with `st.async`, counted in
// bytes on rank 0's mbarrier, and rank 0 adds the ranks in order, applies a
// per-channel scale and writes bf16.  No workspace in device memory, no
// counters, no atomics; the sum order is fixed, so a call is
// deterministic.
//
// The prefill entry (`int4_quant_matmul`, M > 32: the prefill at M 512).
// A block computes a [64, 128] output tile with 8 warps, 16 columns each,
// on the tensor cores (`mma.sync.m16n8k16` bf16 with fp32 accumulators,
// fragments loaded by `ldmatrix`).  K is walked in chunks of 32 packed
// rows, which give 64 rows of K: 32 low nibbles (rows p0..p0+31) and 32
// high ones (rows K/2+p0..), so every packed byte is read once and both
// its nibbles are used.  A chunk's packed bytes [32][128] (a warp reads 4
// rows of 128 contiguous bytes: the packed layout is N-minor), its two
// scale rows (low and high group; a group is a multiple of 32 rows, so one
// row each) and its x tile [64][64] are copied by `cp.async` into a ring of
// kStages shared-memory stages, kStages - 1 chunks ahead of the one being
// used.  Each thread then unpacks 16 columns of one packed row into the
// bf16 weight panel [64][128] and the warps run the products from there.
// Where a tile row of blocks does not fill the card, K is split along
// chunk boundaries into `splits` ranges, one block each: a split block
// writes its fp32 partial tile, and the last block of a tile to finish (an
// atomic counter per tile, which it resets) sums the partials in split
// order, applies the per-channel scale and rounds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

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

// the prefill entry: four m-tiles of 16 rows a block
constexpr int MT = 4;

struct Layout {
  static constexpr int kStages = 3;
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
template <bool kGrouped>
__device__ __forceinline__ void issue_chunk(const Problem& p, int chunk,
                                            int n0, int m0, bool vec,
                                            uint8_t* st) {
  using Ly = Layout;
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
template <bool kGrouped>
__device__ __forceinline__ void dequant_chunk(const uint8_t* st,
                                              __nv_bfloat16* panel) {
  using Ly = Layout;
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

template <bool kGrouped>
__global__ void __launch_bounds__(kThreads)
int4_mm_kernel(const Problem p) {
  using Ly = Layout;
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
      issue_chunk<kGrouped>(p, c_begin + s, n0, m0, vec,
                                stages + s * Ly::kStage);
    cp_async_commit();
  }
  for (int ch = c_begin; ch < c_end; ++ch) {
    const int j = ch - c_begin;
    cp_async_wait<Ly::kStages - 2>();   // this thread's copies of chunk ch
    __syncthreads();                    // everyone's; the panel is free
    const uint8_t* st = stages + (j % Ly::kStages) * Ly::kStage;
    dequant_chunk<kGrouped>(st, panel);
    // the next chunk into the stage that chunk ch - 1 used
    const int ahead = ch + Ly::kStages - 1;
    if (ahead < c_end)
      issue_chunk<kGrouped>(
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

template <bool kGrouped>
int launch(const Problem& p, cudaStream_t st) {
  constexpr int kSmem = Layout::kBytes;
  static bool attr_set = false;         // raised once, above 48 KB
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        int4_mm_kernel<kGrouped>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((p.N + kTileN - 1) / kTileN, (p.M + 16 * MT - 1) / (16 * MT),
            p.splits);
  int4_mm_kernel<kGrouped><<<grid, kThreads, kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// -- the decode entry (M <= 32) ----------------------------------------------

namespace decode {

constexpr int kCols = 128;              // output columns a warp and a block
constexpr int kStep = 8;                // packed rows a warp step
constexpr int kMaxWarps = 8;
constexpr int kMinWarps = 4;
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 227 * 1024;

struct Problem {
  const __nv_bfloat16* x;               // [M, K]
  const int8_t* qw;                     // [K/2, N]
  const float* scale;                   // [N] or [G, N]
  __nv_bfloat16* out;                   // [M, N]
  int M, N, K, gs;                      // gs: rows of K a group
  int steps;                            // steps of 8 packed rows a warp
};

// the partial sums of a block: float4 (j, t, lane) of mma j, n8 tile t
template <int NT>
__host__ __device__ constexpr int partials() { return 8 * NT * 32; }

// shared memory: every warp's partials, then rank 0's receive buffer for
// the other ranks' block sums
template <int NT>
constexpr size_t smem_bytes(int warps, int cluster) {
  return static_cast<size_t>(warps + cluster - 1) * partials<NT>() * 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint4 ldg_nc16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// byte `pos` of w as a bf16 pair (its low nibble, its high nibble), each
// the nibble's signed value: sh is w >> 4, whose byte `pos` holds the high
// nibble in its low bits
template <int kPos>
__device__ __forceinline__ uint32_t nib_pair(uint32_t w, uint32_t sh) {
  constexpr uint32_t sel = kPos | (kPos << 4) | ((4 + kPos) << 8) |
                           ((4 + kPos) << 12);
  uint32_t u = __byte_perm(w, sh, sel);
  u = (u & 0x000F000Fu) ^ 0x43084308u;  // 128 + (n ^ 8), two halves
  return bf2_bits(__hsub2(bits_bf2(u), __floats2bfloat162_rn(136.f, 136.f)));
}

template <int NT, bool kGrouped, bool kVec>
__global__ void __launch_bounds__(kMaxWarps * 32)
int4_decode_kernel(const Problem p) {
  // steps of loads a warp keeps in flight (registers: 8 a step, plus x)
  constexpr int kDepth = NT == 1 ? 4 : NT == 2 ? 2 : 1;
  extern __shared__ __align__(16) float4 red[];   // [warps][partials]
  __shared__ __align__(8) uint64_t bar;           // rank 0: the ranks' sums
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int warps = blockDim.x / 32;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int kh = p.K / 2;
  const int c0 = blockIdx.x * kCols + 16 * gid;   // this lane's 16 columns
  const bool live = c0 < p.N;
  constexpr int kParts = partials<NT>();
  float4* const recv = red + warps * kParts;      // [csize - 1][partials]

  if (csize > 1) {
    if (tid == 0 && rank == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          smem_u32(&bar)));
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_u32(&bar)),
          "r"(static_cast<uint32_t>((csize - 1) * kParts * 16))
          : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }

  // this warp's packed rows: [r_warp, r_warp + 8 steps)
  const int r_warp = (rank * warps + warp) * p.steps * kStep;

  uint4 wa[kDepth], wb[kDepth];
  uint32_t xl[kDepth][NT], xh[kDepth][NT];
  auto load = [&](int d, int s) {
    const int ra = r_warp + s * kStep + 2 * tig;   // rows ra, ra + 1
    const int8_t* src = p.qw + static_cast<size_t>(ra) * p.N + c0;
    if (kVec) {
      wa[d] = live ? ldg_nc16(src) : make_uint4(0, 0, 0, 0);
      wb[d] = live ? ldg_nc16(src + p.N) : make_uint4(0, 0, 0, 0);
    } else {
      uint32_t a[4] = {0, 0, 0, 0}, b[4] = {0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        if (c0 + e < p.N) {
          a[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[e]))
                      << (8 * (e % 4));
          b[e / 4] |= static_cast<uint32_t>(
                          static_cast<uint8_t>(src[p.N + e]))
                      << (8 * (e % 4));
        }
      }
      wa[d] = make_uint4(a[0], a[1], a[2], a[3]);
      wb[d] = make_uint4(b[0], b[1], b[2], b[3]);
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int m = 8 * t + gid;
      const __nv_bfloat16* xr = p.x + static_cast<size_t>(m) * p.K + ra;
      xl[d][t] = m < p.M ? __ldg(reinterpret_cast<const uint32_t*>(xr)) : 0u;
      xh[d][t] =
          m < p.M ? __ldg(reinterpret_cast<const uint32_t*>(xr + kh)) : 0u;
    }
  };

  // grouped: the bf16 pairs (scale of the low nibble's group, of the high
  // nibble's) of the lane's 16 columns, loaded when the step's groups change
  uint32_t sc2[16];
  int g_lo = -1, g_hi = -1;
  auto scales = [&](int s) {
    const int r = r_warp + s * kStep;
    const int lo = r / p.gs, hi = (r + kh) / p.gs;
    if (lo == g_lo && hi == g_hi) return;
    g_lo = lo;
    g_hi = hi;
    const float* sl = p.scale + static_cast<size_t>(lo) * p.N + c0;
    const float* sh = p.scale + static_cast<size_t>(hi) * p.N + c0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (kVec) {
        if (live) {
          a = __ldg(reinterpret_cast<const float4*>(sl) + q);
          b = __ldg(reinterpret_cast<const float4*>(sh) + q);
        }
      } else {
        float* pa = &a.x;
        float* pb = &b.x;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c0 + 4 * q + e < p.N) {
            pa[e] = __ldg(sl + 4 * q + e);
            pb[e] = __ldg(sh + 4 * q + e);
          }
        }
      }
      sc2[4 * q + 0] = bf2_bits(__floats2bfloat162_rn(a.x, b.x));
      sc2[4 * q + 1] = bf2_bits(__floats2bfloat162_rn(a.y, b.y));
      sc2[4 * q + 2] = bf2_bits(__floats2bfloat162_rn(a.z, b.z));
      sc2[4 * q + 3] = bf2_bits(__floats2bfloat162_rn(a.w, b.w));
    }
  };

  float acc[8][NT][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][t][e] = 0.f;

  auto compute = [&](int d) {
    uint32_t b[NT][2];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      b[t][0] = __byte_perm(xl[d][t], xh[d][t], 0x5410);   // row ra
      b[t][1] = __byte_perm(xl[d][t], xh[d][t], 0x7632);   // row ra + 1
    }
    const uint32_t wA[4] = {wa[d].x, wa[d].y, wa[d].z, wa[d].w};
    const uint32_t wB[4] = {wb[d].x, wb[d].y, wb[d].z, wb[d].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {          // columns 4q .. 4q + 3: mmas 2q, 2q+1
      const uint32_t sA = wA[q] >> 4, sB = wB[q] >> 4;
      uint32_t a[2][4];
      a[0][0] = nib_pair<0>(wA[q], sA);
      a[0][1] = nib_pair<1>(wA[q], sA);
      a[0][2] = nib_pair<0>(wB[q], sB);
      a[0][3] = nib_pair<1>(wB[q], sB);
      a[1][0] = nib_pair<2>(wA[q], sA);
      a[1][1] = nib_pair<3>(wA[q], sA);
      a[1][2] = nib_pair<2>(wB[q], sB);
      a[1][3] = nib_pair<3>(wB[q], sB);
      if (kGrouped) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * q + 2 * h;     // the columns of a[h][0], a[h][1]
          a[h][0] = bf2_bits(__hmul2(bits_bf2(a[h][0]), bits_bf2(sc2[e])));
          a[h][1] = bf2_bits(__hmul2(bits_bf2(a[h][1]),
                                     bits_bf2(sc2[e + 1])));
          a[h][2] = bf2_bits(__hmul2(bits_bf2(a[h][2]), bits_bf2(sc2[e])));
          a[h][3] = bf2_bits(__hmul2(bits_bf2(a[h][3]),
                                     bits_bf2(sc2[e + 1])));
        }
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        mma_bf16(acc[2 * q][t], a[0], b[t]);
        mma_bf16(acc[2 * q + 1][t], a[1], b[t]);
      }
    }
  };

  // every step's loads kDepth steps ahead of its products; the first
  // step's scales requested with them
#pragma unroll
  for (int d = 0; d < kDepth; ++d)
    if (d < p.steps) load(d, d);
  if (kGrouped) scales(0);
  // where the warp's rows lie in one group (low and high), its scales are
  // the first step's throughout, and the steps need no check between them
  const int r_last = r_warp + (p.steps - 1) * kStep;
  const bool one_group = !kGrouped || (r_warp / p.gs == r_last / p.gs &&
                                       (r_warp + kh) / p.gs ==
                                           (r_last + kh) / p.gs);
  auto steps = [&](auto per_step_scales) {
    for (int s0 = 0; s0 < p.steps; s0 += kDepth) {
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const int s = s0 + d;
        if (s < p.steps) {
          if (decltype(per_step_scales)::value) scales(s);
          compute(d);
          if (s + kDepth < p.steps) load(d, s + kDepth);
        }
      }
    }
  };
  if (one_group)
    steps(std::false_type{});
  else
    steps(std::true_type{});

  // the warps' sums, added in warp order
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int t = 0; t < NT; ++t)
      red[warp * kParts + (j * NT + t) * 32 + lane] =
          make_float4(acc[j][t][0], acc[j][t][1], acc[j][t][2],
                      acc[j][t][3]);
  __syncthreads();
  // thread tid sums float4s tid, tid + blockDim.x, ... (4 or 8 warps)
  constexpr int kIters = kParts / (32 * kMinWarps);
  float4 mine[kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int q = tid + i * blockDim.x;
    if (q >= kParts) break;
    float4 v = red[q];
    for (int w = 1; w < warps; ++w) {
      const float4 u = red[w * kParts + q];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    mine[i] = v;
  }
  if (csize > 1) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (rank != 0) {
      // the block's sums into rank 0's receive buffer, slot rank - 1
      uint32_t rb;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(rb) : "r"(smem_u32(&bar)), "r"(0));
#pragma unroll
      for (int i = 0; i < kIters; ++i) {
        const int q = tid + i * blockDim.x;
        if (q >= kParts) break;
        uint32_t rd;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                     : "=r"(rd)
                     : "r"(smem_u32(recv + (rank - 1) * kParts + q)),
                       "r"(0));
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
            "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(rd),
            "f"(mine[i].x), "f"(mine[i].y), "f"(mine[i].z), "f"(mine[i].w),
            "r"(rb)
            : "memory");
      }
      return;
    }
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(smem_u32(&bar)) : "memory");
    }
  }
  // rank 0: the ranks in order, the per-channel scale, bf16 out.  Float4
  // q is (mma j, tile t, lane): out[8t + 2 tig (+1)][col 16 gid + 2j (+1)]
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int q = tid + i * blockDim.x;
    if (q >= kParts) break;
    float4 v = mine[i];
    for (int r = 1; r < csize; ++r) {
      const float4 u = recv[(r - 1) * kParts + q];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const int l = q % 32, t = (q / 32) % NT, j = q / (32 * NT);
    const int m = 8 * t + 2 * (l % 4);
    const int n = blockIdx.x * kCols + 16 * (l / 4) + 2 * j;
    const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int mm = m + e % 2, nn = n + e / 2;
      if (mm < p.M && nn < p.N) {
        const float s = kGrouped ? vals[e] : vals[e] * __ldg(p.scale + nn);
        p.out[static_cast<size_t>(mm) * p.N + nn] = __float2bfloat16_rn(s);
      }
    }
  }
}

template <int NT, bool kGrouped, bool kVec>
int launch(const Problem& p, int warps, int csize, cudaStream_t st) {
  auto kernel = int4_decode_kernel<NT, kGrouped, kVec>;
  const size_t smem = smem_bytes<NT>(warps, csize);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.N + kCols - 1) / kCols, csize);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = csize;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int dispatch(const Problem& p, bool grouped, bool vec, int warps, int csize,
             cudaStream_t st) {
  if (grouped)
    return vec ? launch<NT, true, true>(p, warps, csize, st)
               : launch<NT, true, false>(p, warps, csize, st);
  return vec ? launch<NT, false, true>(p, warps, csize, st)
             : launch<NT, false, false>(p, warps, csize, st);
}

}  // namespace decode

}  // namespace

extern "C" {

// The prefill entry.  x [M, K] bf16 (16-byte aligned); qw [K/2, N] int8
// packed; scale fp32 [N] (groups 1) or [groups, N]; blocks of 64 rows; K
// split into `splits` ranges of `chunks_per_split` chunks of 64 rows; ws
// [splits, M, N] fp32 and counters (one int32 a tile, zero) when splits > 1;
// out [M, N] bf16.  Needs K % 64 == 0 and (K / groups) % 32 == 0.  Returns
// cudaGetLastError() after the launch (0 = launched).
int int4_quant_matmul(const void* x, const void* qw, const float* scale,
                      int M, int N, int K, int groups, int splits,
                      int chunks_per_split, float* ws, int* counters,
                      void* out, void* stream) {
  if (M < 1 || N < 1 || K < kChunkK || K % kChunkK || groups < 1 ||
      K % groups || (K / groups) % kPack || splits < 1 ||
      chunks_per_split < 1 ||
      static_cast<long long>(splits) * chunks_per_split * kChunkK < K ||
      (splits > 1 && (ws == nullptr || counters == nullptr)) ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Problem p{static_cast<const __nv_bfloat16*>(x),
            static_cast<const int8_t*>(qw), scale, M, N, K, K / groups,
            chunks_per_split, splits, ws, counters,
            static_cast<__nv_bfloat16*>(out)};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool grouped = groups > 1;
  return grouped ? launch<true>(p, st) : launch<false>(p, st);
}

// The decode entry.  x [M, K] bf16 (16-byte aligned), M <= 32; qw, scale
// and out as above.  The plan (the wrapper's `decode_plan`): a cluster of
// `cluster` blocks (1-8) along K for every 128 output columns, `warps`
// warps a block (4 or 8), each `steps` steps of 8 packed rows, covering K/2
// packed rows exactly.  With N % 16 == 0, qw and scale must be 16-byte
// aligned (16-byte loads).  Returns cudaGetLastError() after the launch
// (0 = launched); any other plan or operand is refused.
int int4_quant_matmul_decode(const void* x, const void* qw,
                             const float* scale, int M, int N, int K,
                             int groups, int cluster, int warps, int steps,
                             void* out, void* stream) {
  const bool vec = N % 16 == 0;
  const int nt = (M + 7) / 8 <= 2 ? (M + 7) / 8 : 4;
  if (M < 1 || M > 32 || N < 1 || K < kChunkK || K % kChunkK ||
      groups < 1 || K % groups || (K / groups) % kPack || cluster < 1 ||
      cluster > decode::kMaxCluster ||
      (warps != decode::kMinWarps && warps != decode::kMaxWarps) ||
      steps < 1 ||
      static_cast<long long>(cluster) * warps * steps * decode::kStep !=
          K / 2 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      (vec && (reinterpret_cast<uintptr_t>(qw) % 16 ||
               reinterpret_cast<uintptr_t>(scale) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      nt == 1 ? decode::smem_bytes<1>(warps, cluster)
              : nt == 2 ? decode::smem_bytes<2>(warps, cluster)
                        : decode::smem_bytes<4>(warps, cluster);
  if (smem > decode::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  decode::Problem p{static_cast<const __nv_bfloat16*>(x),
                    static_cast<const int8_t*>(qw), scale,
                    static_cast<__nv_bfloat16*>(out), M, N, K, K / groups,
                    steps};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool grouped = groups > 1;
  if (nt == 1) return decode::dispatch<1>(p, grouped, vec, warps, cluster, st);
  if (nt == 2) return decode::dispatch<2>(p, grouped, vec, warps, cluster, st);
  return decode::dispatch<4>(p, grouped, vec, warps, cluster, st);
}

}  // extern "C"
