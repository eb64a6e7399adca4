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
// The products bound it, so it runs on `wgmma`, and its operands are
// swapped as the decode entry's are: out^T = W^T x^T.  The weight is the
// m64 A operand, unpacked in registers (the register-A form of `wgmma`),
// and x^T is the B operand read from shared memory, so the wgmma's n is
// the block's rows of x (the wrapper's `rows`: 32-256) and each weight is
// unpacked once per block for all of them.  A block owns 128 output
// columns and `rows` rows of x: two consumer warpgroups of 64 columns
// each, sharing the x tiles, and one producer warp.  K is walked in chunks
// of 64 packed rows (the last may have 32): the low nibbles of a chunk are
// rows p0..p0+63 of K, its high nibbles rows K/2+p0.., so x comes as two
// boxes of 64 columns a chunk, and each k16 step of the product takes 16
// packed rows, low nibbles against the low box, high against the high one.
// The producer's lane 0 copies each chunk into a ring of `stages` stages by
// TMA: the two x boxes [rows][64] and the packed bytes [64][128], both in
// the 128-byte swizzle, and (grouped) the chunk's four scale rows (the low
// and high group of each half of 32 packed rows; a group is a multiple of
// 32 rows), all counted on the stage's `full` mbarrier; the consumers free
// a stage on its `empty` mbarrier once their products on it are done.
// Where N is not a multiple of 16 (no TMA map of the weight) the producer
// warp's lanes copy the bytes and scales themselves.  No block-wide
// barrier in the K loop.  A consumer thread (warp w of its warpgroup, lane
// (g, t)) owns two adjacent columns: A rows 16w + g and 16w + g + 8 of the
// m64 tile.  For a k16 step it reads one 2-byte word of packed rows 2t,
// 2t + 1, 2t + 8 and 2t + 9 of the step (conflict-free in the swizzle) and
// turns them into its A fragments of the low and the high step (the
// nibbles into bf16 as below).  Each step of a chunk has fragments of its
// own, so a chunk's products are all in flight while its later steps are
// unpacked; the chunk is drained before the next (no product in flight
// across the loop, where the compiler would serialise them).  The first
// product sets the accumulators (scale-d 0).  One launch, no split of K,
// no workspace and no counters; the sum order is fixed, so a call is
// deterministic.  The wrapper's `prefill_plan` picks `rows` (so that the
// tiles fill one wave of the card's SMs where a tile size does) and the
// stages; this entry refuses any other.  `tools/int4_kernel_probe.py`
// times it by plan and reads its phases: a chunk costs about a fixed 125
// cycles a `wgmma` (16 a chunk) on top of the products' time.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

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

constexpr int kPack = 32;               // packed rows of the smallest K step
constexpr int kChunkK = 2 * kPack;      // K must be a multiple of this

// -- the prefill entry (M > 32) ----------------------------------------------

namespace prefill {

constexpr int kCols = 128;              // output columns a block
constexpr int kChunk = 64;              // packed rows a stage
constexpr int kConsumerWarps = 8;       // two warpgroups of 64 columns
constexpr int kThreads = 32 * kConsumerWarps + 32;   // + the producer warp
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kWBytes = kChunk * kCols;              // packed bytes a stage
constexpr int kSBytes = 4 * kCols * 4;               // four fp32 scale rows

// one x box: `rows` rows of 64 bf16 (128 bytes, one swizzle row each)
__host__ __device__ constexpr int x_bytes(int rows) { return rows * 128; }
// a stage: the low and high x boxes, the packed bytes, the scale rows;
// every part a multiple of 1024 bytes (the swizzle's period)
__host__ __device__ constexpr int stage_bytes(int rows) {
  return 2 * x_bytes(rows) + kWBytes + kSBytes;
}
// the rows of x a block may take (each an instantiation: the wgmma's n)
__host__ __device__ constexpr bool rows_ok(int r) {
  return r == 32 || r == 64 || r == 80 || r == 128 || r == 160 || r == 256;
}
size_t smem_bytes(int rows, int stages) {
  return 1024 + static_cast<size_t>(stages) * stage_bytes(rows) +
         16 * static_cast<size_t>(stages);
}

struct Problem {
  const int8_t* qw;                     // [K/2, N] (the copies without TMA)
  const float* scale;                   // [N] or [G, N]
  __nv_bfloat16* out;                   // [M, N]
  int M, N, K, gs;                      // gs: rows of K a group
  int stages;
  int tma_w;                            // 1: the weight and scales by TMA
};

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

// a box of a 2-d tensor map at (c0, c1) into shared memory, on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a tile of 128-byte rows in the 128-byte
// swizzle (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B): groups of 8
// rows 1024 bytes apart; the leading offset is unused at this width
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
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
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d = A B + (scale_d ? d : 0): m64 n`N` k16, A (64 x 16 bf16, the weight)
// from registers, B (N rows of x, 16 columns) from shared memory K-major
// in the 128-byte swizzle; fp32 accumulators
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<160>(float (&d)[80],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


__device__ __forceinline__ void fence_regs4(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// a bf16 pair of two nibbles (bits 0-3 and 16-19 of v) and its signed
// values: 0x4300 | (n ^ 8) is 128 + (n ^ 8) in bf16, and n ^ 8 - 8 is the
// two's-complement value of n; every step is exact
__device__ __forceinline__ uint32_t nibbles_bf2(uint32_t v) {
  const uint32_t u = (v & 0x000F000Fu) ^ 0x43084308u;
  return bf2_bits(__hsub2(bits_bf2(u), __floats2bfloat162_rn(136.f, 136.f)));
}

// The thread's A fragments of one k16 step from its four words (packed
// rows 2t, 2t + 1, 2t + 8, 2t + 9 of the step; byte 0 column c, byte 1
// column c + 1): a[0] = (row 2t, 2t + 1) of column c (A row g), a[1] the
// same of column c + 1 (A row g + 8), a[2], a[3] rows 2t + 8, 2t + 9; lo
// from the low nibbles (rows p of K), hi from the high ones (K/2 + p).
// Grouped: each weight times the bf16 pair of its column's scale (s[0]
// column c, s[1] column c + 1; one rounding).
template <bool kGrouped>
__device__ __forceinline__ void unpack_step(const uint32_t (&v)[4],
                                            const uint32_t (&slo)[2],
                                            const uint32_t (&shi)[2],
                                            uint32_t (&lo)[4],
                                            uint32_t (&hi)[4]) {
  // byte b of rows (2t, 2t+1) and (2t+8, 2t+9) into the low bytes of the
  // two halves
  const uint32_t e[4] = {__byte_perm(v[0], v[1], 0x0400),
                         __byte_perm(v[0], v[1], 0x0501),
                         __byte_perm(v[2], v[3], 0x0400),
                         __byte_perm(v[2], v[3], 0x0501)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo[i] = nibbles_bf2(e[i]);
    hi[i] = nibbles_bf2(e[i] >> 4);
    if (kGrouped) {
      lo[i] = bf2_bits(__hmul2(bits_bf2(lo[i]), bits_bf2(slo[i & 1])));
      hi[i] = bf2_bits(__hmul2(bits_bf2(hi[i]), bits_bf2(shi[i & 1])));
    }
  }
}

template <int R, bool kGrouped>
__global__ void __launch_bounds__(kThreads, 1)
int4_prefill_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap s_map,
                    const Problem p) {
  constexpr int kStage = stage_bytes(R);
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* const base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int S = p.stages;
  uint64_t* const full = reinterpret_cast<uint64_t*>(base + S * kStage);
  uint64_t* const empty = full + S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kCols, m0 = blockIdx.y * R;
  const int kh = p.K / 2;
  const int chunks = (kh + kChunk - 1) / kChunk;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], p.tma_w ? 1 : 32);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the chunk's scale rows: 2h (low) and 2h + 1 (high) of half h of 32
  // packed rows (a group is a multiple of 32 rows: one group each)
  auto group_of = [&](int row) { return row / p.gs; };

  if (warp == kConsumerWarps) {
    // the producer: chunk c into stage c % S once the consumers freed it
    for (int c = 0; c < chunks; ++c) {
      const int st = c % S, p0 = c * kChunk;
      const int srows = 2 * (min(kChunk, kh - p0) / kPack);
      if (c >= S) mbar_wait(&empty[st], ((c / S) - 1) & 1);
      uint8_t* const stg = base + st * kStage;
      uint8_t* const wsm = stg + 2 * x_bytes(R);
      float* const ssm = reinterpret_cast<float*>(wsm + kWBytes);
      if (!p.tma_w) {
        // packed byte (r, col) of the chunk at row r, 16-byte chunk
        // (col / 16) ^ (r % 8): the 128-byte swizzle that TMA writes
        for (int i = lane; i < kChunk * kCols; i += 32) {
          const int r = i / kCols, col = i % kCols;
          const int8_t v = p0 + r < kh && n0 + col < p.N
                               ? p.qw[static_cast<size_t>(p0 + r) * p.N +
                                      n0 + col]
                               : int8_t(0);
          wsm[r * kCols + (((col / 16) ^ (r % 8)) * 16) + col % 16] =
              static_cast<uint8_t>(v);
        }
        if (kGrouped) {
          for (int i = lane; i < srows * kCols; i += 32) {
            const int row = i / kCols, col = i % kCols;
            const int g = group_of((row % 2 ? kh : 0) + p0 +
                                   kPack * (row / 2));
            ssm[i] = n0 + col < p.N
                         ? p.scale[static_cast<size_t>(g) * p.N + n0 + col]
                         : 0.f;
          }
        }
      }
      if (lane == 0) {
        uint32_t bytes = 2 * x_bytes(R);
        if (p.tma_w) bytes += kWBytes + (kGrouped ? srows * kCols * 4 : 0);
        mbar_expect_tx(&full[st], bytes);
        tma_load(stg, &x_map, &full[st], p0, m0);
        tma_load(stg + x_bytes(R), &x_map, &full[st], kh + p0, m0);
        if (p.tma_w) {
          tma_load(wsm, &w_map, &full[st], n0, p0);
          if (kGrouped)
            for (int row = 0; row < srows; ++row)
              tma_load(ssm + row * kCols, &s_map, &full[st], n0,
                       group_of((row % 2 ? kh : 0) + p0 + kPack * (row / 2)));
        }
      } else if (!p.tma_w) {
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // a consumer: warp w of warpgroup wg, lane (g, t); its columns c and
  // c + 1
  const int wg = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4;
  const int c = 64 * wg + 16 * w + 2 * g;
  const int c16 = c / 16;               // its 16-byte chunk of a row
  // the accumulators are set by the first product (its scale-d 0), so
  // no other instruction defines them while products run
  float acc[R / 2];
  uint32_t alo[4][4], ahi[4][4];        // a chunk's steps' fragments
  const int n = n0 + c;
  const bool pair = n + 1 < p.N && p.N % 2 == 0;
  // chunk ch's kSteps k16 steps (4, or 2 in a last chunk of 32 packed
  // rows)
  auto chunk = [&](auto steps_t, int ch) {
    constexpr int kSteps = decltype(steps_t)::value;
    const int st = ch % S;
    const uint8_t* const stg = base + st * kStage;
    const uint8_t* const wsm = stg + 2 * x_bytes(R);
    const uint64_t dlo = desc_sw128(stg);
    const uint64_t dhi = desc_sw128(stg + x_bytes(R));
    const float* const ssm = reinterpret_cast<const float*>(wsm + kWBytes);
    // grouped: the bf16 pairs of the scales of columns c and c + 1, the
    // low and the high group of each half of the chunk
    uint32_t slo[2][2], shi[2][2];
    if (kGrouped) {
#pragma unroll
      for (int h = 0; h < kSteps / 2; ++h) {
        const int row = 2 * h;
        const float2 l =
            *reinterpret_cast<const float2*>(ssm + row * kCols + c);
        const float2 u =
            *reinterpret_cast<const float2*>(ssm + (row + 1) * kCols + c);
        slo[h][0] = bf2_bits(__floats2bfloat162_rn(l.x, l.x));
        slo[h][1] = bf2_bits(__floats2bfloat162_rn(l.y, l.y));
        shi[h][0] = bf2_bits(__floats2bfloat162_rn(u.x, u.x));
        shi[h][1] = bf2_bits(__floats2bfloat162_rn(u.y, u.y));
      }
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // rows 2t, 2t + 1, 2t + 8, 2t + 9 of the step
        const int r = 16 * j + 2 * t + (q & 1) + 8 * (q >> 1);
        v[q] = *reinterpret_cast<const uint16_t*>(
            wsm + r * kCols + ((c16 ^ (r % 8)) * 16) + 2 * g);
      }
      unpack_step<kGrouped>(v, slo[j / 2], shi[j / 2], alo[j], ahi[j]);
      fence_regs4(alo[j]);
      fence_regs4(ahi[j]);
      wgmma_fence();
      wgmma_rs<R>(acc, alo[j], dlo + 2 * j, ch > 0 || j > 0);
      wgmma_rs<R>(acc, ahi[j], dhi + 2 * j, 1);
      wgmma_commit();
    }
    // the chunk's products are done before the loop turns (no product
    // in flight across it): its fragments, kept untouched until here,
    // and its stage are free
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      fence_regs4(alo[j]);
      fence_regs4(ahi[j]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  };
  for (int ch = 0; ch < chunks; ++ch) {
    mbar_wait(&full[ch % S], (ch / S) & 1);
    if (kh - ch * kChunk >= kChunk)
      chunk(std::integral_constant<int, 4>{}, ch);
    else
      chunk(std::integral_constant<int, 2>{}, ch);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // accumulator (nt, i): x row m0 + 8 nt + 2t + i % 2, column c + i / 2
  float s0 = 1.f, s1 = 1.f;
  if (!kGrouped) {
    if (n < p.N) s0 = __ldg(p.scale + n);
    if (n + 1 < p.N) s1 = __ldg(p.scale + n + 1);
  }
#pragma unroll
  for (int nt = 0; nt < R / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + 8 * nt + 2 * t + i;
      if (m < p.M) {
        const float v0 = kGrouped ? acc[4 * nt + i] : acc[4 * nt + i] * s0;
        const float v1 =
            kGrouped ? acc[4 * nt + 2 + i] : acc[4 * nt + 2 + i] * s1;
        __nv_bfloat16* o = p.out + static_cast<size_t>(m) * p.N + n;
        if (pair) {
          *reinterpret_cast<__nv_bfloat162*>(o) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (n < p.N) o[0] = __float2bfloat16_rn(v0);
          if (n + 1 < p.N) o[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

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
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// the map of a row-major [rows, cols] matrix of `type` (`esize` bytes an
// element) in boxes of [box_rows, box_cols], rows and columns past the end
// read as zeros
int encode_2d(CUtensorMap* map, CUtensorMapDataType type, int esize,
              const void* ptr, long long rows, long long cols, int box_rows,
              int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int R, bool kGrouped>
int launch(const void* x, const Problem& p, int groups, cudaStream_t st) {
  auto kernel = int4_prefill_kernel<R, kGrouped>;
  // the attribute of the function, raised to the most any plan takes
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  // the maps are kernel parameters, encoded for each call (no cache)
  CUtensorMap x_map, w_map, s_map;
  memset(&w_map, 0, sizeof(w_map));
  memset(&s_map, 0, sizeof(s_map));
  int e = encode_2d(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, p.M, p.K,
                    R, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!e && p.tma_w)
    e = encode_2d(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.qw, p.K / 2,
                  p.N, kChunk, kCols, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!e && p.tma_w && kGrouped)
    e = encode_2d(&s_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.scale,
                  groups, p.N, 1, kCols, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e) return e;
  dim3 grid((p.N + kCols - 1) / kCols, (p.M + R - 1) / R);
  kernel<<<grid, kThreads, smem_bytes(R, p.stages), st>>>(x_map, w_map,
                                                          s_map, p);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int dispatch(const void* x, const Problem& p, int groups, cudaStream_t st) {
  return groups > 1 ? launch<R, true>(x, p, groups, st)
                    : launch<R, false>(x, p, groups, st);
}

}  // namespace prefill

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

// The prefill entry.  x [M, K] bf16, qw [K/2, N] int8 packed, scale fp32
// [N] (groups 1) or [groups, N], all three 16-byte aligned; out [M, N]
// bf16.  Needs K % 64 == 0 and (K / groups) % 32 == 0.  The plan (the
// wrapper's `prefill_plan`): blocks of 128 output columns and `rows` rows
// of x (32, 64, 80, 128, 160 or 256), a ring of `stages` stages (2-8)
// within 227 KB of shared memory.  Returns cudaGetLastError() after the
// launch (0 = launched); any other plan or operand is refused.
int int4_quant_matmul(const void* x, const void* qw, const float* scale,
                      int M, int N, int K, int groups, int rows, int stages,
                      void* out, void* stream) {
  if (M < 1 || N < 1 || K < kChunkK || K % kChunkK || groups < 1 ||
      K % groups || (K / groups) % kPack || !prefill::rows_ok(rows) ||
      stages < 2 || stages > prefill::kMaxStages ||

      prefill::smem_bytes(rows, stages) > prefill::kMaxSmem ||
      (M + rows - 1) / rows > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(qw) % 16 ||
      reinterpret_cast<uintptr_t>(scale) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  // the weight's rows are N bytes apart: a TMA map needs them on 16 bytes
  prefill::Problem p{static_cast<const int8_t*>(qw), scale,
                     static_cast<__nv_bfloat16*>(out), M, N, K, K / groups,
                     stages, N % 16 == 0};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (rows) {
    case 32: return prefill::dispatch<32>(x, p, groups, st);
    case 64: return prefill::dispatch<64>(x, p, groups, st);
    case 80: return prefill::dispatch<80>(x, p, groups, st);
    case 128: return prefill::dispatch<128>(x, p, groups, st);
    case 160: return prefill::dispatch<160>(x, p, groups, st);
    default: return prefill::dispatch<256>(x, p, groups, st);
  }
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
