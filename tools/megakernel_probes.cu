// The megakernel design probes of benchmarks/megakernel_probe{,2,3}.py as
// hand-written Hopper kernels (sm_90a), one C entry per TPU kernel:
//   probe_flat      <- benchmarks/megakernel_probe.py:61   `_flat_kernel`
//   probe_hm        <- benchmarks/megakernel_probe.py:85   `_hm_kernel`
//   probe_relayout  <- benchmarks/megakernel_probe2.py:48  `_kernel`
//   probe_pair_proj <- benchmarks/megakernel_probe3.py:48  `_kernel`
// Each streams a blob of int8 panels [K, N] and multiplies one input row
// with every panel: out[p] = epilogue(x_p . W_p), the products of the exact
// int8 -> float cast accumulated in fp32.  What differs is the input row
// (bf16; fp32 rounded to bf16; the fp32 sum of the rows of a pair-layout
// context), the split of K (the pair loop adds one fp32 partial per pair,
// in order of the pair) and the epilogue (the fp32 scale on the fp32 sum
// then bf16; bf16 of the sum; the relayout's total of the scores
// q[h] . kv[h, :, c] over every head h and column c, written to every
// column of the panel).
//
// Bound: bytes.  Every weight byte is read once and used for two flops, so
// the 210 MB blobs of the probes take 62.7-62.9 us at 3.35 TB/s.  The TPU
// kernels walked a grid of whole panels in order, one panel in VMEM at a
// time.  On Hopper the blocks of a grid run in parallel, so here:
//   * a panel is cut into items of `cols` output columns by a slice of K
//     (the megakernel's GEMV item is 32 columns by a quarter of K,
//     eddie_wang_hackathon2023_tpu_torch/csrc/decoder_layer.cu `gemv_tile`);
//     one block per item, or a grid-stride loop over the items when the
//     caller fixes the grid (the megakernel's grid is one block per SM);
//   * a thread reads 16 columns of a row with one 16-byte streaming load and
//     keeps 8 such loads in flight before it uses them; the int8 values
//     become floats by a byte permute into the mantissa of 2^23 and one
//     subtraction (exact; the int -> float conversion unit is 4x slower);
//   * the row groups of a warp are reduced by shuffles, the warps in shared
//     memory in order;
//   * an item that holds a slice of K writes its fp32 partial; the last
//     item of a group (one counter per group, left at zero again) adds the
//     partials in order of the slice and applies the epilogue, in the same
//     launch.  For the relayout the group is the whole panel, whose last
//     item computes the scores and their total.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;       // 16-byte loads a thread has in flight
constexpr int kMaxK = 4096;     // rows of an item's slice; columns of a panel

enum XMode { kXBf16 = 0, kXRound = 1, kXPairSum = 2 };
enum Epi { kScale = 0, kRound = 1, kTotal = 2 };

struct Job {
  const void* x;              // bf16 [x_rows, K]; fp32 [K] (kXRound);
                              // fp32 [hp, K] (kXPairSum)
  const int8_t* w;            // panel p, row k, column n at
                              // p * panel_stride + k * N + n
  const float* scale;         // [P, N] (kScale)
  const __nv_bfloat16* kv;    // [H, D, C] (kTotal)
  __nv_bfloat16* out;         // [P, N]
  float* ws;                  // [P, ksplit, N] partial sums
  int* counters;              // zeros, one per group of items
  long long panel_stride;
  int P, K, N, x_rows, x_mode, epi, ksplit, hp, H, D, C;
};

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// byte i of v as an exact float: its sign bit flipped gives b + 128, which
// the permute puts under the exponent of 2^23 (0x4B000000 | (b + 128))
__device__ __forceinline__ float int8_at(uint32_t flipped, int i) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7440 + i)) -
         8388736.f;
}

// The relayout's epilogue for panel p: the panel's sums (its K slices
// added in order) seen as q [H, D]; every score q[h] . kv[h, :, c] in fp32;
// bf16(0 * sum + the total of the scores) into every column.
__device__ void panel_total(const Job& j, int p, float* sums, float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int n = tid; n < j.N; n += kThreads) {
    float s = 0.f;
    for (int q = 0; q < j.ksplit; ++q)
      s += __ldcg(j.ws + ((size_t)p * j.ksplit + q) * j.N + n);
    sums[n] = s;
  }
  __syncthreads();
  float t = 0.f;
  for (int hc = tid; hc < j.H * j.C; hc += kThreads) {
    const int h = hc / j.C, c = hc % j.C;
    const float* q = sums + h * j.D;
    const __nv_bfloat16* kvh = j.kv + (size_t)h * j.D * j.C + c;
    float sc = 0.f;
    for (int d = 0; d < j.D; ++d)
      sc = fmaf(q[d], __bfloat162float(kvh[(size_t)d * j.C]), sc);
    t += sc;
  }
  t = warp_sum(t);
  if (lane == 0) red[warp] = t;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += red[w];
  for (int n = tid; n < j.N; n += kThreads)
    j.out[(size_t)p * j.N + n] = __float2bfloat16_rn(sums[n] * 0.f + total);
}

template <int kCols>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const Job j) {
  constexpr int kTpr = kCols / 16;         // threads across a row of an item
  constexpr int kRg = kThreads / kTpr;     // row groups of a block
  __shared__ float xs[kMaxK];              // the item's slice of x; later
                                           // the relayout's panel sums
  __shared__ float red[kWarps * kCols];
  __shared__ int last_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = tid / kTpr, c = tid % kTpr;
  const int n_ct = j.N / kCols, kc = j.K / j.ksplit;
  const int per_panel = n_ct * j.ksplit;
  const long long n_items = (long long)j.P * per_panel;
  const bool single = j.ksplit == 1 && j.epi != kTotal;

  for (long long it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int p = (int)(it / per_panel), rem = (int)(it % per_panel);
    const int ct = rem / j.ksplit, ks = rem % j.ksplit;
    const int k0 = ks * kc;

    // 1. the item's slice of the input row, as fp32, in shared memory
    for (int k = tid; k < kc; k += kThreads) {
      float v;
      if (j.x_mode == kXBf16) {
        v = __bfloat162float(static_cast<const __nv_bfloat16*>(
            j.x)[(size_t)(p % j.x_rows) * j.K + k0 + k]);
      } else if (j.x_mode == kXRound) {
        v = bf16r(static_cast<const float*>(j.x)[k0 + k]);
      } else {
        const float* cx = static_cast<const float*>(j.x);
        v = 0.f;
        for (int r = 0; r < j.hp; ++r) v += cx[(size_t)r * j.K + k0 + k];
      }
      xs[k] = v;
    }
    __syncthreads();

    // 2. the item's rows: 16 columns a thread, kBatch loads in flight
    const int8_t* wp = j.w + (size_t)p * j.panel_stride +
                       (size_t)k0 * j.N + ct * kCols + c * 16;
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    for (int r0 = rg; r0 < kc; r0 += kRg * kBatch) {
      int4 v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int r = r0 + b * kRg;
        v[b] = r < kc ? __ldcs(reinterpret_cast<const int4*>(
                            wp + (size_t)r * j.N))
                      : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int r = r0 + b * kRg;
        if (r < kc) {
          const float xv = xs[r];
          const uint32_t words[4] = {(uint32_t)v[b].x, (uint32_t)v[b].y,
                                     (uint32_t)v[b].z, (uint32_t)v[b].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t f = words[q] ^ 0x80808080u;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[4 * q + e] = fmaf(xv, int8_at(f, e), acc[4 * q + e]);
          }
        }
      }
    }

    // 3. the row groups of a warp by shuffles, the warps in order
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int o = kTpr; o < 32; o <<= 1)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
    }
    if (lane < kTpr) {
#pragma unroll
      for (int i = 0; i < 16; ++i) red[warp * kCols + lane * 16 + i] = acc[i];
    }
    __syncthreads();
    float part = 0.f;
    if (tid < kCols) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) part += red[w * kCols + tid];
    }
    const int n = ct * kCols + tid;

    // 4. the epilogue, at once or by the last item of the group
    if (single) {
      if (tid < kCols)
        j.out[(size_t)p * j.N + n] = __float2bfloat16_rn(
            j.epi == kScale ? part * j.scale[(size_t)p * j.N + n] : part);
    } else {
      if (tid < kCols)
        __stcg(j.ws + ((size_t)p * j.ksplit + ks) * j.N + n, part);
      __threadfence();
      __syncthreads();
      const bool whole = j.epi == kTotal;
      const int g = whole ? p : p * n_ct + ct;
      if (tid == 0)
        last_s = atomicAdd(j.counters + g, 1) ==
                 (whole ? per_panel : j.ksplit) - 1;
      __syncthreads();
      if (last_s) {
        __threadfence();
        if (whole) {
          panel_total(j, p, xs, red);
        } else if (tid < kCols) {
          float s = 0.f;
          for (int q = 0; q < j.ksplit; ++q)
            s += __ldcg(j.ws + ((size_t)p * j.ksplit + q) * j.N + n);
          j.out[(size_t)p * j.N + n] = __float2bfloat16_rn(
              j.epi == kScale ? s * j.scale[(size_t)p * j.N + n] : s);
        }
        if (tid == 0) j.counters[g] = 0;
      }
    }
    __syncthreads();             // xs, red and last_s serve the next item
  }
}

template <int kCols>
int launch(const Job& j, int blocks, cudaStream_t st) {
  const long long items = (long long)j.P * (j.N / kCols) * j.ksplit;
  long long grid = blocks > 0 ? blocks : items;
  if (grid > 0x7fffffffLL) grid = 0x7fffffffLL;
  probe_kernel<kCols><<<(unsigned)grid, kThreads, 0, st>>>(j);
  return (int)cudaGetLastError();
}

// Checks what every entry needs, then launches with items of `cols`
// columns (32, 64, 128 or 256) and `ksplit` slices of K; `blocks` > 0 fixes
// the grid (a grid-stride loop over the items), 0 gives a block per item.
int dispatch(const Job& j, int cols, int blocks, void* stream) {
  const bool split = !(j.ksplit == 1 && j.epi != kTotal);
  if (j.P < 1 || j.K < 1 || j.N < 1 || j.ksplit < 1 || blocks < 0 ||
      j.K % j.ksplit || j.K / j.ksplit > kMaxK || j.N > kMaxK ||
      cols < 16 || j.N % cols || j.N % 16 || j.panel_stride % 16 ||
      reinterpret_cast<uintptr_t>(j.w) % 16 || j.x_rows < 1 ||
      (j.epi == kScale && j.scale == nullptr) ||
      (j.epi == kTotal && (j.kv == nullptr || j.H * j.D != j.N)) ||
      (split && (j.ws == nullptr || j.counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (cols) {
    case 32: return launch<32>(j, blocks, st);
    case 64: return launch<64>(j, blocks, st);
    case 128: return launch<128>(j, blocks, st);
    case 256: return launch<256>(j, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

Job job(const void* x, const void* w, void* out, float* ws, int* counters,
        int P, int K, int N, int ksplit) {
  Job j{};
  j.x = x;
  j.w = static_cast<const int8_t*>(w);
  j.out = static_cast<__nv_bfloat16*>(out);
  j.ws = ws;
  j.counters = counters;
  j.panel_stride = (long long)K * N;
  j.P = P;
  j.K = K;
  j.N = N;
  j.x_rows = 1;
  j.x_mode = kXBf16;
  j.epi = kRound;
  j.ksplit = ksplit;
  j.hp = 1;
  return j;
}

}  // namespace

extern "C" {

// Each returns 0 when its launch was enqueued, else the CUDA error.

// out [P, 1, N] bf16 = bf16((x . bf16(W_p)) fp32 * scale[p]); x [1, K] bf16,
// W [P, K, N] int8, scale [P, 1, N] fp32
int probe_flat(const void* x, const void* w, const float* scale, void* out,
               int P, int K, int N, int cols, int ksplit, int blocks,
               float* ws, int* counters, void* stream) {
  Job j = job(x, w, out, ws, counters, P, K, N, ksplit);
  j.epi = kScale;
  j.scale = scale;
  return dispatch(j, cols, blocks, stream);
}

// head-major panels: out [np, rows, D] = bf16((xb[r] . W[i, r]) * s[i, r]);
// xb [rows, 1, K] bf16, W [np, rows, K, D] int8, s [np, rows, D] fp32
int probe_hm(const void* xb, const void* w, const float* scale, void* out,
             int np, int rows, int K, int D, int cols, int ksplit, float* ws,
             int* counters, void* stream) {
  Job j = job(xb, w, out, ws, counters, np * rows, K, D, ksplit);
  j.x_rows = rows;
  j.epi = kScale;
  j.scale = scale;
  return dispatch(j, cols, 0, stream);
}

// reshape 0: out [P, 1, N] = bf16(x . W_p); reshape 1: the sums seen as q
// [H, D] against kv [1, H, D, C] bf16, bf16(0 * sum + total of the scores)
int probe_relayout(const void* x, const void* w, const void* kv, void* out,
                   int P, int K, int N, int H, int D, int C, int reshape,
                   int cols, int ksplit, float* ws, int* counters,
                   void* stream) {
  Job j = job(x, w, out, ws, counters, P, K, N, ksplit);
  if (reshape) {
    j.epi = kTotal;
    j.kv = static_cast<const __nv_bfloat16*>(kv);
    j.H = H;
    j.D = D;
    j.C = C;
  }
  return dispatch(j, cols, 0, stream);
}

// ctx [hp, dl] fp32, W [P, hp*dl, hp*dl] int8, out [P, 1, hp*dl] bf16 of
// the fp32 sums.  mode 0 (pair_loop): bf16(ctx[p]) . W[dl p : dl (p + 1)],
// one partial per pair, added in order of p (ksplit is hp); 1, 2 (flat_f32,
// flat_bf16): bf16(ctx flattened) . W; 3 (gemv): (sum over p of ctx[p]) .
// W[:dl], in fp32
int probe_pair_proj(const float* ctx, const void* w, void* out, int P,
                    int hp, int dl, int mode, int cols, int ksplit,
                    float* ws, int* counters, void* stream) {
  const int d = hp * dl;
  if (mode < 0 || mode > 3 || (mode == 0 && ksplit != hp))
    return (int)cudaErrorInvalidValue;
  Job j = job(ctx, w, out, ws, counters, P, mode == 3 ? dl : d, d, ksplit);
  j.panel_stride = (long long)d * d;
  j.x_mode = mode == 3 ? kXPairSum : kXRound;
  j.hp = hp;
  return dispatch(j, cols, 0, stream);
}

}  // extern "C"
