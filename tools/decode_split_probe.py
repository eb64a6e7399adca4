#!/usr/bin/env python3
"""Where kernel 1's time goes (decode attention split over a cluster), on
one NVIDIA GPU.

    python3 tools/decode_split_probe.py      # from the root of a checkout

1. Times the kernel (``csrc/decode_attention.cu``, its C entry called with
   an explicit number of slices) with CUDA events behind a spin, as
   ``chip_smoke.py`` does, beside an empty ``fill_`` kernel: at the cross
   shape (int8, 20 heads of 64, S 1500, 32 layers rotating) at batch 1 and
   5 over 1 to 8 slices, with nothing to read (length 0: the fixed cost),
   and at the self shape (bf16, S 448, 43 cached columns and the fresh
   one) over 1 and 2 slices.
2. Builds a copy of the source with a ``%globaltimer`` stamp (ns) after
   every block barrier and mbarrier wait of the cluster of (head 0, row 0),
   in every block, and prints each block's phases: the prologue (lengths,
   q, the loads started), the loads' wait, the scores, the max and its
   exchange, p, P*V, the partials sent, their landing in rank 0 and rank
   0's combine.
"""
import ctypes
import importlib.util
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
N_STAMPS = 16
# each phase named by the stamp that ends it (stamps 9 and 10 end the
# further rounds of V, when a slice has more than 256 columns)
PHASES = {1: "prologue", 2: "loads", 3: "partial scores", 4: "scores",
          5: "block max", 6: "cluster arrival", 7: "max exchange", 8: "p",
          9: "V round", 10: "V round", 12: "P*V", 14: "partials sent",
          11: "partials landed", 15: "combine"}


def stamped_library():
    """The split kernel's source with the stamps, built into build/probe/;
    stamp n of rank r lands in g_st[r][n]."""
    src = open(os.path.join(HERE, "eddie_wang_hackathon2023_tpu_torch",
                            "csrc", "decode_attention.cu")).read()
    a = src.index("split_decode_attention_kernel(const")
    b = src.index("// out[b, n] = bf16((sum_k x[b, k]")
    mark = ("if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) "
            "g_st[blockIdx.z][{n}] = gtime();")
    kern = src[a:b]
    for k, anchor in ((12, "  // the partial context and sum to rank 0's"),
                      (14, "  if (rank != 0 || tid >= D) return;")):
        assert kern.count(anchor) == 1
        kern = kern.replace(anchor, "  " + mark.format(n=k) + "\n" + anchor)
    n = iter(range(1, 12))
    kern = re.sub(r"(__syncthreads\(\);|cluster_wait\(\);"
                  r"|mbar_wait\(&bars\[\d\], 0\);)",
                  lambda m: f"{m.group(0)} " + mark.format(n=next(n)), kern)
    kern = kern.replace("{\n", "{\n  " + mark.format(n=0) + "\n", 1)
    last = "  out[f0 + tid] = __float2bfloat16(__fmul_rn(acc, inv));\n"
    assert kern.count(last) == 1
    kern = kern.replace(last, last + "  " + mark.format(n=N_STAMPS - 1)
                        + "\n")
    helpers = ("__device__ long long g_st[8][%d];\n"
               "__device__ __forceinline__ long long gtime() {\n"
               "  long long t;\n"
               "  asm volatile(\"mov.u64 %%0, %%globaltimer;\" : \"=l\"(t));\n"
               "  return t;\n}\n" % N_STAMPS)
    head = src[:a]
    i = head.index("namespace {")
    src = (head[:i] + helpers + head[i:] + kern + src[b:]
           + '\nextern "C" int read_stamps(long long* h) {\n'
           '  return (int)cudaMemcpyFromSymbol(h, g_st, sizeof(g_st));\n}\n'
           'extern "C" int clear_stamps() {\n'
           '  static long long z[8][%d];\n'
           '  return (int)cudaMemcpyToSymbol(g_st, z, sizeof(z));\n}\n'
           % N_STAMPS)
    out = os.path.join(HERE, "build", "probe")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "decode_stamps.cu"), "w") as f:
        f.write(src)
    lib_path = os.path.join(out, "libdecode_stamps.so")
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib_path,
                    os.path.join(out, "decode_stamps.cu")], check=True)
    lib = ctypes.CDLL(lib_path)
    from eddie_wang_hackathon2023_tpu_torch.ops import _build
    lib.decode_attention.argtypes = \
        _build.SIGNATURES["decode_attention"]["decode_attention"]
    lib.read_stamps.argtypes = [ctypes.c_void_p]
    return lib


def call(lib, torch, cache, layer, q, seq, kscale, fresh, splits, out):
    """Kernel 1's C entry with ``splits`` slices (the wrapper's checks are
    the callers'); raises if the launch is refused."""
    B, H, _, D = q.shape
    S = cache.shape[-1]
    fk, fv = fresh if fresh is not None else (None, None)

    def p(t):
        return None if t is None else t.data_ptr()
    err = lib.decode_attention(
        p(q), p(cache), int(cache.dtype == torch.int8), layer, B, H, D, S,
        splits, p(seq), None, p(kscale), D ** -0.5, p(fk), p(fv), p(out),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: {err}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("decode_split_probe: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from eddie_wang_hackathon2023_tpu_torch.ops import _build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    H, D, L = 20, 64, 32
    z = torch.zeros(1, device=dev)
    ms, _ = smoke.time_ms(torch, lambda i: z.fill_(1.0))
    print(f"fill_ kernel: {ms * 1e3:.2f} us")
    lib = _build.load("decode_attention")

    def operands(B, S, int8, layers):
        if int8:
            cache = torch.randint(-127, 128, (layers, B, 2, H, D, S),
                                  generator=g, device=dev, dtype=torch.int8)
            fresh = tuple(torch.randint(-127, 128, (B, H, D, 1), generator=g,
                                        device=dev, dtype=torch.int8)
                          for _ in range(2))
        else:
            cache = torch.randn(layers, B, 2, H, D, S, generator=g,
                                device=dev).bfloat16()
            fresh = tuple(torch.randn(B, H, D, 1, generator=g,
                                      device=dev).bfloat16()
                          for _ in range(2))
        q = torch.randn(B, H, 1, D, generator=g, device=dev).bfloat16()
        out = torch.empty(B, H * D, dtype=torch.bfloat16, device=dev)
        return cache, q, fresh, out

    ks = torch.tensor([1 / 40.0], device=dev)
    cases = [(f"cross int8 S 1500, batch {B}, length {n}", B, 1500, True, n,
              False, sp)
             for B in (1, 5) for n in (1500, 0)
             for sp in ((1, 2, 3, 4, 6, 8) if n else (1, 6))]
    cases += [("self bf16 S 448, 43 cached + fresh", 1, 448, False, 44,
               True, sp) for sp in (1, 2)]
    for what, B, S, int8, n, with_fresh, sp in cases:
        cache, q, fresh, out = operands(B, S, int8, L)
        seq = torch.full((B,), n, dtype=torch.int32, device=dev)
        kscale = ks if int8 else None
        fr = fresh if with_fresh else None
        ms, _ = smoke.time_ms(torch, lambda i: call(
            lib, torch, cache, i % L, q, seq, kscale, fr, sp, out))
        print(f"{what}, {sp} slice(s): {ms * 1e3:.2f} us")
        del cache

    stamped = stamped_library()
    for what, B, S, int8, n, with_fresh, sp in (
            ("cross int8 S 1500, batch 1", 1, 1500, True, 1500, False, 6),
            ("cross int8 S 1500, batch 5", 5, 1500, True, 1500, False, 6),
            ("self bf16 S 448, 43 cached + fresh", 1, 448, False, 44, True,
             2)):
        cache, q, fresh, out = operands(B, S, int8, 1)
        seq = torch.full((B,), n, dtype=torch.int32, device=dev)
        for _ in range(5):
            stamped.clear_stamps()
            call(stamped, torch, cache, 0, q, seq, ks if int8 else None,
                 fresh if with_fresh else None, sp, out)
        torch.cuda.synchronize()
        st = (ctypes.c_longlong * (8 * N_STAMPS))()
        stamped.read_stamps(st)
        rows = [[st[r * N_STAMPS + k] for k in range(N_STAMPS)]
                for r in range(sp)]
        t0 = min(v for row in rows for v in row if v)
        print(f"{what}: ns since the cluster's first stamp, per rank")
        for r, row in enumerate(rows):
            t = sorted(((k, v - t0) for k, v in enumerate(row) if v),
                       key=lambda kv: kv[1])
            print(f"  rank {r}: start {t[0][1]}, phases "
                  + ", ".join(f"{PHASES[k]} {b - a}"
                              for (_, a), (k, b) in zip(t, t[1:]))
                  + f"; end {t[-1][1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
