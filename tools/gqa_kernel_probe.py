#!/usr/bin/env python3
"""Where the grouped decode kernel's time goes, on one NVIDIA GPU.

    python3 tools/gqa_kernel_probe.py        # from the root of a checkout

1. Times the kernel (``csrc/gqa_decode_attention.cu`` through
   ``fused_decode_attention``) with CUDA events behind a spin, as
   ``chip_smoke.py`` does, over cached lengths from 1 to 84 at the decoder
   path's shapes (batch 8 or 1, 16 query heads over one KV head, head dim
   128, S 84, start 4) and with 4 query heads per KV head, beside an empty
   ``fill_`` kernel: the fixed cost and the cost per column; then over
   longer caches that the kernel splits over a cluster.
2. Builds a copy of the source with a ``clock64()`` stamp after every
   block barrier, mbarrier wait and cluster wait of block (0, 0, 0) and
   before its returns, and prints the cycles of each phase, named by the
   comment of the barrier that ends it (the round of loads, the scores and
   the warps' maxima, P and the sums, P*V and the store; with a cluster,
   the maxima's exchange, the partials' landing, rank 0's terms of each
   query head and its store of the summed contexts).
"""
import ctypes
import importlib.util
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def stamped_library():
    """The kernel's source with the stamps, built into build/probe/, and the
    names of its phases (the comment on each stamped line, in order)."""
    src = open(os.path.join(HERE, "eddie_wang_hackathon2023_tpu_torch",
                            "csrc", "gqa_decode_attention.cu")).read()
    a = src.index("gqa_decode_attention_kernel(")
    b = src.index("template <typename CT>\nint launch(")
    mark = ("if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 "
            "&& blockIdx.z == 0) ")
    n = iter(range(1, 31))
    names = ["start"]

    def stamp(m):
        names.append((m.group(2) or m.group(1)).strip(" /"))
        return f"{m.group(1)} {mark}g_st[{next(n)}] = clock64();"

    kern = re.sub(r"(__syncthreads\(\);|mbar_wait\(&bars\[\d\], 0\);|"
                  r"cluster_wait\(\);)( *//[^\n]*)?", stamp, src[a:b])
    kern = kern.replace("{\n", "{\n  " + mark + "g_st[0] = clock64();\n", 1)
    kern = kern.replace("return;", "{ " + mark + "g_st[31] = clock64(); "
                        "return; }")
    end = kern.rindex("}")
    kern = kern[:end] + "  " + mark + "g_st[31] = clock64();\n" + kern[end:]
    names += [""] * (31 - len(names)) + ["the store"]
    src = ("__device__ long long g_st[32];\n" + src[:a] + kern + src[b:]
           + '\nextern "C" int read_stamps(long long* h) {\n'
           '  return (int)cudaMemcpyFromSymbol(h, g_st, sizeof(g_st));\n}\n'
           '\nextern "C" int clear_stamps() {\n'
           '  long long z[32] = {0};\n'
           '  return (int)cudaMemcpyToSymbol(g_st, z, sizeof(z));\n}\n')
    out = os.path.join(HERE, "build", "probe")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "gqa_stamps.cu"), "w") as f:
        f.write(src)
    lib_path = os.path.join(out, "libgqa_stamps.so")
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib_path,
                    os.path.join(out, "gqa_stamps.cu")], check=True)
    from eddie_wang_hackathon2023_tpu_torch.ops import _build
    lib = ctypes.CDLL(lib_path)
    lib.gqa_decode_attention.argtypes = _build.SIGNATURES[
        "gqa_decode_attention"]["gqa_decode_attention"]
    lib.read_stamps.argtypes = [ctypes.c_void_p]
    return lib, names


def main():
    import torch
    if not torch.cuda.is_available():
        print("gqa_kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    L, D = 24, 128
    z = torch.zeros(1, device=dev)
    ms, _ = smoke.time_ms(torch, lambda i: z.fill_(1.0))
    print(f"fill_ kernel: {ms * 1e3:.2f} us")

    def operands(B, hkv, rep, n, layers, S=84):
        cache = torch.randn(layers, B, 2, hkv, D, S, generator=g,
                            device=dev).bfloat16()
        q = torch.randn(B, hkv * rep, 1, D, generator=g,
                        device=dev).bfloat16()
        fresh = tuple(torch.randn(B, hkv, D, 1, generator=g,
                                  device=dev).bfloat16() for _ in range(2))
        seq = torch.full((B,), n, dtype=torch.int32, device=dev)
        start = torch.full((B,), 4, dtype=torch.int32, device=dev)
        return cache, q, fresh, seq, start

    for B, hkv, rep in ((8, 1, 16), (1, 1, 16), (8, 1, 4), (8, 4, 4)):
        for n in (1, 6, 20, 35, 70, 84):
            cache, q, fresh, seq, start = operands(B, hkv, rep, n, L)
            ms, _ = smoke.time_ms(torch, lambda i: da.fused_decode_attention(
                cache, i % L, q, seq, D ** -0.5, fresh_kv=fresh,
                start_index=start))
            print(f"batch {B}, {hkv} KV head(s) x {rep}, seq {n}: "
                  f"{ms * 1e3:.2f} us")
    for S in (256, 1024, 2048, 8192):
        cache, q, fresh, seq, start = operands(8, 1, 16, S, 4, S)
        ms, _ = smoke.time_ms(torch, lambda i: da.fused_decode_attention(
            cache, i % 4, q, seq, D ** -0.5, fresh_kv=fresh,
            start_index=start))
        print(f"batch 8, 1 KV head x 16, S = seq {S} ({da.gqa_splits(S)} "
              f"blocks a cluster): {ms * 1e3:.2f} us")

    lib, names = stamped_library()
    stream = torch.cuda.current_stream().cuda_stream
    for B, hkv, rep, n, S in ((8, 1, 16, 70, 84), (8, 1, 16, 6, 84),
                              (8, 1, 4, 70, 84), (8, 1, 16, 1024, 1024)):
        cache, q, fresh, seq, start = operands(B, hkv, rep, n, 1, S)
        out = torch.empty(B, hkv * rep * D, dtype=torch.bfloat16, device=dev)
        assert lib.clear_stamps() == 0
        for _ in range(5):
            assert lib.gqa_decode_attention(
                q.data_ptr(), cache.data_ptr(), 0, 0, B, hkv, rep, D, S,
                da.gqa_splits(S), da.gqa_slice_width(S, da.gqa_splits(S)),
                seq.data_ptr(), start.data_ptr(), None,
                D ** -0.5, fresh[0].data_ptr(), fresh[1].data_ptr(),
                out.data_ptr(), stream) == 0
        torch.cuda.synchronize()
        stamps = (ctypes.c_longlong * 32)()
        lib.read_stamps(stamps)
        t = [(i, v) for i, v in enumerate(stamps) if v]
        print(f"batch {B}, {hkv} KV head(s) x {rep}, S {S}, seq {n}: cycles "
              "per phase " + ", ".join(
                  f"{names[i]}: {v - u}" for (_, u), (i, v) in zip(t, t[1:]))
              + f" (total {t[-1][1] - t[0][1]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
