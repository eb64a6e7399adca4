#!/usr/bin/env python3
"""Where the int4 dequant matmul's time goes, on one NVIDIA GPU.

    python3 tools/int4_kernel_probe.py       # from the root of a checkout

Times the kernel (``csrc/int4_quant_matmul.cu``, called through its C entry
with the wrapper's operands) with CUDA events behind a spin, as
``chip_smoke.py`` does, beside an empty ``fill_`` kernel (the launch floor):
1. at the SantaCoder-1B linears (groups of 128) at decode (M 8), with K
   split over 1, 2, 4, ... blocks (the wrapper's choice marked): the cost
   of the split's reduction against the parallelism it buys;
2. one output tile (N 128) at M 8 over K 1024 to 8192 without a split: the
   time a block takes per chunk of 64 rows of K;
3. the prefill (M 512) at each linear with the splits the wrapper takes and
   without;
4. a copy of the source with ``clock64()`` stamps taken by thread 0 of
   block 0 in each chunk's iteration (after its wait for the chunk's
   copies, after the barrier, after the unpacking, after the second
   barrier, after the products), run on one tile at M 8, K 2048: the cycles
   of each phase.
"""
import ctypes
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# a stamp: thread 0 of block 0 stores the clock (a store does not wait)
STAMP = ("if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 && "
         "blockIdx.z == 0 && stamp_i < 256) g_st[stamp_i++] = clock64();")
# (line of the kernel, phase that ends there) where a stamp follows
STAMPED = (("const bool vec = (p.N % 16 == 0) && (n0 + kTileN <= p.N);",
            "start"),
           ("cp_async_wait<Ly::kStages - 2>();", "wait"),
           ("__syncthreads();                    // everyone's", "barrier"),
           ("dequant_chunk<MT, kGrouped>(st, panel);", "unpack"),
           ("    cp_async_commit();\n    __syncthreads();",
            "issue+barrier"))
PHASES = ("wait", "barrier", "unpack", "issue+barrier", "products")


def stamped_library():
    """The kernel's source with the stamps, built into build/probe/."""
    src = open(os.path.join(HERE, "eddie_wang_hackathon2023_tpu_torch",
                            "csrc", "int4_quant_matmul.cu")).read()
    for j, (line, _) in enumerate(STAMPED):
        i = src.index("\n", src.index(line) + len(line) - 1)
        src = (src[:i] + "\n" + ("int stamp_i = 0;\n" if j == 0 else "")
               + STAMP + src[i:])
    # the products end where the chunk loop does
    end = "    }\n  }\n  cp_async_wait<0>();"
    src = src.replace(end, "    }\n    " + STAMP + "\n  }\n  "
                      "cp_async_wait<0>();")
    src = ("__device__ long long g_st[256];\n" + src
           + '\nextern "C" int read_stamps(long long* h) {\n'
           '  return (int)cudaMemcpyFromSymbol(h, g_st, sizeof(g_st));\n}\n')
    out = os.path.join(HERE, "build", "probe")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "int4_stamps.cu"), "w") as f:
        f.write(src)
    lib_path = os.path.join(out, "libint4_stamps.so")
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib_path,
                    os.path.join(out, "int4_stamps.cu")], check=True)
    lib = ctypes.CDLL(lib_path)
    from eddie_wang_hackathon2023_tpu_torch.ops import _build
    lib.int4_quant_matmul.argtypes = \
        _build.SIGNATURES["int4_quant_matmul"]["int4_quant_matmul"]
    lib.read_stamps.argtypes = [ctypes.c_void_p]
    return lib


def main():
    import torch
    if not torch.cuda.is_available():
        print("int4_kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from eddie_wang_hackathon2023_tpu_torch.ops import _build
    from eddie_wang_hackathon2023_tpu_torch.ops import int4_quant_matmul as iq

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    lib = _build.load("int4_quant_matmul")
    counters = torch.zeros(1 << 16, dtype=torch.int32, device=dev)
    ptr = iq._ptr

    def operands(m, k, n, copies):
        qw = torch.randint(-128, 128, (copies, k // 2, n), generator=gen,
                           device=dev, dtype=torch.int8)
        sc = torch.rand((copies, k // 128, n), generator=gen, device=dev)
        x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
        return x, qw, sc

    def timed(m, k, n, splits):
        """µs of one call with ``splits`` ranges of K (None: the
        wrapper's plan), rotating over weights past the 50 MB L2"""
        copies = -(-120_000_000 // (k // 2 * n))
        x, qw, sc = operands(m, k, n, copies)
        mt, plan, per = iq.split_plan(m, n, k, sms)
        chunks = k // iq.CHUNK_K
        if splits is not None:
            per = -(-chunks // splits)
        s = -(-chunks // per)
        out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
        ws = torch.empty((s, m, n), dtype=torch.float32, device=dev)

        def call(i):
            _build.check(lib.int4_quant_matmul(
                ptr(x), ptr(qw[i % copies]), ptr(sc[i % copies]), m, n, k,
                k // 128, mt, s, per, ptr(ws), ptr(counters), ptr(out),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)),
                "int4_quant_matmul")

        ms, _ = smoke.time_ms(torch, call)
        ref = iq.plain_quant_matmul_int4(x, qw[0], sc[0])
        call(0)
        smoke.check(smoke.rel_err(out, ref) < 2e-2,
                    f"M {m} K {k} N {n} splits {s}: matches plain")
        return ms * 1e3, s, plan

    z = torch.zeros(1, device=dev)
    floor, _ = smoke.time_ms(torch, lambda i: z.fill_(1.0))
    print(f"empty fill_ kernel: {floor * 1e3:.2f} us")
    print("1. decode (M 8): us by splits of K (* the wrapper's)")
    for name, k, n in smoke.INT4_SHAPES:
        chunks = k // iq.CHUNK_K
        row = []
        for splits in (1, 2, 4, 8, 16, 32, 64):
            if splits > chunks:
                break
            us, s, plan = timed(8, k, n, splits)
            row.append(f"{s}{'*' if s == plan else ''}: {us:.2f}")
        print(f"  {name} K {k} N {n}: " + ", ".join(row))
    print("2. one tile (M 8, N 128), no split: us by K")
    for k in (1024, 2048, 4096, 8192):
        us, _, _ = timed(8, k, 128, 1)
        print(f"  K {k} ({k // iq.CHUNK_K} chunks): {us:.2f}")
    print("3. prefill (M 512): us, the wrapper's splits and none")
    for name, k, n in smoke.INT4_SHAPES:
        us, s, _ = timed(512, k, n, None)
        us1, _, _ = timed(512, k, n, 1)
        print(f"  {name}: {us:.2f} (splits {s}), {us1:.2f} (no split)")

    print("4. cycles by phase, one tile (M 8, N 128, K 2048: 32 chunks)")
    lib4 = stamped_library()
    m, k, n = 8, 2048, 128
    x, qw, sc = operands(m, k, n, 1)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    for rep in range(2):                       # the second run is read
        _build.check(lib4.int4_quant_matmul(
            ptr(x), ptr(qw[0]), ptr(sc[0]), m, n, k, k // 128, 1, 1,
            k // iq.CHUNK_K, None, None, ptr(out),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)),
            "stamped int4_quant_matmul")
        torch.cuda.synchronize()
    st = (ctypes.c_longlong * 256)()
    lib4.read_stamps(st)
    stamps = list(st)[:1 + len(PHASES) * (k // iq.CHUNK_K)]
    print(f"  start to the first chunk's copies: {stamps[1] - stamps[0]} "
          "cycles")
    per = {ph: [] for ph in PHASES}
    for j in range((len(stamps) - 1) // 5):
        base = 1 + 5 * j
        prev = stamps[0] if j == 0 else stamps[base - 1]
        for i, ph in enumerate(PHASES):
            per[ph].append(stamps[base + i] - (prev if i == 0
                                               else stamps[base + i - 1]))
    for ph, v in per.items():
        tail = v[3:] or v
        print(f"  {ph}: {sum(tail) / len(tail):.0f} cycles a chunk "
              f"(chunks 3-: mean; first three {v[:3]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
