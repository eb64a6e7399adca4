#!/usr/bin/env python3
"""Where the int4 dequant matmul's time goes, on one NVIDIA GPU.

    python3 tools/int4_kernel_probe.py       # from the root of a checkout

Times the kernel (``csrc/int4_quant_matmul.cu``, called through its C
entries with the wrapper's operands) with CUDA events behind a spin, as
``chip_smoke.py`` does, beside an empty ``fill_`` kernel (the launch floor)
and ``torch._weight_int4pack_mm`` where the card's torch has it:
1. the decode entry at the SantaCoder-1B linears (groups of 128) at M 8,
   with K split over a cluster of 1, 2, 4 and 8 blocks of 8 warps (the
   wrapper's ``decode_plan`` marked): the cost of the cluster's sum against
   the parallelism it buys;
2. the decode entry on one column tile (N 128, no cluster) at M 8 over K
   1024 to 8192: the time a block takes per 64 rows of K;
3. the prefill entry (M 512) at each linear under every rows of x a block
   it takes (``PREFILL_ROWS``, the ring as deep as fits; the wrapper's
   ``prefill_plan`` marked);
4. a copy of the source with ``clock64()`` stamps taken by thread 0 of
   rank 0 of the first cluster of the decode entry: at its start, after
   the first steps' loads and the first scales are issued, after each
   step's products, after
   the block's warps are summed, after the other ranks' sums have landed
   and after the output is written, run at qkv's plan: the cycles of each
   phase;
5. a copy with ``clock64()`` stamps in block (0, 0) of the prefill entry,
   run at each linear with the wrapper's plan: the producer warp's wait
   for each stage to be freed, the first consumer warp's wait for each
   chunk to land and its time on each chunk (unpacking and products,
   drained), and the epilogue; summed over the chunks, with a copy's
   latency (the stage issued to the consumer's wait ending) where the
   consumer waited.
"""
import ctypes
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# a stamp: thread 0 of rank 0 of the first cluster stores the clock (a
# store does not wait)
STAMP = ("if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 && "
         "stamp_i < 256) g_st[stamp_i++] = clock64();")
# (text of the decode kernel, phase that ends there) where a stamp follows
STAMPED = (("  const int r_warp = (rank * warps + warp) * p.steps * kStep;\n",
            "start"),
           ("  if (kGrouped) scales(0);\n", "issue"),
           ("          compute(d);\n", "step"),
           ("    mine[i] = v;\n  }\n", "warp sums"),
           ('          : "=r"(done) : "r"(smem_u32(&bar)) : "memory");\n'
            "    }\n  }\n", "cluster sums landed"),
           ("        p.out[static_cast<size_t>(mm) * p.N + nn] = "
            "__float2bfloat16_rn(s);\n      }\n    }\n  }\n", "out"))


def stamped_source(src: str) -> str:
    """The kernel's source with a stamp after each of STAMPED's anchors
    (the step's inside the loop), ``g_st`` and the C entry
    ``read_stamps``."""
    for j, (anchor, _) in enumerate(STAMPED):
        i = src.index(anchor) + len(anchor)
        src = (src[:i] + ("int stamp_i = 0;\n" if j == 0 else "") + STAMP
               + "\n" + src[i:])
    return ("__device__ long long g_st[256];\n" + src
            + '\nextern "C" int read_stamps(long long* h) {\n'
            '  return (int)cudaMemcpyFromSymbol(h, g_st, sizeof(g_st));\n}\n')


def phases(stamps, steps: int):
    """{phase: cycles} from the stamps of one run (start, issue, a step
    each, warp sums, cluster sums landed, out): the steps' cycles as a
    list."""
    want = 4 + steps + 1
    if len(stamps) != want:
        raise ValueError(f"{len(stamps)} stamps, expected {want}")
    d = [b - a for a, b in zip(stamps, stamps[1:])]
    return {"issue": d[0], "steps": d[1:1 + steps],
            "warp sums": d[1 + steps], "cluster sums landed": d[2 + steps],
            "out": d[3 + steps]}


# the prefill entry's stamps, in block (0, 0): the producer's lane 0 and
# the first consumer thread, up to PREFILL_CHUNKS chunks
PREFILL_CHUNKS = 64
PREFILL_STAMPS = (
    # (text of the kernel, text put in its place)
    ("      if (c >= S) mbar_wait(&empty[st], ((c / S) - 1) & 1);\n",
     "      {\n        const long long t0_ = clock64();\n"
     "        if (c >= S) mbar_wait(&empty[st], ((c / S) - 1) & 1);\n"
     "        if (STAMP0 && lane == 0 && c < 64) {\n"
     "          g_pw[c] = clock64() - t0_;\n          g_pi[c] = clock64();\n"
     "        }\n      }\n"),
    ("    mbar_wait(&full[ch % S], (ch / S) & 1);\n",
     "    if (STAMP0 && tid == 0 && ch < 64) g_c0[ch] = clock64();\n"
     "    mbar_wait(&full[ch % S], (ch / S) & 1);\n"
     "    if (STAMP0 && tid == 0 && ch < 64) g_c1[ch] = clock64();\n"),
    ("    wgmma_wait<0>();\n#pragma unroll\n    for (int j = 0; j < kSteps;",
     "    wgmma_wait<0>();\n"
     "    if (STAMP0 && tid == 0 && ch < 64) g_c2[ch] = clock64();\n"
     "#pragma unroll\n    for (int j = 0; j < kSteps;"),
    ("  __syncthreads();\n\n  // the chunk's scale rows",
     "  __syncthreads();\n  if (STAMP0 && tid == 0) g_e[0] = clock64();\n\n"
     "  // the chunk's scale rows"),
    ("  wgmma_wait<0>();\n  fence_regs(acc);\n",
     "  wgmma_wait<0>();\n  fence_regs(acc);\n"
     "  if (STAMP0 && tid == 0) g_e[1] = clock64();\n"),
    ("}\n\ntypedef CUresult (*EncodeTiled)",
     "  if (STAMP0 && tid == 0) g_e[2] = clock64();\n}\n\n"
     "typedef CUresult (*EncodeTiled)"))


def prefill_stamped_source(src: str) -> str:
    """The kernel's source with the prefill entry's stamps (PREFILL_STAMPS),
    their arrays and the C entry ``read_prefill_stamps``."""
    for old, new in PREFILL_STAMPS:
        if src.count(old) != 1:
            raise ValueError(f"no single anchor {old!r}")
        src = src.replace(old, new)
    decl = ("#define STAMP0 (blockIdx.x == 0 && blockIdx.y == 0)\n"
            + "".join(f"__device__ long long g_{a}[{PREFILL_CHUNKS}];\n"
                      for a in ("pw", "pi", "c0", "c1", "c2"))
            + "__device__ long long g_e[4];\n")
    read = ('\nextern "C" int read_prefill_stamps(long long* h) {\n'
            + "".join(f"  cudaMemcpyFromSymbol(h + {i * PREFILL_CHUNKS}, "
                      f"g_{a}, sizeof(g_{a}));\n"
                      for i, a in enumerate(("pw", "pi", "c0", "c1", "c2")))
            + f"  return (int)cudaMemcpyFromSymbol(h + {5 * PREFILL_CHUNKS},"
            " g_e, sizeof(g_e));\n}\n")
    i = src.index("namespace {")
    return src[:i] + decl + src[i:] + read


def prefill_phases(st, chunks: int):
    """{phase: cycles} of block (0, 0) from the stamps ``st`` (the five
    per-chunk arrays, then start, loop end, end): the producer's waits for
    free stages, the first consumer's waits for chunks and its time on
    them, summed; the mean copy latency where the consumer waited (issue
    to the wait's end); the loop and the epilogue."""
    c = min(chunks, PREFILL_CHUNKS)
    pw, pi, c0, c1, c2 = (st[i * PREFILL_CHUNKS:i * PREFILL_CHUNKS + c]
                          for i in range(5))
    e = st[5 * PREFILL_CHUNKS:5 * PREFILL_CHUNKS + 3]
    waited = [ch for ch in range(c) if c1[ch] - c0[ch] > 64]
    return {"producer waits for free stages": sum(pw),
            "consumer waits for chunks": sum(b - a for a, b in zip(c0, c1)),
            "consumer on chunks": sum(b - a for a, b in zip(c1, c2)),
            "chunks waited for": len(waited),
            "copy latency where waited (mean)":
                (sum(c1[ch] - pi[ch] for ch in waited) // len(waited)
                 if waited else 0),
            "start to loop end": e[1] - e[0],
            "epilogue": e[2] - e[1]}


def stamped_library(src=None, name="int4_stamps"):
    """A copy of the kernel's source with stamps (by default the decode
    entry's, ``stamped_source``), built into build/probe/."""
    if src is None:
        src = stamped_source(open(os.path.join(
            HERE, "eddie_wang_hackathon2023_tpu_torch", "csrc",
            "int4_quant_matmul.cu")).read())
    out = os.path.join(HERE, "build", "probe")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{name}.cu"), "w") as f:
        f.write(src)
    lib_path = os.path.join(out, f"lib{name}.so")
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib_path,
                    os.path.join(out, f"{name}.cu")], check=True)
    lib = ctypes.CDLL(lib_path)
    from eddie_wang_hackathon2023_tpu_torch.ops import _build
    for fn, argtypes in _build.SIGNATURES["int4_quant_matmul"].items():
        getattr(lib, fn).argtypes = argtypes
    if src.count("read_stamps("):
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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    lib = _build.load("int4_quant_matmul")
    ptr = iq._ptr

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def operands(m, k, n, copies):
        qw = torch.randint(-128, 128, (copies, k // 2, n), generator=gen,
                           device=dev, dtype=torch.int8)
        sc = torch.rand((copies, k // 128, n), generator=gen, device=dev)
        x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
        return x, qw, sc

    def timed(m, k, n, plan, lib_=lib):
        """µs of one call with ``plan`` (decode: cluster, warps, steps;
        prefill: rows, stages), rotating over weights past the 50 MB L2"""
        copies = -(-120_000_000 // (k // 2 * n))
        x, qw, sc = operands(m, k, n, copies)
        out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)

        def call(i):
            if "warps" in plan:
                err = lib_.int4_quant_matmul_decode(
                    ptr(x), ptr(qw[i % copies]), ptr(sc[i % copies]), m, n,
                    k, k // 128, plan["cluster"], plan["warps"],
                    plan["steps"], ptr(out), stream())
            else:
                err = lib_.int4_quant_matmul(
                    ptr(x), ptr(qw[i % copies]), ptr(sc[i % copies]), m, n,
                    k, k // 128, plan["rows"], plan["stages"], ptr(out),
                    stream())
            _build.check(err, "int4_quant_matmul")

        ms, _ = smoke.time_ms(torch, call)
        ref = iq.plain_quant_matmul_int4(x, qw[0], sc[0])
        call(0)
        smoke.check(smoke.rel_err(out, ref) < 2e-2,
                    f"M {m} K {k} N {n} {plan}: matches plain")
        return ms * 1e3

    z = torch.zeros(1, device=dev)
    floor, _ = smoke.time_ms(torch, lambda i: z.fill_(1.0))
    print(f"empty fill_ kernel: {floor * 1e3:.2f} us")
    print("1. decode entry (M 8): us by cluster size (* the wrapper's "
          "plan); _weight_int4pack_mm")
    for name, k, n in smoke.INT4_SHAPES:
        want = iq.decode_plan(8, n, k, sms)
        row = []
        for cluster in (1, 2, 4, 8):
            steps = k // 2 // iq.DECODE_STEP // (8 * cluster)
            plan = dict(cluster=cluster, warps=8, steps=steps)
            us = timed(8, k, n, plan)
            row.append(f"{cluster}{'*' if plan == want else ''}: {us:.2f}")
        copies = -(-120_000_000 // (k // 2 * n))
        x, qw, sc = operands(8, k, n, copies)
        packs = smoke.int4pack_operands(torch, qw, sc)
        lib_note = packs if isinstance(packs, str) else None
        if lib_note is None:
            ms, _ = smoke.time_ms(torch, lambda i: torch._weight_int4pack_mm(
                x, packs[0][i % copies], 128, packs[1][i % copies]))
            lib_note = f"{ms * 1e3:.2f}"
        print(f"  {name} K {k} N {n}: " + ", ".join(row)
              + f"; _weight_int4pack_mm {lib_note}")
    print("2. decode entry on one column tile (M 8, N 128, no cluster): us "
          "by K")
    for k in (1024, 2048, 4096, 8192):
        steps = k // 2 // iq.DECODE_STEP // 8
        us = timed(8, k, 128, dict(cluster=1, warps=8, steps=steps))
        print(f"  K {k} ({steps} steps a warp): {us:.2f}")
    print("3. prefill entry (M 512): us by rows of x a block / stages (* "
          "the wrapper's plan)")
    for name, k, n in smoke.INT4_SHAPES:
        want = iq.prefill_plan(512, n, k, sms)
        row = []
        for rows in iq.PREFILL_ROWS:
            plan = dict(rows=rows, stages=iq.prefill_stages(rows))
            us = timed(512, k, n, plan)
            mark = "*" if rows == want["rows"] else ""
            row.append(f"{rows}{mark}/{plan['stages']}: {us:.2f}")
        print(f"  {name}: " + ", ".join(row))

    m, (name, k, n) = 8, smoke.INT4_SHAPES[0]
    plan = iq.decode_plan(m, n, k, sms)
    print(f"4. cycles by phase of the decode entry, rank 0 of the first "
          f"cluster, {name} (M {m}, K {k}, N {n}, plan {plan})")
    lib4 = stamped_library()
    x, qw, sc = operands(m, k, n, 1)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    for _ in range(2):                      # the second run is read
        _build.check(lib4.int4_quant_matmul_decode(
            ptr(x), ptr(qw[0]), ptr(sc[0]), m, n, k, k // 128,
            plan["cluster"], plan["warps"], plan["steps"], ptr(out),
            stream()), "stamped int4_quant_matmul_decode")
        torch.cuda.synchronize()
    st = (ctypes.c_longlong * 256)()
    lib4.read_stamps(st)
    # the second run wrote over the first's stamps
    got = phases(list(st)[:4 + plan["steps"] + 1], plan["steps"])
    for ph, v in got.items():
        print(f"  {ph}: {v} cycles")

    print("5. cycles by phase of the prefill entry, block (0, 0), M 512, the "
          "wrapper's plan")
    src = open(os.path.join(HERE, "eddie_wang_hackathon2023_tpu_torch",
                            "csrc", "int4_quant_matmul.cu")).read()
    lib5 = stamped_library(prefill_stamped_source(src), "int4_prefill_stamps")
    lib5.read_prefill_stamps.argtypes = [ctypes.c_void_p]
    for name, k, n in smoke.INT4_SHAPES:
        plan = iq.prefill_plan(512, n, k, sms)
        x, qw, sc = operands(512, k, n, 1)
        out = torch.empty((512, n), dtype=torch.bfloat16, device=dev)
        for _ in range(2):                  # the second run is read
            _build.check(lib5.int4_quant_matmul(
                ptr(x), ptr(qw[0]), ptr(sc[0]), 512, n, k, k // 128,
                plan["rows"], plan["stages"], ptr(out), stream()),
                "stamped int4_quant_matmul")
            torch.cuda.synchronize()
        st = (ctypes.c_longlong * (5 * PREFILL_CHUNKS + 4))()
        lib5.read_prefill_stamps(st)
        got = prefill_phases(list(st), -(-(k // 2) // iq.PREFILL_CHUNK))
        print(f"  {name} (K {k}, N {n}, plan {plan}): "
              + "; ".join(f"{ph} {v}" for ph, v in got.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
