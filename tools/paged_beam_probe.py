#!/usr/bin/env python3
"""Where the paged decode kernel's and the beam entry's time goes, on one
NVIDIA GPU.

    python3 tools/paged_beam_probe.py        # from the root of a checkout

1. Runs ``chip_smoke.py``'s ``paged_phase`` and ``beam_phase``: each kernel
   checked against its plain version and timed with CUDA events behind a
   spin at the serve and beam paths' shapes, beside its plain version and
   SDPA on K/V gathered through the table (the gather timed on its own).
2. Times both through their wrappers beside an empty ``fill_`` kernel: the
   paged kernel at the serve shape (8 rows, 16 KV heads of 64, T 32, a
   bf16 pool) over lengths and table widths, and the beam entry (beam 5,
   20 heads of 64, bf16 S 448) over lengths: the fixed cost and the cost
   per token.  Where the checkout's wrapper has ``paged_plan``, also the
   paged kernel's C entry under other plans (clusters of 1, 2 and 4
   slices, 1 to 4 warps, 1 or 2 query heads a block) at the serve and MQA
   int8 shapes, and the beam entry's under other rounds and splits of the
   source rows at lengths 44, 224 and 448, ``*`` marking the wrapper's.
3. Builds copies of ``csrc/paged_decode_attention.cu`` and
   ``csrc/decode_attention.cu`` into ``build/probe/`` in which every kernel
   of the paged file and every beam kernel of the other stamps, in thread 0
   of each block of the first cluster (the first block where no cluster is
   launched), ``%globaltimer`` (ns) and ``clock64()`` at its start, after
   every block or warp barrier, block reduction, ``cp.async`` wait,
   mbarrier wait and cluster wait, and before every return.  The wrappers then launch
   the stamped copies (with their own plans) at the paths' shapes, and the
   probe prints each block's phases in the order they ended, each named by
   the comment of its line (or its statement), in ns and cycles.
It works on any checkout whose kernels keep those names, so that a design
and its parent can be probed alike.
"""
import ctypes
import importlib.util
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
CSRC = os.path.join(HERE, "eddie_wang_hackathon2023_tpu_torch", "csrc")
N_RANKS, N_STAMPS = 8, 48
# the kernels stamped in each library
STAMPED = {"paged_decode_attention": r"\w*paged\w*kernel",
           "decode_attention": r"beam\w*kernel"}
# a statement that ends a phase: a block barrier, a block reduction, a wait
# for copies, an mbarrier or a cluster
ENDS = re.compile(r"__syncthreads\(\)|__syncwarp\(\)|block_reduce<|"
                  r"cp_async_wait|cp\.async\.wait|mbar_wait\(|"
                  r"cluster_wait\(\)")
HELPERS = """
__device__ long long g_ns[%d][%d];
__device__ long long g_cyc[%d][%d];
__device__ __forceinline__ void stamp_at(int n) {
  unsigned cx, cy, cz, rank;
  asm volatile("mov.u32 %%0, %%%%clusterid.x;" : "=r"(cx));
  asm volatile("mov.u32 %%0, %%%%clusterid.y;" : "=r"(cy));
  asm volatile("mov.u32 %%0, %%%%clusterid.z;" : "=r"(cz));
  asm volatile("mov.u32 %%0, %%%%cluster_ctarank;" : "=r"(rank));
  if (threadIdx.x != 0 || cx || cy || cz || rank >= %d) return;
  long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  g_ns[rank][n] = t;
  g_cyc[rank][n] = clock64();
}
""" % (N_RANKS, N_STAMPS, N_RANKS, N_STAMPS, N_RANKS)
READERS = """
extern "C" int read_stamps(long long* ns, long long* cyc) {
  cudaError_t e = cudaMemcpyFromSymbol(ns, g_ns, sizeof(g_ns));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(cyc, g_cyc, sizeof(g_cyc));
  return (int)e;
}
extern "C" int clear_stamps() {
  static long long z[%d][%d];
  cudaError_t e = cudaMemcpyToSymbol(g_ns, z, sizeof(z));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_cyc, z, sizeof(z));
  return (int)e;
}
""" % (N_RANKS, N_STAMPS)


def _closing(src, i, open_c, close_c):
    """The index just past the bracket that closes the one at src[i]."""
    depth = 0
    for j in range(i, len(src)):
        if src[j] == open_c:
            depth += 1
        elif src[j] == close_c:
            depth -= 1
            if depth == 0:
                return j + 1
    raise ValueError("unbalanced source")


def stamp_source(src, kernel_re, names):
    """``src`` with the stamps in the body of every ``__global__`` function
    whose name matches ``kernel_re``; appends each stamp's name to
    ``names`` (its index is the stamp's)."""
    out, at = [], 0
    head = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                      r"(\w+)\s*\(")
    for m in head.finditer(src):
        if not re.fullmatch(kernel_re, m.group(1)):
            continue
        body = src.index("{", _closing(src, m.end() - 1, "(", ")"))
        end = _closing(src, body, "{", "}")
        lines = src[body + 1:end - 1].split("\n")
        for k, line in enumerate(lines):
            code = line.split("//")[0].rstrip()
            note = line.split("//", 1)[1].strip() if "//" in line else ""
            if code.lstrip().startswith("return;") or code.endswith(
                    " return;"):
                names.append(f"{m.group(1)}: return")
                lines[k] = line.replace(
                    "return;", "{ stamp_at(%d); return; }" % (len(names) - 1),
                    1)
            elif ENDS.search(code) and code.endswith(";"):
                hit = ENDS.search(code)
                names.append(f"{m.group(1)}: " + (note or hit.group(0)))
                stamp = " stamp_at(%d);" % (len(names) - 1)
                if code.lstrip().startswith(("if ", "if(", "else")):
                    # the statement of an if or else: braced with its stamp
                    code = (code[:hit.start()] + "{ " + code[hit.start():]
                            + stamp + " }")
                else:
                    code += stamp
                lines[k] = code + ("  // " + note if note else "")
        names.append(f"{m.group(1)}: start")
        first = "stamp_at(%d);" % (len(names) - 1)
        names.append(f"{m.group(1)}: end")
        last = "stamp_at(%d);" % (len(names) - 1)
        out.append(src[at:body + 1] + "\n  " + first + "\n".join(lines)
                   + "  " + last + "\n}")
        at = end
    out.append(src[at:])
    if len(names) > N_STAMPS:
        raise ValueError(f"{len(names)} stamps, room for {N_STAMPS}")
    text = "".join(out)
    i = text.index("namespace {")
    return text[:i] + HELPERS + text[i:] + READERS


def stamped_libraries(_build):
    """{library: (ctypes library, stamp names)}: each stamped source built
    into build/probe/, one nvcc each, started together, loaded with the
    checkout's signatures."""
    out = os.path.join(HERE, "build", "probe")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, kernel_re in STAMPED.items():
        names = []
        src = stamp_source(open(os.path.join(CSRC, f"{name}.cu")).read(),
                           kernel_re, names)
        cu = os.path.join(out, f"{name}_stamps.cu")
        with open(cu, "w") as f:
            f.write(src)
        lib_path = os.path.join(out, f"lib{name}_stamps.so")
        procs[name] = (names, lib_path, subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *_build.NVCC_FLAGS, "-o", lib_path,
             cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (names, lib_path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the stamped {name}:\n{log}")
        lib = ctypes.CDLL(lib_path)
        for fn, args in _build.SIGNATURES[name].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        libs[name] = (lib, names)
    return libs


def phases(torch, _build, libs, name, call, what):
    """Runs ``call()`` (a wrapper's call) five times on the stamped copy of
    library ``name`` and prints each block's phases from the last run."""
    lib, names = libs[name]
    kept = _build._LIBS.get(name)
    _build._LIBS[name] = lib
    try:
        for _ in range(5):
            if lib.clear_stamps():
                raise RuntimeError("clear_stamps failed")
            call()
        torch.cuda.synchronize()
    finally:
        if kept is None:
            _build._LIBS.pop(name)
        else:
            _build._LIBS[name] = kept
    ns = (ctypes.c_longlong * (N_RANKS * N_STAMPS))()
    cyc = (ctypes.c_longlong * (N_RANKS * N_STAMPS))()
    if lib.read_stamps(ns, cyc):
        raise RuntimeError("read_stamps failed")
    rows = [[(ns[r * N_STAMPS + k], cyc[r * N_STAMPS + k])
             for k in range(N_STAMPS)] for r in range(N_RANKS)]
    t0 = min(v for row in rows for v, _ in row if v)
    print(f"{what}: phases of each block of the first cluster, in the "
          "order they ended (ns / cycles), from the first block's start")
    for r, row in enumerate(rows):
        t = sorted(((k, v, c) for k, (v, c) in enumerate(row) if v),
                   key=lambda x: (x[1], x[2]))
        if not t:
            continue
        print(f"  rank {r}: start {t[0][1] - t0} ns; " + "; ".join(
            f"{names[k].split(': ', 1)[1]} {b - a} / {cb - ca}"
            for (_, a, ca), (k, b, cb) in zip(t, t[1:]))
            + f"; total {t[-1][1] - t[0][1]} ns / {t[-1][2] - t[0][2]} "
            "cycles")


def main():
    import torch
    if not torch.cuda.is_available():
        print("paged_beam_probe: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from eddie_wang_hackathon2023_tpu_torch.ops import _build
    from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    _build.build(["paged_decode_attention", "decode_attention"])
    libs = stamped_libraries(_build)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    # 1. the kernel phases of chip_smoke.py
    results = {}
    smoke.paged_phase(torch, results, g)
    smoke.beam_phase(torch, results, g)

    # 2. over lengths and table widths
    z = torch.zeros(1, device=dev)
    ms, _ = smoke.time_ms(torch, lambda i: z.fill_(1.0))
    print(f"fill_ kernel: {ms * 1e3:.2f} us")
    L, T, B, hkv, D = 24, smoke.SERVE_BLOCK, smoke.SERVE_SLOTS, 16, 64

    def paged_operands(n, mb, rep=1, d=D, heads=hkv, int8=False):
        N = max(64, B * mb)                # every row its own blocks
        shape = (L, N, 2, heads, T, d)
        pool = (torch.randint(-127, 128, shape, generator=g, device=dev,
                              dtype=torch.int8) if int8 else
                torch.randn(shape, generator=g, device=dev).bfloat16())
        q = torch.randn(B, heads * rep, 1, d, generator=g,
                        device=dev).bfloat16()
        table = torch.randperm(N, generator=g, device=dev)[:B * mb].to(
            torch.int32).reshape(B, mb)
        seq = torch.full((B,), n, dtype=torch.int32, device=dev)
        ks = torch.tensor(1 / 40.0, device=dev) if int8 else None
        return pool, q, table, seq, ks

    for n, mb in ((1, 4), (32, 4), (64, 4), (80, 4), (128, 4), (80, 3),
                  (256, 8), (512, 16)):
        pool, q, table, seq, ks = paged_operands(n, mb)
        ms, _ = smoke.time_ms(torch, lambda i: da.fused_paged_decode_attention(
            pool, i % L, q, table, seq, D ** -0.5, kv_quant_orig_scale=ks))
        print(f"paged, serve shape, table width {mb}, length {n}: "
              f"{ms * 1e3:.2f} us")
        del pool
    if hasattr(da, "paged_plan"):
        # the paged kernel's C entry under other plans than the wrapper's:
        # clusters of 1, 2 and 4 slices, 1 to 4 warps, 1 or 2 query heads
        stream = torch.cuda.current_stream().cuda_stream
        lib = _build.load("paged_decode_attention")
        for what, args, plans in (
                ("serve shape", dict(n=80, mb=4),
                 [(s_, w_, 1) for s_ in (1, 2, 4) for w_ in (1, 2, 4)]),
                ("MQA int8", dict(n=80, mb=4, rep=16, d=128, heads=1,
                                  int8=True),
                 [(1, 4, 1), (1, 4, 2), (2, 2, 1), (2, 2, 2), (2, 4, 2),
                  (4, 1, 2)])):
            pool, q, table, seq, ks = paged_operands(**args)
            d, hkv = pool.shape[-1], pool.shape[3]
            out = torch.empty_like(q)
            wrapper = da.paged_plan(4, T, q.shape[1] // hkv)
            for splits, warps, heads in plans:
                width = 4 * T // splits
                plan = dict(splits=splits, width=width, warps=warps,
                            rounds=-(-width // (32 * warps)), heads=heads)

                def run(i, plan=plan):
                    err = lib.paged_decode_attention(
                        q.data_ptr(), pool.data_ptr(), int(args.get(
                            "int8", False)), i % L, pool.shape[1], hkv,
                        q.shape[1] // hkv, T, d, B, 4, table.data_ptr(),
                        seq.data_ptr(), None if ks is None else ks.data_ptr(),
                        d ** -0.5, *plan.values(), out.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"plan {plan}: error {err}")
                ms, _ = smoke.time_ms(torch, run)
                mark = " *" if plan == wrapper else ""
                print(f"paged, {what}, length 80, plan {plan}: "
                      f"{ms * 1e3:.2f} us{mark}")
            del pool
    bw, H, S = smoke.BEAM_SIZE, 20, 448
    bcache = torch.randn(32, bw, 2, H, D, S, generator=g,
                         device=dev).bfloat16()
    bq = torch.randn(bw, H, 1, D, generator=g, device=dev).bfloat16()
    bfresh = tuple(torch.randn(bw, H, D, 1, generator=g,
                               device=dev).bfloat16() for _ in range(2))
    bind = torch.randint(0, bw, (1, bw, S), generator=g, device=dev,
                         dtype=torch.int32)
    for n in (1, 2, 44, 128, 224, 225, 448):
        bseq = torch.full((bw,), n, dtype=torch.int32, device=dev)
        ms, _ = smoke.time_ms(torch, lambda i: da.fused_decode_attention(
            bcache, i % 32, bq, bseq, D ** -0.5, fresh_kv=bfresh,
            beam_indirection=bind))
        print(f"beam, beam {bw}, bf16 S {S}, length {n}: {ms * 1e3:.2f} us")
    if hasattr(da, "beam_plan"):
        # the beam entry's C entry under other rounds and row splits than
        # the wrapper's
        stream = torch.cuda.current_stream().cuda_stream
        lib = _build.load("decode_attention")
        bctx = torch.empty(bw, H * D, dtype=torch.bfloat16, device=dev)
        wrapper = da.beam_plan(S, bw, D, 2)
        for cols, rs in ((144, 1), (112, 2), (224, 2), (224, 4)):
            plan = dict(wrapper, cols=cols,
                        rounds=-(-wrapper["width"] // cols), rs=rs,
                        rows=-(-bw // rs))
            for n in (44, 224, 448):
                bseq = torch.full((bw,), n, dtype=torch.int32, device=dev)

                def run(i, plan=plan, bseq=bseq):
                    err = lib.beam_decode_attention(
                        bq.data_ptr(), bcache.data_ptr(), 0, i % 32, bw, H,
                        D, S, *plan.values(), bseq.data_ptr(), None, None,
                        D ** -0.5, bfresh[0].data_ptr(), bfresh[1].data_ptr(),
                        bind.data_ptr(), bw, bctx.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"plan {plan}: error {err}")
                ms, _ = smoke.time_ms(torch, run)
                mark = " *" if plan == wrapper else ""
                print(f"beam, length {n}, plan {plan}: {ms * 1e3:.2f} us"
                      f"{mark}")

    # 3. the stamped copies at the paths' shapes
    for what, args in (("paged, serve shape, length 80", dict(n=80, mb=4)),
                       ("paged, MQA int8 (1 KV head x 16, D 128), length 80",
                        dict(n=80, mb=4, rep=16, d=128, heads=1,
                             int8=True))):
        g.manual_seed(2)
        pool, q, table, seq, ks = paged_operands(**args)
        phases(torch, _build, libs, "paged_decode_attention",
               lambda: da.fused_paged_decode_attention(
                   pool, 0, q, table, seq, D ** -0.5,
                   kv_quant_orig_scale=ks), what)
        del pool
    for n in (44, 448):
        bseq = torch.full((bw,), n, dtype=torch.int32, device=dev)
        phases(torch, _build, libs, "decode_attention",
               lambda: da.fused_decode_attention(
                   bcache, 0, bq, bseq, D ** -0.5, fresh_kv=bfresh,
                   beam_indirection=bind),
               f"beam, beam {bw}, bf16 S {S}, length {n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
