#!/usr/bin/env python3
"""This checkout's attention kernels, its int4 dequant matmul and its
decode megakernel against another checkout's, in turns on one NVIDIA GPU.

    python3 tools/kernel_ab.py OTHER       # OTHER: the root of a checkout
    python3 tools/kernel_ab.py OTHER --only megakernel --rounds 12

Builds ``csrc/decode_attention.cu``, ``csrc/flash_attention.cu``,
``csrc/gqa_decode_attention.cu``, ``csrc/int4_quant_matmul.cu``,
``csrc/decoder_layer.cu``, ``csrc/paged_decode_attention.cu`` and
``examples/custom_kernel_torch/fmha.cu`` of
OTHER into ``build/ab/`` (each with the ctypes signatures of OTHER's
``ops/_build.py``, and launched with the plans of OTHER's ``fmha_cuda.py``,
``ops/flash_attention.py``, ``ops/int4_quant_matmul.py``,
``ops/decoder_layer.py`` and ``ops/decode_attention.py``, read from the
files) and times, with CUDA events
behind a spin as ``chip_smoke.py`` does, their entries at the paths'
shapes: the beam entry of kernel 1 (beam 5, 20 heads of 64, bf16 S 448 at
sequence 44, 32 layers rotating, with each checkout's ``beam_plan`` where
its C entry takes one), the paged kernel at the serve shape (8 rows, 16 KV
heads of 64, T 32, a table of 4 blocks, lengths 61-80, bf16, 24 layers
rotating) and the MQA int8 shape (one KV head under 16 query heads of 128;
each checkout's ``paged_plan`` where its entry takes one), its window
entry at the serve shape (windows of 16; where both checkouts have it),
kernel 1's
cross (int8 S 1500) and self (bf16 S 448, sequence 44) calls at batch 1,
the out-projection GEMV alone (each checkout's ``gemv_plan`` where its
entry takes one) and behind each of those calls on its context (the pair
the scanned path launches for an attention layer), kernel 2's fp32 entry ([1,20,1536,64],
valid 1500) and its causal mode ([1,20,227,64] bf16), kernel 2's bf16
non-causal entry ([1,20,1536,64], valid 1500), the user FMHA's fp32 and
bf16 entries ([1,20,1536,64] valid 1500; bf16 also [1,20,3,64] causal), the
grouped kernel at the decoder path's shape (batch 8, one KV head under 16
query heads of 128, S 84, sequence 70, start 4, 24 layers rotating) with an
int8 and a bf16 cache, the int4 matmul at SantaCoder-1B's four linears
(groups of 128) at M 8 and M 512, rotating over weights past the L2, and
the decode megakernel's step at Whisper large-v2 (32 layers, d 1280, int8
panels, int8 cross cache of 1500, sequence 44, over a bf16 and over an
int8 self cache and, where the checkout builds its e4m3 library, over an
e4m3 one (else its int8 self step stands in: the e4m3 step against the
int8 one in turns); ``chip_smoke.py``'s seeded blobs, each checkout's own
weight layout) and, where both checkouts build its decoder-only set
(OTHER's argument structure filled from this one's by field name, where it
has no field this one lacks), at LLaMA-1B (16 layers, bf16 and int8
panels) and in its grouped mode at SantaCoder-1B (24 layers, bf16 and
int8 panels; ``chip_smoke.py``'s kernel phase).  Each is timed
four times, OTHER, this, this, OTHER, so that a drift of the card shows;
``--rounds N`` repeats that N times (2N pairs) and adds each side's median
and the pairs in which this checkout was faster; ``--only TEXT`` times
only the cases whose name holds TEXT.  Compare two versions only within
one run.
"""
import ast
import ctypes
import importlib.util
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
CSRC = os.path.join("eddie_wang_hackathon2023_tpu_torch", "csrc")
# each library's source, relative to the root of a checkout
SOURCES = {name: os.path.join(CSRC, f"{name}.cu")
           for name in ("decode_attention", "flash_attention",
                        "gqa_decode_attention", "int4_quant_matmul",
                        "decoder_layer", "paged_decode_attention")}
OPS = os.path.join("eddie_wang_hackathon2023_tpu_torch", "ops")
# the plan functions (and their helpers) read from each checkout's
# ops/int4_quant_matmul.py and ops/decode_attention.py; a checkout has
# those it has (the parent's int4 prefill entry took split_plan, this one's
# prefill_plan; the parent's GEMV took no plan, this one's gemv_plan)
INT4_PLANS = ("split_plan", "prefill_plan", "prefill_stage_bytes",
              "prefill_smem", "prefill_stages", "decode_plan",
              "_decode_tiles")
DECODE_PLANS = ("beam_plan", "beam_smem_bytes", "paged_plan",
                "decode_splits", "split_width", "_pow2_at_least", "_pad16",
                "gemv_plan")
SOURCES["custom_fmha"] = os.path.join("examples", "custom_kernel_torch",
                                      "fmha.cu")


def signatures(root, name):
    """The ctypes signatures of library ``name`` in the checkout at
    ``root``: its ``ops/_build.py`` table (plain Python, read from its
    file), or for the user FMHA the ``_ARGS`` list of its example's
    ``fmha_cuda.py`` (read from the file, so that nothing registers)."""
    if name == "custom_fmha":
        with open(os.path.join(root, "examples", "custom_kernel_torch",
                               "fmha_cuda.py")) as f:
            listed = re.search(r"^_ARGS = (\[[^\]]*\])", f.read(), re.M)
        types = {"_P": ctypes.c_void_p, "_I": ctypes.c_int,
                 "_F": ctypes.c_float}
        args = [types[t.strip()] for t in listed.group(1)[1:-1].split(",")]
        return {"custom_fmha": args, "custom_fmha_f32": args}
    return build_table(root).SIGNATURES[name]


def build_table(root):
    """The checkout's ``ops/_build.py`` (plain Python), loaded from its
    file."""
    spec = importlib.util.spec_from_file_location(
        f"_build_of_{abs(hash(root))}",
        os.path.join(root, "eddie_wang_hackathon2023_tpu_torch", "ops",
                     "_build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def defs_of(root, path, names):
    """The module-level constants (upper-case names) and the functions and
    classes ``names`` of the file ``path`` of the checkout at ``root``,
    taken from the file alone (nothing else of that module runs), as a
    dict; a name the file lacks is left out."""
    import functools
    import typing

    import torch
    with open(os.path.join(root, path)) as f:
        tree = ast.parse(f.read())
    keep = [n for n in tree.body
            if (isinstance(n, (ast.FunctionDef, ast.ClassDef))
                and n.name in names)
            or (isinstance(n, ast.Assign) and all(
                isinstance(e, ast.Name) and e.id.isupper()
                for t in n.targets
                for e in (t.elts if isinstance(t, ast.Tuple) else [t])))]
    scope = {"torch": torch, "ctypes": ctypes, "functools": functools,
             "Dict": typing.Dict,
             "Tuple": typing.Tuple, "Optional": typing.Optional}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), scope)
    return scope


def libraries(torch_build, roots):
    """{tag: {name: library}} for each checkout {tag: root}: every source
    built into build/ab/<tag>/, one nvcc each, all started together, and
    loaded with that checkout's ctypes signatures."""
    procs = {}
    for tag, root in roots.items():
        out = os.path.join(HERE, "build", "ab", tag)
        os.makedirs(out, exist_ok=True)
        sources = dict(SOURCES)
        table = build_table(root)
        # the megakernel's decoder-only set and each set's e4m3 self-cache
        # library, where the checkout has them (built with its own macros)
        for name in ("decoder_stack", "decoder_layer_fp8"):
            if name in table.SIGNATURES:
                sources[name] = SOURCES["decoder_layer"]
        for name, src in sources.items():
            lib_path = os.path.join(out, f"lib{name}.so")
            procs[tag, name] = (lib_path, subprocess.Popen(
                ["/usr/local/cuda/bin/nvcc", *torch_build.NVCC_FLAGS,
                 *getattr(table, "DEFINES", {}).get(name, []), "-o",
                 lib_path, os.path.join(root, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {tag: {} for tag in roots}
    for (tag, name), (lib_path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag}'s {name}:\n{log}")
        lib = ctypes.CDLL(lib_path)
        for fn, args in signatures(roots[tag], name).items():
            getattr(lib, fn).argtypes = args
        libs[tag][name] = lib
    return libs


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(prog="kernel_ab.py")
    ap.add_argument("other", help="the root of the other checkout")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of OTHER, this, this, OTHER a case")
    ap.add_argument("--only", default="",
                    help="time only the cases whose name holds this")
    opts = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if not os.path.isdir(os.path.join(opts.other, CSRC)) or opts.rounds < 1:
        print("usage: kernel_ab.py OTHER_CHECKOUT [--rounds N] "
              "[--only TEXT]", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
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
    roots = {"other": opts.other, "this": HERE}
    libs = libraries(_build, roots)
    # each checkout's own plans: the user FMHA's, and kernel 2's causal one
    # (None where the checkout has none)
    fmha_plans = {who: defs_of(root, os.path.join(
        "examples", "custom_kernel_torch", "fmha_cuda.py"),
        ("fmha_plan",)).get("fmha_plan") for who, root in roots.items()}
    causal_plans = {who: defs_of(root, os.path.join(OPS, "flash_attention.py"),
                                 ("causal_plan",)).get("causal_plan")
                    for who, root in roots.items()}
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    L, bw, H, D, S, n = 32, 5, 20, 64, 448, 44
    cache = torch.randn(L, bw, 2, H, D, S, generator=g, device=dev).bfloat16()
    q = torch.randn(bw, H, 1, D, generator=g, device=dev).bfloat16()
    fk, fv = (torch.randn(bw, H, D, 1, generator=g, device=dev).bfloat16()
              for _ in range(2))
    ind = torch.randint(0, bw, (1, bw, S), generator=g, device=dev,
                        dtype=torch.int32)
    seq = torch.full((bw,), n, dtype=torch.int32, device=dev)
    ctx = torch.empty(bw, H * D, dtype=torch.bfloat16, device=dev)

    # each checkout's plans of the decode kernels (None where it has none)
    da_defs = {who: defs_of(root, os.path.join(OPS, "decode_attention.py"),
                            DECODE_PLANS)
               for who, root in roots.items()}

    def beam(who, i):
        fn = libs[who]["decode_attention"].beam_decode_attention
        # the checkout's beam_plan after S, where its signature takes one
        plan = (list(da_defs[who]["beam_plan"](S, bw, D, 2).values())
                if len(fn.argtypes) > 18 else [])
        return fn(q.data_ptr(), cache.data_ptr(), 0, i % L, bw, H, D, S,
                  *plan, seq.data_ptr(), None, None, D ** -0.5,
                  fk.data_ptr(), fv.data_ptr(), ind.data_ptr(), bw,
                  ctx.data_ptr(), stream())

    # kernel 1 without beams (the same entry in both checkouts): the cross
    # call (int8 S 1500, batch 1) and the self call (bf16 S 448, seq 44)
    xl = 8
    xcache = torch.randint(-127, 128, (xl, 1, 2, H, D, 1500), generator=g,
                           device=dev, dtype=torch.int8)
    xseq = torch.full((1,), 1500, dtype=torch.int32, device=dev)
    scache = torch.randn(L, 1, 2, H, D, S, generator=g,
                         device=dev).bfloat16()
    sseq = torch.full((1,), n, dtype=torch.int32, device=dev)
    ks1 = torch.tensor(1 / 40.0, device=dev)
    kctx = torch.empty(1, H * D, dtype=torch.bfloat16, device=dev)

    def kernel1(cross):
        def run(who, i):
            c, Sx, sq = (xcache, 1500, xseq) if cross else (scache, S, sseq)
            layer = i % (xl if cross else L)
            return libs[who]["decode_attention"].decode_attention(
                q.data_ptr(), c.data_ptr(), int(cross), layer, 1, H, D, Sx,
                da.decode_splits(Sx), sq.data_ptr(), None,
                ks1.data_ptr() if cross else None, D ** -0.5,
                None if cross else fk.data_ptr(),
                None if cross else fv.data_ptr(), kctx.data_ptr(), stream())
        return run

    # the out-projection GEMV at the scanned path's shape ([1,1280] x
    # [1280,1280] int8, 8 layers rotating)
    pw = torch.randint(-127, 128, (xl, 1280, 1280), generator=g, device=dev,
                       dtype=torch.int8)
    px = torch.randn(1, 1280, generator=g, device=dev).bfloat16()
    ps = torch.rand(1280, generator=g, device=dev) * 1e-3
    pb = torch.randn(1280, generator=g, device=dev).bfloat16()
    pout = torch.empty(1, 1280, dtype=torch.bfloat16, device=dev)

    def gemv(who, i, x=px):
        fn = libs[who]["decode_attention"].out_proj_gemv
        # the checkout's gemv_plan after N, where its signature takes one
        plan = (list(da_defs[who]["gemv_plan"](1, 1280, 1280, sms).values())
                if len(fn.argtypes) > 10 else [])
        return fn(x.data_ptr(), pw.data_ptr(), i % xl, ps.data_ptr(),
                  pb.data_ptr(), pout.data_ptr(), 1, 1280, 1280, *plan,
                  stream())

    # the pair the scanned path launches for each attention layer: kernel 1,
    # then the GEMV on its context
    def pair(cross):
        attention = kernel1(cross)

        def run(who, i):
            return attention(who, i) or gemv(who, i, kctx)
        return run

    # the paged kernel at the serve path's shape (8 rows, 16 KV heads of 64,
    # T 32, a table of 4 blocks, lengths 61-80, a bf16 pool of 24 layers)
    # and at the MQA int8 shape (one KV head under 16 query heads of 128);
    # each checkout's paged_plan after the scale, where its signature takes
    # one
    def paged(hkv, rep, pd, int8):
        pl, pn, pt, pb_, pmb = 24, 32, 32, 8, 4
        shape = (pl, pn, 2, hkv, pt, pd)
        pool = (torch.randint(-127, 128, shape, generator=g, device=dev,
                              dtype=torch.int8) if int8 else
                torch.randn(shape, generator=g, device=dev).bfloat16())
        pq = torch.randn(pb_, hkv * rep, 1, pd, generator=g,
                         device=dev).bfloat16()
        pseq = torch.randint(61, 81, (pb_,), generator=g, device=dev,
                             dtype=torch.int32)
        table = torch.randperm(pn, generator=g, device=dev).to(
            torch.int32).reshape(pb_, pmb)
        table = torch.where(torch.arange(pmb, device=dev)[None, :]
                            < ((pseq + pt - 1) // pt)[:, None], table,
                            -1).contiguous()
        pks = ks1 if int8 else None
        pout = torch.empty_like(pq)

        def run(who, i):
            fn = libs[who]["paged_decode_attention"].paged_decode_attention
            plan = (list(da_defs[who]["paged_plan"](pmb, pt, rep).values())
                    if len(fn.argtypes) == 22 else [])
            return fn(pq.data_ptr(), pool.data_ptr(), int(int8), i % pl, pn,
                      hkv, rep, pt, pd, pb_, pmb, table.data_ptr(),
                      pseq.data_ptr(), None if pks is None else
                      pks.data_ptr(), pd ** -0.5, *plan, pout.data_ptr(),
                      stream())
        return run

    # the paged kernel's window entry at the serve_modes path's mixed shape
    # (8 rows, 16 KV heads of 64, T 32, a table of 4 blocks, windows of 16:
    # prompt chunks at 0, 16, 37, 45 beside 4 decode windows, a bf16 pool
    # of 24 layers), where both checkouts have it
    def window():
        pl, pn, pt, pb_, pmb, pw = 24, 32, 32, 8, 4, 16
        pool = torch.randn((pl, pn, 2, 16, pt, 64), generator=g,
                           device=dev).bfloat16()
        pq = torch.randn(pb_, 16, pw, 64, generator=g,
                         device=dev).bfloat16()
        off = [0, 16, 37, 45, 61, 66, 72, 79]
        seq = [16, 32, 53, 60, 62, 67, 73, 80]
        woff = torch.tensor(off, dtype=torch.int32, device=dev)
        wseq = torch.tensor(seq, dtype=torch.int32, device=dev)
        table = torch.randperm(pn, generator=g, device=dev).to(
            torch.int32).reshape(pb_, pmb)
        table = torch.where(torch.arange(pmb, device=dev)[None, :]
                            < ((wseq + pt - 1) // pt)[:, None], table,
                            -1).contiguous()
        pout = torch.empty_like(pq)

        def run(who, i):
            fn = libs[who]["paged_decode_attention"].paged_window_attention
            return fn(pq.data_ptr(), pool.data_ptr(), 0, i % pl, pn, 16, 1,
                      pt, 64, pb_, pmb, pw, table.data_ptr(),
                      wseq.data_ptr(), woff.data_ptr(), None, 64 ** -0.5,
                      pout.data_ptr(), stream())
        return run

    def flash_operands(lq, dtype):
        qkv = torch.randn(1, lq, 3, H, D, generator=g, device=dev).to(dtype)
        t = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
        t.append(torch.empty(1, H, lq, D, dtype=dtype, device=dev))
        strides = (ctypes.c_longlong * 12)(
            *[s for x in t for s in x.stride()[:3]])
        return t, strides

    def flash(entry, operands, lq, valid, causal, name="flash_attention"):
        (tq, tk, tv, to), strides = operands

        def run(who, i):
            fn = getattr(libs[who][name], entry)
            # the checkout's own plan after `causal`, where its signature
            # takes one: the user FMHA's warps and row blocks, kernel 2's
            # bf16 entry the causal plan's rows and splits (0, 0 when not
            # causal)
            extra = []
            if len(fn.argtypes) == 16 and name == "custom_fmha":
                plan = fmha_plans[who](lq, tq.dtype)
                extra = [plan["warps"], plan["row_blocks"]]
            elif len(fn.argtypes) == 16:
                plan = (causal_plans[who](lq, lq, valid, H, sms)
                        if causal else None)
                extra = [plan["rows"], plan["splits"]] if plan else [0, 0]
            return fn(tq.data_ptr(), tk.data_ptr(), tv.data_ptr(),
                      to.data_ptr(), 1, H, lq, lq, D, valid, causal, *extra,
                      ctypes.cast(strides, ctypes.c_void_p), D ** -0.5,
                      stream())
        return run

    # the grouped kernel at the decoder path's shape; the C entry takes the
    # wrapper's splits (and then its slice width) after S where the
    # checkout's signature has them
    gl, gb, gd, gs, gn = 24, 8, 128, 84, 70
    gq = torch.randn(gb, 16, 1, gd, generator=g, device=dev).bfloat16()
    gseq = torch.full((gb,), gn, dtype=torch.int32, device=dev)
    gstart = torch.full((gb,), 4, dtype=torch.int32, device=dev)
    gout = torch.empty(gb, 16 * gd, dtype=torch.bfloat16, device=dev)
    ks8 = torch.tensor(1 / 40.0, device=dev)

    def grouped(int8):
        if int8:
            c = torch.randint(-127, 128, (gl, gb, 2, 1, gd, gs), generator=g,
                              device=dev, dtype=torch.int8)
            f = [torch.randint(-127, 128, (gb, 1, gd, 1), generator=g,
                               device=dev, dtype=torch.int8)
                 for _ in range(2)]
        else:
            c = torch.randn(gl, gb, 2, 1, gd, gs, generator=g,
                            device=dev).bfloat16()
            f = [torch.randn(gb, 1, gd, 1, generator=g,
                             device=dev).bfloat16() for _ in range(2)]

        def run(who, i):
            fn = libs[who]["gqa_decode_attention"].gqa_decode_attention
            split = [da.gqa_splits(gs), da.gqa_slice_width(
                gs, da.gqa_splits(gs))][:len(fn.argtypes) - 17]
            return fn(gq.data_ptr(), c.data_ptr(), int(int8), i % gl, gb, 1,
                      16, gd, gs, *split, gseq.data_ptr(), gstart.data_ptr(),
                      ks8.data_ptr() if int8 else None, gd ** -0.5,
                      f[0].data_ptr(), f[1].data_ptr(), gout.data_ptr(),
                      stream())
        return run

    cases = [
        ("beam entry, bf16 S 448, seq 44, beam 5", beam),
        ("paged, serve: bf16, 8 rows, 16 KV heads of 64, T 32, seq 61-80",
         paged(16, 1, 64, False)),
        ("paged, MQA: int8, 8 rows, 1 KV head x 16, D 128, T 32, seq 61-80",
         paged(1, 16, 128, True)),
        ("kernel 1 cross, int8 S 1500, batch 1", kernel1(True)),
        ("kernel 1 self, bf16 S 448, seq 44, batch 1", kernel1(False)),
        ("out-projection GEMV [1,1280] x [1280,1280] int8", gemv),
        ("kernel 1 cross + the GEMV on its context", pair(True)),
        ("kernel 1 self + the GEMV on its context", pair(False)),
        ("flash fp32 [1,20,1536,64] valid 1500", flash(
            "flash_attention_f32", flash_operands(1536, torch.float32),
            1536, 1500, 0)),
        ("flash causal [1,20,227,64] bf16", flash(
            "flash_attention", flash_operands(227, torch.bfloat16), 227,
            227, 1)),
        ("flash bf16 [1,20,1536,64] valid 1500", flash(
            "flash_attention", flash_operands(1536, torch.bfloat16), 1536,
            1500, 0)),
        ("user FMHA fp32 [1,20,1536,64] valid 1500", flash(
            "custom_fmha_f32", flash_operands(1536, torch.float32), 1536,
            1500, 0, "custom_fmha")),
        ("user FMHA bf16 [1,20,1536,64] valid 1500", flash(
            "custom_fmha", flash_operands(1536, torch.bfloat16), 1536, 1500,
            0, "custom_fmha")),
        ("user FMHA bf16 [1,20,3,64] causal", flash(
            "custom_fmha", flash_operands(3, torch.bfloat16), 3, 3, 1,
            "custom_fmha")),
        ("grouped int8, batch 8, 1 KV head x 16, D 128, S 84, seq 70",
         grouped(True)),
        ("grouped bf16, batch 8, 1 KV head x 16, D 128, S 84, seq 70",
         grouped(False)),
    ]
    if all(hasattr(libs[who]["paged_decode_attention"],
                   "paged_window_attention") for who in roots):
        cases.insert(3, ("paged window entry, serve: bf16, 8 rows, 16 KV "
                         "heads of 64, T 32, windows of 16", window()))
    # the int4 matmul: each checkout's entry for M 8 (the decode entry and
    # its plan, or the one entry with the split plan) and M 512
    int4_defs = {who: defs_of(root, os.path.join(OPS, "int4_quant_matmul.py"),
                              INT4_PLANS)
                 for who, root in roots.items()}
    counters = torch.zeros(1 << 16, dtype=torch.int32, device=dev)

    def int4(m, k, n):
        copies = -(-120_000_000 // (k // 2 * n))
        qw = torch.randint(-128, 128, (copies, k // 2, n), generator=g,
                           device=dev, dtype=torch.int8)
        sc = torch.rand((copies, k // 128, n), generator=g, device=dev)
        x = torch.randn((m, k), generator=g, device=dev).bfloat16()
        out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
        ws = torch.empty((64, m, n), dtype=torch.float32, device=dev)

        def run(who, i):
            lib, defs = libs[who]["int4_quant_matmul"], int4_defs[who]
            w, s_ = qw[i % copies].data_ptr(), sc[i % copies].data_ptr()
            if "decode_plan" in defs and m <= defs["DECODE_MAX_M"]:
                p = defs["decode_plan"](m, n, k, sms)
                return lib.int4_quant_matmul_decode(
                    x.data_ptr(), w, s_, m, n, k, k // 128, p["cluster"],
                    p["warps"], p["steps"], out.data_ptr(), stream())
            if "prefill_plan" in defs:
                p = defs["prefill_plan"](m, n, k, sms)
                return lib.int4_quant_matmul(
                    x.data_ptr(), w, s_, m, n, k, k // 128, p["rows"],
                    p["stages"], out.data_ptr(), stream())
            # a checkout whose prefill entry split K through a workspace
            plan = defs["split_plan"](m, n, k, sms)
            return lib.int4_quant_matmul(
                x.data_ptr(), w, s_, m, n, k, k // 128, *plan,
                ws.data_ptr(), counters.data_ptr(), out.data_ptr(),
                stream())
        return run

    # the megakernel: each checkout's argument structure and plan, read
    # from its files; the blobs are chip_smoke's, with this checkout's
    # tiles (the parent's kernel reads the panels)
    mk_defs = {who: defs_of(root, os.path.join(OPS, "decoder_layer.py"),
                            ("_MegaArgs", "megakernel_plan", "_panels",
                             "_flat_slots"))
               for who, root in roots.items()}
    ml, mh, md, ms_, msc, mn = 32, 20, 1280, 448, 1500, 44
    blobs = smoke.random_blobs(torch, dev, g, ml, md)
    mnf = (blobs.wblob.shape[1] - 6) // 2
    mx = torch.randn(md, generator=g, device=dev).bfloat16()
    mself = torch.randn(ml, 1, 2, mh, 64, ms_, generator=g,
                        device=dev).bfloat16()
    # the int8 self cache (kv8): the bf16 cache's values at steps 4 / 127
    mstep = torch.full((ml,), 4 / 127, device=dev)
    mself8 = torch.clamp(torch.round(mself.float() * (127 / 4)), -128,
                         127).to(torch.int8)
    moq = (1 / mstep).contiguous()
    # the e4m3 self cache: the same values at the scale 4 / 448
    mstep_f8 = torch.full((ml,), 4 / 448, device=dev)
    mself_f8 = (mself.float() * 112).clamp(-448, 448).to(
        torch.float8_e4m3fn)
    moq_f8 = (1 / mstep_f8).contiguous()
    mcross = torch.randint(-127, 128, (ml, 1, 2, mh, 64, msc), generator=g,
                           device=dev, dtype=torch.int8)
    mcs = torch.full((ml,), 1 / 40.0, device=dev)
    mseq = torch.tensor([mn], dtype=torch.int32, device=dev)
    mbufs = [torch.empty(n_, dtype=torch.float32, device=dev) for n_ in (
        max(3, mnf) * 4 * md, mnf * 4 * md, mh * 8 * 66, md)]
    mhid = torch.empty(md, dtype=torch.bfloat16, device=dev)
    mfresh = torch.empty(ml, 2, mh, 64, dtype=torch.bfloat16, device=dev)
    # the barrier, then (this checkout's) the heads' counters
    mbar = torch.zeros(2 + 2 * ml * mh, dtype=torch.int32, device=dev)

    def mega_args(who, self8=False, f8=False):
        defs = mk_defs[who]
        pan, slots = defs["_panels"](mnf), defs["_flat_slots"](mnf)
        plan = (defs["megakernel_plan"](md, mnf, sms)
                if "megakernel_plan" in defs else {})
        ptrs = dict(x=mx, wblob=blobs.wblob, tiles=blobs.tiles,
                    pair_scale=blobs.pair_scale, pair_bias=blobs.pair_bias,
                    flat_scale=blobs.flat_scale, flat_bias=blobs.flat_bias,
                    ln_par=blobs.ln_par,
                    self_cache=(mself_f8 if f8 else mself8 if self8
                                else mself), cross_cache=mcross,
                    cross_scale=mcs, seq_len=mseq, hid=mhid, fresh=mfresh,
                    part_a=mbufs[0], part_b=mbufs[1], act_a=mbufs[0],
                    act_b=mbufs[1], att=mbufs[2], ctx=mbufs[3],
                    barrier=mbar, heads=mbar[2:])
        vals = dict(n_layer=ml, d=md, n_head=mh, s_self=ms_, s_cross=msc,
                    npan=blobs.wblob.shape[1], nflat=blobs.flat_scale.shape[1],
                    nf=mnf, p_qkv=pan["q"], p_dense=pan["dense"],
                    p_crossq=pan["crossq"], p_crossdense=pan["crossdense"],
                    p_fc1=pan["fc1"], p_fc2=pan["fc2"],
                    f_dense=slots["dense"], f_crossdense=slots["crossdense"],
                    f_fc1=slots["fc1"], f_fc2=slots["fc2"], cross_int8=1,
                    ring_bytes=0, scale=64 ** -0.5, eps=1e-5,
                    # the int8 self mode (kv8), the e4m3 one, or the bf16
                    # step (a checkout names the field self_int8 or
                    # self_kind)
                    self_int8=int(self8), self_kind=2 if f8 else int(self8),
                    kv_oq=moq_f8 if f8 else moq if self8 else None,
                    kv_qo=mstep_f8 if f8 else mstep if self8 else None,
                    # this checkout's decoder-only modes, off: Whisper's
                    # step (cross-attention, LayerNorm, tanh GELU, int8
                    # panels, heads of 64)
                    start=None, inv_freq=None, head_dim=64, nq=4, n_ln=3,
                    n_kv_head=mh,
                    f_gate=slots.get("gate", 0), with_cross=1,
                    weight_bf16=0, norm_rms=0, act=0, gated=0, parallel=0,
                    rope_dim=0, rope_neox=0, write_index=0,
                    # int8 panels (not the int4 mode)
                    weight_int4=0, n_groups=0, **plan)
        cls = defs["_MegaArgs"]
        fields = []
        for name, typ in cls._fields_:
            if name in ("kv_oq", "kv_qo"):
                fields.append(None if vals[name] is None
                              else vals[name].data_ptr())
            elif name in ptrs:
                fields.append(ptrs[name].data_ptr())
            elif isinstance(vals[name], list):
                fields.append(typ(*vals[name]))
            else:
                fields.append(vals[name])
        return cls(*fields)

    margs = {who: mega_args(who) for who in roots}
    margs8 = {who: mega_args(who, self8=True) for who in roots}
    # the e4m3 self step where the checkout has its library, else its int8
    # self step (the e4m3 mode against the int8 one, in turns)
    has_f8 = {who: "decoder_layer_fp8" in libs[who] for who in roots}
    margs_f8 = {who: mega_args(who, f8=True) if has_f8[who]
                else margs8[who] for who in roots}

    def mega(who, i):
        mbar.zero_()                 # counters per call, as the wrapper's
        return libs[who]["decoder_layer"].decoder_megakernel(
            ctypes.byref(margs[who]), stream())

    def mega8(who, i):
        mbar.zero_()
        return libs[who]["decoder_layer"].decoder_megakernel(
            ctypes.byref(margs8[who]), stream())

    def mega_f8(who, i):
        mbar.zero_()
        lib = libs[who]["decoder_layer_fp8" if has_f8[who]
                        else "decoder_layer"]
        return lib.decoder_megakernel(ctypes.byref(margs_f8[who]), stream())

    for name, k, n in smoke.INT4_SHAPES:
        cases.append((f"int4 {name} M 8 (K {k}, N {n}, groups of 128)",
                      int4(8, k, n)))
    for name, k, n in smoke.INT4_SHAPES:
        cases.append((f"int4 {name} M 512 (K {k}, N {n}, groups of 128)",
                      int4(512, k, n)))
    cases.append(("megakernel step, large-v2 32 layers, seq 44, int8 cross",
                  mega))
    cases.append(("megakernel step, large-v2 32 layers, seq 44, int8 cross, "
                  "int8 self cache", mega8))
    cases.append(("megakernel step, large-v2 32 layers, seq 44, int8 cross, "
                  "e4m3 self cache (a checkout without the e4m3 mode: its "
                  "int8 self cache)", mega_f8))
    # the decoder-only set at LLaMA-1B's step (chip_smoke.py's kernel
    # phase: 16 layers, bf16 and int8 panels, a bf16 self cache of 84 at
    # sequence 74 from start 4, RoPE), where both checkouts have it: this
    # checkout's wrapper, each checkout's library, OTHER's structure
    # filled from this one's by field name (a field this one lacks, a mode
    # it does not have, 0)
    if all("decoder_stack" in libs[who] for who in roots):
        from eddie_wang_hackathon2023_tpu_torch.ops import \
            decoder_layer as mkw
        this_args = mkw._MegaArgs

        def args_as(cls):
            """``this_args``' constructor giving ``cls``'s structure."""
            def make(*vals):
                a = this_args(*vals)
                out = []
                for n, typ in cls._fields_:
                    v = getattr(a, n, 0)
                    out.append(typ(*v) if isinstance(v, ctypes.Array)
                               else v)
                return cls(*out)
            return make
        structs = {"this": this_args,
                   "other": args_as(mk_defs["other"]["_MegaArgs"])}
        lD = smoke.LLAMA_D // smoke.LLAMA_HEADS
        lx = torch.randn((1, smoke.LLAMA_D), generator=g,
                         device=dev).bfloat16()
        lcache = torch.randn((smoke.LLAMA_LAYERS, 1, 2, smoke.LLAMA_HEADS,
                              lD, smoke.LLAMA_S), generator=g,
                             device=dev).bfloat16()
        lseq = torch.tensor([smoke.LLAMA_SEQ], dtype=torch.int32,
                            device=dev)
        lkw = dict(start_index=torch.tensor([smoke.LLAMA_START],
                                            dtype=torch.int32, device=dev),
                   head_dim=lD, act="silu", norm="rmsnorm", gated=True,
                   rope=mkw.Rotary(smoke.LLAMA_SEQ - 1, lD, 10000.0, True))

        def stack_run(blobs, x, cache, kw):
            def run(who, i):
                _build._LIBS["decoder_stack"] = libs[who]["decoder_stack"]
                mkw._MegaArgs = structs[who]
                try:
                    mkw.fused_decoder_stack(x, blobs, cache, lseq,
                                            cache.shape[4] ** -0.5, **kw)
                finally:
                    mkw._MegaArgs = this_args
                return 0
            return run

        def llama(weight):
            return stack_run(smoke.llama_blobs(torch, dev, g,
                                               smoke.LLAMA_LAYERS, weight),
                             lx, lcache, lkw)

        for weight in ("bf16", "int8"):
            cases.append((f"megakernel step, LLaMA-1B 16 layers, {weight} "
                          "panels, seq 74", llama(weight)))
        # SantaCoder-1B's grouped (MQA) mode: 16 query heads of 128 over one
        # KV head, LayerNorm, GELU, biases (chip_smoke's kernel phase)
        sd, sh, sl = smoke.SANTA_D, smoke.SANTA_HEADS, smoke.SANTA_LAYERS
        sx = torch.randn((1, sd), generator=g, device=dev).bfloat16()
        # (its own name: kernel 1's self case reads ``scache`` when it runs)
        santa_cache = torch.randn((sl, 1, 2, 1, sd // sh, smoke.LLAMA_S),
                                  generator=g, device=dev).bfloat16()
        skw = dict(start_index=lkw["start_index"], head_dim=sd // sh,
                   act="gelu", norm="layernorm")
        for weight in ("bf16", "int8"):
            sblobs = smoke.random_blobs_of(torch, dev, g, sl, weight, sd,
                                           smoke.SANTA_FFN, sh, 1, False,
                                           True)
            cases.append((f"megakernel step, SantaCoder-1B 24 layers (MQA), "
                          f"{weight} panels, seq 74",
                          stack_run(sblobs, sx, santa_cache, skw)))
    for what, fn in cases:
        if opts.only not in what:
            continue
        times, us = [], {"other": [], "this": []}
        for _ in range(opts.rounds):
            for who in ("other", "this", "this", "other"):
                if fn(who, 0) != 0:
                    raise RuntimeError(f"{what}: {who}'s launch failed")
                ms, _ = smoke.time_ms(torch, lambda i, who=who: fn(who, i))
                times.append(f"{who} {ms * 1e3:.2f}")
                us[who].append(ms * 1e3)
        line = f"{what}: " + ", ".join(times) + " us"
        if opts.rounds > 1:
            # pair k: this's k-th time against other's k-th (the rounds
            # alternate which of them comes first)
            faster = sum(t < o for t, o in zip(us["this"], us["other"]))
            med = {k: sorted(v)[len(v) // 2] for k, v in us.items()}
            line += (f"; median other {med['other']:.2f}, this "
                     f"{med['this']:.2f} us; this faster in {faster} of "
                     f"{len(us['this'])} pairs")
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
