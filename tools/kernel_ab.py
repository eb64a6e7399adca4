#!/usr/bin/env python3
"""This checkout's attention kernels against another checkout's, in turns
on one NVIDIA GPU.

    python3 tools/kernel_ab.py OTHER       # OTHER: the root of a checkout

Builds ``csrc/decode_attention.cu``, ``csrc/flash_attention.cu``,
``csrc/gqa_decode_attention.cu`` and ``examples/custom_kernel_torch/
fmha.cu`` of OTHER into ``build/ab/`` (each with the ctypes signatures of
OTHER's ``ops/_build.py``) and times, with CUDA events behind a spin as
``chip_smoke.py`` does, their entries at the paths' shapes: the beam entry
of kernel 1 (beam 5, 20 heads of 64, bf16 S 448 at sequence 44, 32 layers
rotating), kernel 2's fp32 entry ([1,20,1536,64], valid 1500) and its
causal mode ([1,20,227,64] bf16), kernel 2's bf16 non-causal entry
([1,20,1536,64], valid 1500), the user FMHA's fp32 and bf16 entries
([1,20,1536,64] valid 1500; bf16 also [1,20,3,64] causal) and the grouped
kernel at the decoder path's shape (batch 8, one KV head under 16 query
heads of 128, S 84, sequence 70, start 4, 24 layers rotating), with an
int8 and a bf16 cache.  Each is timed four times, OTHER, this, this,
OTHER, so that a drift of the card shows.  Compare two versions only
within one run.
"""
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
                        "gqa_decode_attention")}
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
    spec = importlib.util.spec_from_file_location(
        f"_build_of_{abs(hash(root))}",
        os.path.join(root, "eddie_wang_hackathon2023_tpu_torch", "ops",
                     "_build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SIGNATURES[name]


def libraries(torch_build, roots):
    """{tag: {name: library}} for each checkout {tag: root}: every source
    built into build/ab/<tag>/, one nvcc each, all started together, and
    loaded with that checkout's ctypes signatures."""
    procs = {}
    for tag, root in roots.items():
        out = os.path.join(HERE, "build", "ab", tag)
        os.makedirs(out, exist_ok=True)
        for name, src in SOURCES.items():
            lib_path = os.path.join(out, f"lib{name}.so")
            procs[tag, name] = (lib_path, subprocess.Popen(
                ["/usr/local/cuda/bin/nvcc", *torch_build.NVCC_FLAGS, "-o",
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
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or not os.path.isdir(os.path.join(argv[0], CSRC)):
        print("usage: kernel_ab.py OTHER_CHECKOUT", file=sys.stderr)
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
    spec = importlib.util.spec_from_file_location(
        "fmha_cuda", os.path.join(HERE, "examples", "custom_kernel_torch",
                                  "fmha_cuda.py"))
    ck = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ck)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = libraries(_build, {"other": argv[0], "this": HERE})
    dev = torch.device("cuda")
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

    def beam(lib, i):
        return lib["decode_attention"].beam_decode_attention(
            q.data_ptr(), cache.data_ptr(), 0, i % L, bw, H, D, S,
            seq.data_ptr(), None, None, D ** -0.5, fk.data_ptr(),
            fv.data_ptr(), ind.data_ptr(), bw, ctx.data_ptr(), stream())

    def flash_operands(lq, dtype):
        qkv = torch.randn(1, lq, 3, H, D, generator=g, device=dev).to(dtype)
        t = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
        t.append(torch.empty(1, H, lq, D, dtype=dtype, device=dev))
        strides = (ctypes.c_longlong * 12)(
            *[s for x in t for s in x.stride()[:3]])
        return t, strides

    def flash(entry, operands, lq, valid, causal, name="flash_attention"):
        (tq, tk, tv, to), strides = operands
        plan = ck.fmha_plan(lq, tq.dtype)

        def run(lib, i):
            fn = getattr(lib[name], entry)
            # the user FMHA takes the wrapper's plan after `causal` where
            # the checkout's signature has it
            extra = ([plan["warps"], plan["row_blocks"]]
                     if len(fn.argtypes) == 16 else [])
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

        def run(lib, i):
            fn = lib["gqa_decode_attention"].gqa_decode_attention
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
    for what, fn in cases:
        times = []
        for who in ("other", "this", "this", "other"):
            if fn(libs[who], 0) != 0:
                raise RuntimeError(f"{what}: {who}'s launch failed")
            ms, _ = smoke.time_ms(torch, lambda i, who=who: fn(libs[who], i))
            times.append(f"{who} {ms * 1e3:.2f}")
        print(f"{what}: " + ", ".join(times) + " us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
