#!/usr/bin/env python3
"""This checkout's attention kernels against another checkout's, in turns
on one NVIDIA GPU.

    python3 tools/kernel_ab.py OTHER       # OTHER: the root of a checkout

Builds ``csrc/decode_attention.cu`` and ``csrc/flash_attention.cu`` of
OTHER into ``build/ab/`` and times, with CUDA events behind a spin as
``chip_smoke.py`` does, the entries whose C interface both checkouts share
at the paths' shapes: the beam entry of kernel 1 (beam 5, 20 heads of 64,
bf16 S 448 at sequence 44, 32 layers rotating), kernel 2's fp32 entry
([1,20,1536,64], valid 1500) and its causal mode ([1,20,227,64] bf16), and
kernel 2's bf16 non-causal entry ([1,20,1536,64], valid 1500).  Each is
timed four times, OTHER, this, this, OTHER, so that a drift of the card
shows.  Compare two versions only within one run.
"""
import ctypes
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
CSRC = os.path.join("eddie_wang_hackathon2023_tpu_torch", "csrc")


def other_library(torch_build, root, name):
    """OTHER's csrc/<name>.cu built into build/ab/, with this checkout's
    ctypes signatures for the entries it has."""
    out = os.path.join(HERE, "build", "ab")
    os.makedirs(out, exist_ok=True)
    lib_path = os.path.join(out, f"lib{name}.so")
    subprocess.run(["/usr/local/cuda/bin/nvcc", *torch_build.NVCC_FLAGS,
                    "-o", lib_path, os.path.join(root, CSRC, f"{name}.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    for fn, args in torch_build.SIGNATURES[name].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = args
    return lib


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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = {"other": {n: other_library(_build, argv[0], n)
                      for n in ("decode_attention", "flash_attention")},
            "this": {n: _build.load(n)
                     for n in ("decode_attention", "flash_attention")}}
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

    def flash(entry, operands, lq, valid, causal):
        (tq, tk, tv, to), strides = operands

        def run(lib, i):
            return getattr(lib["flash_attention"], entry)(
                tq.data_ptr(), tk.data_ptr(), tv.data_ptr(), to.data_ptr(),
                1, H, lq, lq, D, valid, causal,
                ctypes.cast(strides, ctypes.c_void_p), D ** -0.5, stream())
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
