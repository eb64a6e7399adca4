#!/usr/bin/env python3
"""Where the user FMHA's fp32 entry (3xTF32) spends its time, on one
NVIDIA GPU.

    python3 tools/fmha_f32_probe.py

At the SmoothQuant encoder's shape, [1,20,1536,64] fp32 valid 1500 with
the wrapper's plan, builds copies of ``examples/custom_kernel_torch/
fmha.cu`` into ``build/probe/``, each changed by a text edit, and times
each twice with CUDA events behind a spin as ``chip_smoke.py`` does, with
its largest error against the fp32 plain version:
  * ``kernel``: the source as it is (tf32 terms by integer rounding);
  * ``cvt.rna``: the same terms by the ``cvt.rna.tf32.f32`` instruction;
  * ``1xTF32``: only the hi * hi product (a third of the tensor work);
  * ``no splits``: the operands go to the tensor core unrounded, both
    terms the operand itself (the loads, the softmax and three products
    without the conversions; its result is wrong).
"""
import ctypes
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
EXAMPLE = os.path.join(HERE, "examples", "custom_kernel_torch")
SOURCE = os.path.join(EXAMPLE, "fmha.cu")
B, H, L, VALID = 1, 20, 1536, 1500

SPLIT = ("  hi = rna_tf32(x);\n  lo = rna_tf32(x - __uint_as_float(hi));")
VARIANTS = {
    "kernel": [],
    "cvt.rna": [(SPLIT,
                 '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));\n'
                 '  const float rest = x - __uint_as_float(hi);\n'
                 '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));')],
    "1xTF32": [("  mma_tf32(c, a_lo, bh0, bh1);\n"
                "  mma_tf32(c, a_hi, bl0, bl1);\n", "")],
    "no splits": [(SPLIT, "  hi = __float_as_uint(x);\n  lo = hi;")],
}


def edited(text, pairs):
    for a, b in pairs:
        if a not in text:
            raise RuntimeError(f"the source has changed: {a[:60]!r}")
        text = text.replace(a, b, 1)
    return text


def main():
    import torch
    if not torch.cuda.is_available():
        print("fmha_f32_probe: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, EXAMPLE)
    import fmha_cuda
    from eddie_wang_hackathon2023_tpu_torch.ops import _build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    text = open(SOURCE).read()
    out = os.path.join(HERE, "build", "probe")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for i, (name, pairs) in enumerate(VARIANTS.items()):
        path = os.path.join(out, f"fmha_f32_{i}.cu")
        with open(path, "w") as f:
            f.write(edited(text, pairs))
        procs[name] = subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *_build.NVCC_FLAGS, "-o",
             path[:-3] + ".so", path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out, f"fmha_f32_{i}.so"))
        lib.custom_fmha_f32.argtypes = \
            _build.SIGNATURES["custom_fmha"]["custom_fmha_f32"]
        libs[name] = lib

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, L, 3, H, 64, generator=g, device=dev)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    o = torch.empty(B, H, L, 64, device=dev)
    strides = (ctypes.c_longlong * 12)(
        *[s for t in (q, k, v, o) for s in t.stride()[:3]])
    plan = fmha_cuda.fmha_plan(L, torch.float32)
    ref = fmha_cuda.plain_custom_flash_mha(q, k, v, scale=0.125,
                                           kv_valid_len=VALID)

    def call(lib):
        return lambda i: lib.custom_fmha_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, L,
            L, 64, VALID, 0, plan["warps"], plan["row_blocks"],
            ctypes.cast(strides, ctypes.c_void_p), 0.125,
            torch.cuda.current_stream().cuda_stream)

    print(f"[{B},{H},{L},64] fp32 valid {VALID}, plan {plan}:")
    for name, lib in libs.items():
        if call(lib)(0) != 0:
            raise RuntimeError(f"{name}: the launch failed")
        torch.cuda.synchronize()
        err = float((o - ref).abs().max() / ref.abs().max())
        times = [smoke.time_ms(torch, call(lib))[0] * 1e3 for _ in range(2)]
        print(f"  {name}: {times[0]:.2f}, {times[1]:.2f} us a call; rel err "
              f"{err:.2e} of the largest output")
    return 0


if __name__ == "__main__":
    sys.exit(main())
