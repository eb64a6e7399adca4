#!/usr/bin/env python3
"""Kernel 2's causal entry under every plan it takes, on one NVIDIA GPU.

    python3 tools/flash_causal_plans.py [OTHER]   # OTHER: another checkout

Times, with CUDA events behind a spin as ``chip_smoke.py`` does, the bf16
causal entry of ``csrc/flash_attention.cu`` at 64 rows a block with the
keys of each 16-row group over 1-4 warps (``splits``), at the custom path's
shape [1,20,227,64] and at shapes of other grids (Lq 128-1024, batch 1-8),
each against SDPA ``is_causal`` on the same inputs and, given OTHER, that
checkout's causal entry with its own plan (or none, where it takes none).
Marks the plan that ``ops/flash_attention.causal_plan`` picks.  Every plan
is first held within 1e-2 of the fp32 plain version.
"""
import ctypes
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

SHAPES = [(1, 20, 227), (1, 20, 128), (1, 20, 256), (1, 20, 448),
          (1, 20, 1024), (5, 20, 227), (8, 16, 128), (8, 20, 256)]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    import torch
    if not torch.cuda.is_available():
        print("flash_causal_plans: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from eddie_wang_hackathon2023_tpu_torch.ops import _build
    from eddie_wang_hackathon2023_tpu_torch.ops import flash_attention as fa
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    lib = _build.load("flash_attention").flash_attention
    other = None
    if argv:
        import kernel_ab
        other_libs = kernel_ab.libraries(_build, {"other": argv[0]})
        other = other_libs["other"]["flash_attention"].flash_attention
        other_plan = kernel_ab.defs_of(argv[0], os.path.join(
            kernel_ab.OPS, "flash_attention.py"),
            ("causal_plan",)).get("causal_plan")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def stream():
        return torch.cuda.current_stream().cuda_stream

    for b, h, L in SHAPES:
        x = torch.randn(b, L, 3, h, 64, generator=g, device=dev).bfloat16()
        q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
        o = torch.empty(b, h, L, 64, device=dev, dtype=torch.bfloat16)
        strides = (ctypes.c_longlong * 12)(
            *[s for t in (q, k, v, o) for s in t.stride()[:3]])
        ref = fa.plain_flash_mha(q.float(), k.float(), v.float(),
                                 causal=True, scale=0.125)

        def call(fn, plan):
            return lambda i: fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h,
                L, L, 64, L, 1, *plan, ctypes.cast(strides, ctypes.c_void_p),
                0.125, stream())

        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        lib_ms = smoke.time_ms(torch, lambda i: sdpa(
            qc, kc, vc, is_causal=True, scale=0.125))[0]
        row = [f"SDPA {lib_ms * 1e3:.2f}"]
        if other is not None:
            p = (other_plan(L, L, L, b * h, sms) if other_plan else None)
            fn = call(other, [p["rows"], p["splits"]] if p else [])
            if fn(0) != 0:
                raise RuntimeError("the other checkout's launch failed")
            row.append(f"other {smoke.time_ms(torch, fn)[0] * 1e3:.2f}")
        picked = fa.causal_plan(L, L, L, b * h, sms)["splits"]
        for splits in (1, 2, 3, 4):
            fn = call(lib, [64, splits])
            o.fill_(float("nan"))
            if fn(0) != 0:
                raise RuntimeError(f"splits {splits}: the launch failed")
            torch.cuda.synchronize()
            err = float((o.float() - ref).abs().max() / ref.abs().max())
            if not err < 1e-2:
                raise RuntimeError(f"splits {splits}: rel err {err:.3e}")
            ms = smoke.time_ms(torch, fn)[0]
            row.append(f"splits {splits}{'*' if splits == picked else ''} "
                       f"{ms * 1e3:.2f}")
        print(f"[{b},{h},{L},64]: " + ", ".join(row) + " us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
