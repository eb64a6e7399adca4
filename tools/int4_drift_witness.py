#!/usr/bin/env python3
"""Where the int4 megakernel's 32-layer gap on every byte value comes
from, on a machine with a card.

    python3 tools/int4_drift_witness.py

Whisper large-v2's 32 decoder layers (d 1280, int4 panels in groups of
128, ``chip_smoke.py``'s seeded blobs, its step: a bf16 self cache of 448
at sequence 44, an int8 cross cache of 1500) for three kinds of int4
values: the quantiser's [-7, 7], every byte value (mean -0.5), and every
byte value with each column's scales of a random sign (mean zero).  For
each it runs the megakernel, its plain version in bf16 (the gate's
reference) and the plain version in fp32 (no bf16 rounding of the
activations, the scales or the dequantised weights), and prints the
relative errors of the hidden state and the fresh K/V between each pair,
with the fp32 hidden state's mean and largest magnitude.  Where the plain
bf16 version is as far from the fp32 one as the kernel is from the plain
bf16 version, the gap is bf16's rounding of a drifting residual stream,
not the kernel.
"""
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    import torch
    if not torch.cuda.is_available():
        print("int4_drift_witness: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from eddie_wang_hackathon2023_tpu_torch.ops import decoder_layer as mk
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    L, H, D, d, S, Sc, n = 32, 20, 64, 1280, 448, 1500, 44
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    x = torch.randn((1, d), generator=gen, device=dev).bfloat16()
    self16 = torch.randn((L, 1, 2, H, D, S), generator=gen,
                         device=dev).bfloat16()
    cross = torch.randint(-127, 128, (L, 1, 2, H, D, Sc), generator=gen,
                          device=dev, dtype=torch.int8)
    cscale = torch.full((L,), 1 / 40.0, device=dev)
    seq = torch.tensor([n], dtype=torch.int32, device=dev)
    rel = smoke.rel_err
    for values in ("quantiser", "bytes", "bytes_zero_mean"):
        blobs = smoke.random_whisper_blobs(torch, dev, gen, L, d, "int4",
                                           values=values)
        hid, fresh = mk.fused_decoder_stack(x, blobs, self16, seq, D ** -0.5,
                                            cross_cache=cross,
                                            cross_scale=cscale)
        plain = {adt: mk.plain_fused_decoder_stack(
            x.to(adt), blobs, self16, seq.cpu(), D ** -0.5, cross, cscale)
            for adt in (torch.bfloat16, torch.float32)}
        torch.cuda.synchronize()
        (h16, f16), (h32, f32) = plain[torch.bfloat16], plain[torch.float32]
        row = {
            "kernel_vs_plain_bf16": [rel(hid, h16), rel(fresh, f16)],
            "plain_bf16_vs_plain_fp32": [rel(h16, h32), rel(f16, f32)],
            "kernel_vs_plain_fp32": [rel(hid, h32), rel(fresh, f32)],
            "fp32_hidden_mean": float(h32.float().mean()),
            "fp32_hidden_max_abs": float(h32.float().abs().max()),
        }
        print(f"int4 values {values}: " + ", ".join(
            f"{k} " + (" / ".join(f"{e:.4f}" for e in v)
                       if isinstance(v, list) else f"{v:.3f}")
            for k, v in row.items()) + "  (hidden / fresh K/V)")
        del blobs, plain
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
