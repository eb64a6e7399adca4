#!/usr/bin/env python3
"""The relayout probe on one NVIDIA GPU: the PyTorch counterpart of
``benchmarks/megakernel_probe2.py``.

    python3 tools/megakernel_probe2.py                # on the card
    python3 tools/megakernel_probe2.py --device cpu   # the plain versions

The same data as the JAX script (``np.random.RandomState(0)``, in its
order): NP = 128 int8 panels [1280, 1280] (210 MB), x [1, 1280] bf16 and
a KV tile [1, 20, 64, 128] bf16.  Modes, in the JAX script's order, both
through ``probe_relayout``:

  none     - the flat GEMV without a scale, out[i] = bf16(x . W_i)
  reshape  - that fp32 sum seen as q [20, 1, 64], its scores against the KV
             tile in fp32 and their total written to every column of the
             panel (the per-panel total is reduced in the same launch)

For each: ms a call (CUDA events behind a spin, as ``chip_smoke.py``
times kernels), GB/s over the int8 bytes, µs a panel and the byte bound;
the output is held against the plain version (``none`` within one bf16
step, ``reshape`` within 1e-2).  With ``--device cpu`` it runs the plain
versions and times nothing.
"""
import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

K = 1280
N = 1280
H, D = 20, 64
NP = 128


def main(argv=None, smoke=None):
    """Runs the variants; ``smoke``: the timing helpers' module (see
    ``megakernel_probes.variant_runner``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    import torch
    import megakernel_probes as mp
    if args.device == "cuda" and not torch.cuda.is_available():
        print("megakernel_probe2: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(args.device)

    t = time.perf_counter()
    rs = np.random.RandomState(0)
    blob = torch.from_numpy(
        rs.randint(-127, 128, (NP, K, N)).astype(np.int8)).to(dev)
    x = torch.from_numpy((rs.randn(1, K) * 0.1).astype(np.float32)).to(
        dev).bfloat16()
    kv = torch.from_numpy((rs.randn(1, H, D, 128) * 0.1).astype(
        np.float32)).to(dev).bfloat16()
    print(f"data (seeded numpy draws, {blob.numel() / 1e6:.1f} MB of int8): "
          f"{time.perf_counter() - t:.1f} s")
    run = mp.variant_runner(args.device, NP * K * N, "megakernel_probe2",
                            smoke)
    # bytes: the int8 panels, x, the KV tile (reshape) and the bf16 output
    for mode in ("none", "reshape"):
        n_bytes = NP * K * N + K * 2 + NP * N * 2 + (
            kv.numel() * 2 if mode == "reshape" else 0)
        ref = mp.plain_probe_relayout(blob, x, kv, mode)
        run(mode, lambda: mp.probe_relayout(blob, x, kv, mode), NP, n_bytes,
            ref, rtol=1e-2 if mode == "reshape" else 2 ** -7)
        del ref
    return run.finish()


if __name__ == "__main__":
    sys.exit(main())
