#!/usr/bin/env python3
"""The pair-layout out-projection probe on one NVIDIA GPU: the PyTorch
counterpart of ``benchmarks/megakernel_probe3.py``.

    python3 tools/megakernel_probe3.py                # on the card
    python3 tools/megakernel_probe3.py --device cpu   # the plain versions

The same data as the JAX script (``np.random.RandomState(0)``, in its
order): NP = 128 int8 panels [1280, 1280] (210 MB) and the attention
context in pair layout, ctx [HP 10, DL 128] fp32.  Modes, in the order
the JAX script's ``main()`` runs them, all through ``probe_pair_proj``:

  pair_loop  - HP partials bf16(ctx[p]) . W_i[128 p : 128 p + 128] in fp32,
               added in order of p (one slice of K per pair)
  flat_f32   - bf16(ctx reshaped to [1, 1280]) . W_i
  flat_bf16  - ctx cast to bf16, then reshaped: the same values

(its fourth mode, ``gemv``, is not run by ``main()``, as in the JAX
script).  For each: ms a call (CUDA events behind a spin, as
``chip_smoke.py`` times kernels), GB/s over the int8 bytes, µs a panel and
the byte bound; the output is held within one bf16 step of the plain
version.  With ``--device cpu`` it runs the plain versions and times
nothing.
"""
import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

D = 1280
HP, DL = 10, 128
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
        print("megakernel_probe3: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(args.device)

    t = time.perf_counter()
    rs = np.random.RandomState(0)
    blob = torch.from_numpy(
        rs.randint(-127, 128, (NP, D, D)).astype(np.int8)).to(dev)
    ctx = torch.from_numpy((rs.randn(HP, DL) * 0.1).astype(np.float32)).to(
        dev)
    print(f"data (seeded numpy draws, {blob.numel() / 1e6:.1f} MB of int8): "
          f"{time.perf_counter() - t:.1f} s")
    run = mp.variant_runner(args.device, NP * D * D, "megakernel_probe3",
                            smoke)
    # bytes: the int8 panels, the fp32 context and the bf16 output
    n_bytes = NP * D * D + HP * DL * 4 + NP * D * 2
    for mode in ("pair_loop", "flat_f32", "flat_bf16"):
        ref = mp.plain_probe_pair_proj(blob, ctx, mode)
        run(mode, lambda: mp.probe_pair_proj(blob, ctx, mode), NP, n_bytes,
            ref)
        del ref
    return run.finish()


if __name__ == "__main__":
    sys.exit(main())
