#!/usr/bin/env python3
"""The flat and head-major dequant-GEMV probes on one NVIDIA GPU: the
PyTorch counterpart of ``benchmarks/megakernel_probe.py``.

    python3 tools/megakernel_probe.py                 # on the card
    python3 tools/megakernel_probe.py --device cpu    # the plain versions

The same data as the JAX script (``np.random.RandomState(0)``, drawn in its
order): a blob of NP = 128 int8 panels [1280, 1280] (210 MB, four times
the 50 MB L2), x [1, 1280] bf16, fp32 scales; then for rows 60 and 20 a
head-major blob [np_, rows, 1280, 64] of the same bytes.  Variants, in the
JAX script's order:

  torch  - the loop over the panels of cast, matmul in fp32 and scale
           (``torch_baseline_flat``, the counterpart of ``probe_xla``)
  flat   - the flat kernel (``probe_flat``), out[i] = bf16((x . W_i) s_i)
  hm60   - the head-major kernel (``probe_hm``) at rows 60, 42 panels
  hm20   - the same at rows 20, 128 panels

For each: ms a call (CUDA events around calls queued behind a spin, as
``chip_smoke.py`` times kernels), GB/s over the int8 bytes, µs a panel and
the byte bound; every kernel's output is held within one bf16 step of the
loop's (flat) or of its plain version (hm).  Then the flat kernel over
other items (columns x slices of K, and the megakernel's grid of one
block per SM): which item streams fastest.  With ``--device cpu`` it runs
the plain versions and times nothing.
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
NP = 128          # panels; 128 * 1.64 MB = 210 MB streamed
# the flat kernel's other items: (columns, slices of K, blocks: 0 a block
# an item, "sms" one block per SM, the megakernel's grid).  The first is
# the megakernel's own GEMV item on its own grid; "flat" above is the
# default item, 256 columns by the whole of K
ITEMS = ((32, 4, "sms"), (256, 1, "sms"), (32, 4, 0), (32, 1, 0),
         (64, 1, 0), (128, 1, 0), (256, 2, 0))


def main(argv=None, smoke=None):
    """Runs the variants; ``smoke``: the timing helpers' module (see
    ``megakernel_probes.variant_runner``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    import torch
    import megakernel_probes as mp
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("megakernel_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(args.device)

    t = time.perf_counter()
    rs = np.random.RandomState(0)
    blob = torch.from_numpy(
        rs.randint(-127, 128, (NP, K, N)).astype(np.int8)).to(dev)
    x = torch.from_numpy((rs.randn(1, K) * 0.1).astype(np.float32)).to(
        dev).bfloat16()
    scales = torch.from_numpy(
        rs.rand(NP, 1, N).astype(np.float32) * 0.01).to(dev)
    hm = {}
    for rows in (60, 20):
        np_ = mp.hm_panels(rows, NP, K, N)
        blob_hm = torch.from_numpy(
            rs.randint(-127, 128, (np_, rows, K, 64)).astype(np.int8)).to(dev)
        s_hm = torch.from_numpy(rs.rand(np_, rows, 64).astype(np.float32)).to(
            dev)
        hm[rows] = (np_, blob_hm, x[None].expand(rows, 1, K).contiguous(),
                    s_hm)
    int8_mb = (blob.numel() + sum(v[1].numel() for v in hm.values())) / 1e6
    print(f"data (seeded numpy draws, {int8_mb:.1f} MB of int8 in all): "
          f"{time.perf_counter() - t:.1f} s")
    run = mp.variant_runner(args.device, NP * K * N, "megakernel_probe",
                            smoke)

    # bytes: the int8 panels, the fp32 scales, x and the bf16 output
    flat_bytes = NP * K * N + NP * N * 4 + K * 2 + NP * N * 2
    ref = run("torch", lambda: mp.torch_baseline_flat(blob, x, scales), NP,
              flat_bytes, iters=1)
    run("flat", lambda: mp.probe_flat(blob, x, scales), NP, flat_bytes, ref)
    for rows, tag in ((60, "hm60"), (20, "hm20")):
        np_, blob_hm, xb, s_hm = hm[rows]
        ref_hm = mp.plain_probe_hm(blob_hm, xb, s_hm)
        hm_bytes = blob_hm.numel() + s_hm.numel() * 6 + rows * K * 2
        run(tag, lambda: mp.probe_hm(blob_hm, xb, s_hm), np_, hm_bytes,
            ref_hm)
        del ref_hm
    if on_card:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        print("the flat kernel by item (columns x rows of K; grid):")
        for cols, ksplit, blocks in ITEMS:
            grid = sms if blocks == "sms" else blocks
            tag = f"{cols}x{K // ksplit}" + (f" g{grid}" if grid else "")
            run(tag, lambda: mp.probe_flat(blob, x, scales, cols=cols,
                                           ksplit=ksplit, blocks=grid),
                NP, flat_bytes, ref)
    return run.finish()


if __name__ == "__main__":
    sys.exit(main())
