#!/usr/bin/env python3
"""This checkout's greedy generation loop against another checkout's, in
turns on one NVIDIA GPU, at ``chip_smoke.py``'s decoder path.

    python3 tools/loop_ab.py OTHER       # OTHER: the root of a checkout
    python3 tools/loop_ab.py OTHER --device cpu --tiny     # a rehearsal

Builds SantaCoder-1B (``chip_smoke.py``'s seeded random float state, one
for both recipes) under int8 weight-only (``woq8``) and int4 weight-only
(``woq4``) with this checkout's package, and drives each model through
this checkout's ``GenerationSession`` and through OTHER's: OTHER's
package is imported under another name, and only its runtime (the
session's loop and its sampling step) runs, on this checkout's model and
kernels.  Greedy, as the decoder path runs it: DEC_BATCH prompts of
DEC_PROMPT tokens, DEC_NEW new tokens, the end id outside the vocab.  The
loops are timed in ROUNDS rounds of four whole calls on the same prompts,
OTHER, this, this, OTHER, each call from a synchronised start to a
synchronised end, so that a drift of the card or the host falls on both;
the two loops' tokens must be equal.  Prints the card's name and power
limit, each loop's best, median and mean ms a call, the distance between
its quartiles and tokens/s at the median, how many of the 2 x ROUNDS pairs
of neighbouring calls (OTHER, this; this, OTHER) this loop won, and one
JSON line with every call's time.  Compare two versions only within one
run.
"""
import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
PKG = "eddie_wang_hackathon2023_tpu_torch"
OTHER_PKG = "other_checkout_port"
ROUNDS = 10


def load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def load_other_runtime(root):
    """OTHER's ``runtime`` package, its package imported as OTHER_PKG (the
    port imports its own modules relatively)."""
    pkg_dir = os.path.join(os.path.abspath(root), PKG)
    spec = importlib.util.spec_from_file_location(
        OTHER_PKG, os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[OTHER_PKG] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(OTHER_PKG + ".runtime")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("other")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="2 layers of width 256, vocab 97 (a CPU rehearsal)")
    args = p.parse_args(argv)
    import numpy as np
    import torch

    from eddie_wang_hackathon2023_tpu_torch import runtime as this_rt
    from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import (
        from_jax_state, quantize_state)
    from eddie_wang_hackathon2023_tpu_torch.quantization import QuantMode
    smoke = load_smoke()
    other_rt = load_other_runtime(args.other)
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0])

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg = smoke.santacoder_1b_config()
    if args.tiny:
        cfg = dataclasses.replace(cfg, vocab_size=97, hidden_size=256,
                                  num_layers=2, num_heads=2,
                                  max_position_embeddings=128)
    batch, plen, new = smoke.DEC_BATCH, smoke.DEC_PROMPT, smoke.DEC_NEW
    float_state = smoke.random_decoder_state(
        torch, np, cfg, np.random.default_rng(smoke.SEED))
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, plen)).astype(np.int32)
    lens = np.full((batch,), plen, np.int32)
    results = {}
    for recipe, mode in (("woq8", QuantMode.use_weight_only()),
                         ("woq4", QuantMode.use_weight_only(True))):
        c = dataclasses.replace(cfg, quant_mode=mode)
        model = from_jax_state(quantize_state(float_state, c), c,
                               device=device)
        sessions = {}
        for name, rt in (("other", other_rt), ("this", this_rt)):
            mc = rt.ModelConfig(
                vocab_size=c.vocab_size, num_layers=c.num_layers,
                num_heads=c.num_heads, hidden_size=c.hidden_size,
                max_seq_len=c.max_position_embeddings,
                num_kv_heads=c.num_kv_heads)
            sessions[name] = rt.GenerationSession(
                mc, model, rt.SamplingConfig(end_id=-1, pad_id=0))
        out = {name: s.decode(ids, lens, max_new_tokens=new)
               for name, s in sessions.items()}       # warm-up
        same = all(np.array_equal(a, b) for a, b in zip(out["other"],
                                                        out["this"]))
        ms = {"other": [], "this": []}
        for _ in range(ROUNDS):
            for name in ("other", "this", "this", "other"):
                sync()
                t = time.perf_counter()
                sessions[name].decode(ids, lens, max_new_tokens=new)
                sync()
                ms[name].append((time.perf_counter() - t) * 1e3)
        loops = {}
        for name, m in ms.items():
            med = statistics.median(m)
            q1, _, q3 = statistics.quantiles(m, n=4)
            loops[name] = dict(best_ms=min(m), median_ms=med,
                               mean_ms=statistics.mean(m), iqr_ms=q3 - q1,
                               tokens_per_s=batch * new / med * 1e3, ms=m)
            print(f"[{recipe}] {name:5s}: best {min(m):.2f}, median "
                  f"{med:.2f}, mean {statistics.mean(m):.2f}, quartiles "
                  f"{q3 - q1:.2f} apart, ms a call ({len(m)} calls), "
                  f"{batch * new / med * 1e3:.2f} tokens/s at the median")
        # each call of this loop against its neighbour of the other's
        wins = sum(t < o for t, o in zip(ms["this"], ms["other"]))
        ratio = loops["this"]["median_ms"] / loops["other"]["median_ms"]
        print(f"[{recipe}] this / other, median ms a call: {ratio:.4f}; "
              f"this loop won {wins} of {len(ms['this'])} pairs; the two "
              f"loops' tokens, lengths and log-probs equal: {same}")
        results[recipe] = dict(loops=loops, median_ratio=ratio,
                               pairs_won=wins, outputs_equal=same)
        del model, sessions
    print(json.dumps(dict(batch=batch, prompt_len=plen, new_tokens=new,
                          num_layers=cfg.num_layers, rounds=ROUNDS,
                          loop_ab=results)))
    return 0 if all(r["outputs_equal"] for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
