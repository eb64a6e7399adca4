"""The multi-rank dry run: the port's counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``.

    python -m eddie_wang_hackathon2023_tpu_torch.parallel.dryrun 4 \\
        [--device cpu --backend gloo] [--layers N]

spawns N ranks (:func:`.mapping.spawn_ranks`) and, on each, with N split
as dp x tp (tp dividing the tiny model's 4 heads, the JAX choice):

* a tiny Whisper (vocab padded to a multiple of tp) sharded dp x tp: the
  encoder and the cross K/V on the rank's part of a batch of 2 dp rows,
  then one decode step, its logits' and cache's shapes checked;
* the same decoder weight-only int8 (``woq8``), one step;
* Whisper large-v2's decoder at full width with ``woq8+kv8`` (zero
  weights, 32 layers unless ``n_layer`` cuts them), two decode steps on
  its rank's batch row, layer by layer: the megakernel is structurally
  eligible unsharded and gated off once sharded (tp > 1);
* one serving tick (a tiny GPT-2-class model behind
  ``ContinuousBatchingManager``) at tp.

Every rank prints nothing; rank 0's OK line is printed and returned.  The
ranks run on the card unless ``device`` says otherwise; ``backend``
defaults to ``nccl``, which takes one card a rank (ask for ``gloo`` to
put several ranks on one card or on the CPU).  Imports no jax.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch


def _jax_layout_zeros_or_normal(module, rng=None, scale=0.05):
    """A state for ``module`` in the JAX layout (per-layer tensors stacked
    ``[n_layer, ...]``): seeded normals (float tensors) or zeros."""
    per = {}
    for k, v in module.state_dict().items():
        shape = tuple(v.shape)
        dt = {torch.int8: np.int8}.get(v.dtype, np.float32)
        if rng is None or dt == np.int8:
            arr = np.zeros(shape, dt)
        else:
            arr = (rng.standard_normal(shape) * scale).astype(np.float32)
        if k.startswith("blocks."):
            _, i, rest = k.split(".", 2)
            per.setdefault("blocks." + rest, []).append(arr)
        else:
            per[k] = arr
    return {k: np.stack(v) if isinstance(v, list) else v
            for k, v in per.items()}


def _cross_state(config, rng):
    d, n = config.n_text_state, config.n_text_layer
    w = (rng.standard_normal((n, 2, d, d)) * 0.05).astype(np.float32)
    return {"blocks.k_linear.weight": w[:, 0],
            "blocks.v_linear.weight": w[:, 1],
            "blocks.v_linear.bias": (rng.standard_normal((n, d)) * 0.05)
            .astype(np.float32)}


def tiny_config(heads: int = 4, vocab_pad_multiple: int = 1,
                head_dim: int = 16, dtype: str = "float32"):
    """The JAX dry run's ``_tiny_config`` (heads of 16, fp32); on a card
    heads of 64 in bf16, which the kernels take."""
    from ..models.whisper import WhisperConfig
    return WhisperConfig(n_mels=80, n_vocab=51865, n_audio_ctx=32,
                         n_audio_state=head_dim * heads, n_audio_head=heads,
                         n_audio_layer=2, n_text_ctx=32,
                         n_text_state=head_dim * heads, n_text_head=heads,
                         n_text_layer=2, dtype=dtype,
                         vocab_pad_multiple=vocab_pad_multiple)


@torch.inference_mode()
def _dryrun_rank(rank, world, device, n_layer):
    from ..models.decoder import DecoderConfig, DecoderLMHead
    from ..models.decoder_convert import from_jax_state as dec_from_jax
    from ..models.whisper import from_jax_state, whisper_config
    from ..models.whisper.convert import quantize_states
    from ..models.whisper.model import WhisperDecoder, WhisperEncoder
    from ..models._state import unstack_blocks
    from ..quantization.mode import QuantMode
    from ..runtime.batch_manager import (ContinuousBatchingManager,
                                         InferenceRequest)
    from ..runtime.sampling import SamplingConfig
    from .mapping import Mapping
    from .sharding import parallelize, shard_state

    tp = next(c for c in (4, 2, 1) if world % c == 0 and 4 % c == 0)
    dp = world // tp
    m = Mapping(tp_size=tp, dp_size=dp)
    dev = torch.device(device)
    # the kernels take bf16 and heads of 64 on a card
    on_card = dev.type == "cuda"
    dtype = "bfloat16" if on_card else "float32"
    hd = 64 if on_card else 16

    # ---- the tiny sharded decode step ----
    config = tiny_config(vocab_pad_multiple=tp, head_dim=hd, dtype=dtype)
    with torch.device("meta"):
        shapes = (WhisperEncoder(config), WhisperDecoder(config))
    enc_s, dec_s = (_jax_layout_zeros_or_normal(
        mod, np.random.default_rng(seed)) for mod, seed in zip(shapes,
                                                              (1, 0)))
    ckv_s = _cross_state(config, np.random.default_rng(2))
    enc, dec, ckv = from_jax_state(enc_s, dec_s, ckv_s, config, device=dev,
                                   mapping=m)
    b = dp * 2
    mel = np.random.RandomState(0).randn(
        b, config.n_mels, config.n_audio_ctx * 2).astype(np.float32)
    mine = slice(m.dp_rank * 2, m.dp_rank * 2 + 2)
    cross = ckv(enc(torch.from_numpy(mel[mine]).to(dev,
                                                   enc.conv1.weight.dtype)))
    cache = dec.new_kv_cache(2)
    tokens = torch.full((2, 1), 7, dtype=torch.long, device=dev)
    seq = torch.ones((2,), dtype=torch.int32, device=dev)
    logits, new_cache = dec(tokens, cache, cross, 0, seq)
    h = config.n_text_head // tp
    assert logits.shape == (2, 1, config.n_vocab), logits.shape
    assert new_cache.shape == (config.n_text_layer, 2, 2, h,
                               config.head_dim, config.n_text_ctx)
    assert bool(torch.isfinite(logits).all())

    # ---- the weight-only int8 decoder on the same layout ----
    recipe = "woq8"
    _, qdec_s, _ = quantize_states({}, dec_s, {}, recipe)
    with torch.device(dev):
        qdec = WhisperDecoder(config, QuantMode.use_weight_only(False))
    parallelize(qdec, m)
    qdec.load_state_dict(unstack_blocks(shard_state(qdec_s, qdec)))
    qlogits, _ = qdec(tokens, qdec.new_kv_cache(2), cross, 0, seq)
    assert qlogits.shape == (2, 1, config.n_vocab)

    # ---- large-v2's decoder at full width, woq8+kv8, zero weights ----
    lv2 = dataclasses.replace(whisper_config("large-v2", dtype="bfloat16"),
                              vocab_pad_multiple=tp)
    if n_layer:
        lv2 = dataclasses.replace(lv2, n_text_layer=n_layer)
    mode = QuantMode.use_weight_only(False).set_int8_kv_cache()
    with torch.device("meta"):
        whole = WhisperDecoder(lv2, mode)
    structural = whole.megakernel_eligible(torch.device("cpu"))
    bstate = _jax_layout_zeros_or_normal(whole)
    bstate["blocks.attn.kv_orig_quant_scale"] = np.full(
        (lv2.n_text_layer, 1), 8.0, np.float32)
    bstate["blocks.attn.kv_quant_orig_scale"] = np.full(
        (lv2.n_text_layer, 1), 1 / 8.0, np.float32)
    with torch.device(dev):
        big = WhisperDecoder(lv2, mode)
    parallelize(big, m)
    big.load_state_dict(unstack_blocks(shard_state(bstate, big)))
    del bstate
    gated = not big.megakernel_eligible()
    assert structural, "large-v2 woq8+kv8 is megakernel-eligible unsharded"
    assert gated or tp == 1, "a sharded decoder takes no megakernel"
    hb = lv2.n_text_head // tp
    bcross = (torch.zeros((lv2.n_text_layer, 1, 2, hb, lv2.head_dim,
                           lv2.n_audio_ctx), dtype=torch.int8, device=dev),
              torch.ones((lv2.n_text_layer,), device=dev))
    bcache = big.new_kv_cache(1)
    btok = torch.full((1, 1), 7, dtype=torch.long, device=dev)
    for step in range(2):
        blogits, bcache = big(btok, bcache, bcross, step,
                              torch.full((1,), step + 1, dtype=torch.int32,
                                         device=dev))
    assert blogits.shape == (1, 1, lv2.n_vocab)
    assert bool(torch.isfinite(blogits).all())
    del big, bcache, bcross

    # ---- one serving tick at tp ----
    gcfg = DecoderConfig(vocab_size=96, hidden_size=4 * hd, num_layers=2,
                         num_heads=4, max_position_embeddings=64,
                         dtype=dtype)
    with torch.device("meta"):
        gshape = DecoderLMHead(gcfg)
    gstate = _jax_layout_zeros_or_normal(gshape, np.random.default_rng(3),
                                         0.2)
    gmodel = dec_from_jax(gstate, gcfg, device=dev, mapping=m)
    served = {}
    reqs = [InferenceRequest(0, np.asarray([5, 11, 17], np.int32),
                             max_new_tokens=4, end_id=95)]
    ContinuousBatchingManager(
        gmodel, SamplingConfig(end_id=95, pad_id=95), max_batch_size=2,
        max_seq_len=64, device=dev,
        get_inference_requests=lambda n: [reqs.pop(0)] if reqs else [],
        send_response=lambda r: served.__setitem__(r.request_id,
                                                   r.output_ids)
        if r.finished else None).run()
    assert 0 in served

    return (f"dryrun_multichip OK: dp={dp} x tp={tp} ranks "
            f"({torch.distributed.get_backend()} on {dev.type}), tiny "
            f"logits {tuple(logits.shape)} a dp rank, cache "
            f"{tuple(new_cache.shape)} a rank, woq-int8 step OK; large-v2 "
            f"{lv2.n_text_layer}L/d{lv2.n_text_state}/h{lv2.n_text_head} "
            f"woq8+kv8 2 decode steps on dp{dp}xtp{tp}, kernel path=layer "
            f"by layer (megakernel structurally eligible, sharded weights "
            f"gate it off), logits {tuple(blogits.shape)} a dp rank; "
            f"serving tick tp{tp} OK")


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: str = "nccl",
                     n_layer: Optional[int] = None) -> str:
    """Run the dry run on ``n_devices`` spawned ranks (``device`` "cuda",
    the default, or "cpu"; ``backend`` default ``nccl``) and return (and
    print) rank 0's OK line."""
    from .mapping import spawn_ranks
    line = spawn_ranks(_dryrun_rank, n_devices, n_layer, backend=backend,
                       device=device)[0]
    print(line)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", default="nccl",
                    help="nccl (default) or gloo")
    ap.add_argument("--layers", type=int, default=None,
                    help="large-v2 decoder layers (default: all 32)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device, args.backend, args.layers)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
