"""Rank-side functions of the port's tensor/data/sequence-parallel tests.

Each runs in a rank spawned by ``parallel.spawn_ranks`` (gloo, one
thread), with ``torch.distributed`` initialised.  A spawned rank imports
the module that holds its target, so this module imports neither jax nor
the JAX package.  :func:`bundle` runs several jobs in one spawn, each with
its own ``Mapping``, so that a test module spawns each world size once.
"""
import numpy as np
import torch


def _mapping(layout):
    from eddie_wang_hackathon2023_tpu_torch.parallel import Mapping
    dp, tp = layout
    return Mapping(dp_size=dp, tp_size=tp)


def bundle(rank, world, device, jobs):
    """[(job name, kwargs), ...] -> [each job's result]."""
    return [globals()[name](device=device, **kw) for name, kw in jobs]


@torch.inference_mode()
def whisper_logits(device, cfg, states, recipe, mel, tokens, layout,
                   steps=((7, 8),)):
    """The prompt's logits and one step's on this rank's part of the batch
    (the dp rank's rows), on the rank's shard of the Whisper modules."""
    from eddie_wang_hackathon2023_tpu_torch.models.whisper import \
        from_jax_state
    m = _mapping(layout)
    enc, dec, ckv = from_jax_state(*states, cfg, recipe=recipe,
                                   device=device, mapping=m)
    b = mel.shape[0] // m.dp_size
    rows = slice(m.dp_rank * b, (m.dp_rank + 1) * b)
    xa = enc(torch.from_numpy(mel[rows]))
    cross = ckv(xa)
    cache = dec.new_kv_cache(b)
    t = tokens.shape[1]
    tok = torch.from_numpy(tokens[rows]).long()
    lg, cache = dec(tok, cache, cross, 0, torch.full((b,), t,
                                                     dtype=torch.int32))
    step = torch.tensor([list(steps[0])], dtype=torch.long).t()[rows]
    sl, _ = dec(step, cache, cross, t, torch.full((b,), t + 1,
                                                  dtype=torch.int32))
    return dict(dp_rank=m.dp_rank, tp_rank=m.tp_rank,
                logits=lg.numpy(), step=sl.numpy(),
                cache_heads=int(cache.shape[3]),
                cross_heads=int((cross[0] if isinstance(cross, tuple)
                                 else cross).shape[3]),
                megakernel=dec.megakernel_eligible())


@torch.inference_mode()
def whisper_transcribe(device, cfg, states, mel, layout, decode_megakernel,
                       sample_len=8):
    """Greedy transcription of the batch ``mel`` through the rank's shard
    (the data-parallel ranks each take their part; every rank returns
    every row's tokens), and whether the pipeline packed megakernel
    blobs."""
    from eddie_wang_hackathon2023_tpu_torch.models.whisper import \
        from_jax_state
    from eddie_wang_hackathon2023_tpu_torch.models.whisper.pipeline import (
        DecodingOptions, WhisperPipeline)
    m = _mapping(layout)
    enc, dec, ckv = from_jax_state(*states, cfg, device=device, mapping=m)
    pipe = WhisperPipeline(cfg, enc, dec, ckv, DecodingOptions(
        language="en", sample_len=sample_len),
        decode_megakernel=decode_megakernel)
    res = pipe.transcribe(mel)
    return dict(tokens=[r.tokens for r in res],
                blobs=pipe._mk_blobs is not None)


@torch.inference_mode()
def whisper_decoder_logits(device, cfg, dec_state, cross, recipe, tokens,
                           layout):
    """The decoder alone (woq Whisper at dp x tp) on a given cross K/V."""
    from eddie_wang_hackathon2023_tpu_torch.models._state import \
        unstack_blocks
    from eddie_wang_hackathon2023_tpu_torch.models.whisper import Recipe
    from eddie_wang_hackathon2023_tpu_torch.models.whisper.model import \
        WhisperDecoder
    from eddie_wang_hackathon2023_tpu_torch.parallel import (parallelize,
                                                             shard_state)
    m = _mapping(layout)
    r = Recipe.parse(recipe)
    dec = WhisperDecoder(cfg, r.decoder, quantize_lm_head=r.lm_head)
    parallelize(dec, m)
    dec.load_state_dict(unstack_blocks(shard_state(dec_state, dec)))
    b = tokens.shape[0] // m.dp_size
    rows = slice(m.dp_rank * b, (m.dp_rank + 1) * b)
    ca = dec.blocks[0].cross_attn
    cr = torch.from_numpy(cross[:, rows, :, ca.head_offset:
                                ca.head_offset + ca.num_attention_heads])
    lg, _ = dec(torch.from_numpy(tokens[rows]).long(), dec.new_kv_cache(b),
                cr, 0, torch.full((b,), tokens.shape[1], dtype=torch.int32))
    return dict(dp_rank=m.dp_rank, logits=lg.numpy(),
                vocab_rows=int(dec.token_embedding.weight.shape[0]))


@torch.inference_mode()
def generate(device, cfg, state, prompt, lens, max_new, layout, end_id,
             decode_megakernel=False):
    """``GenerationSession.decode`` greedy on the rank's shard; whether it
    packed megakernel blobs."""
    from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import \
        from_jax_state
    from eddie_wang_hackathon2023_tpu_torch.runtime import (
        GenerationSession, ModelConfig, SamplingConfig)
    m = _mapping(layout)
    model = from_jax_state(state, cfg, device=device, mapping=m)
    mc = ModelConfig(vocab_size=cfg.vocab_size, num_layers=cfg.num_layers,
                     num_heads=cfg.num_heads, hidden_size=cfg.hidden_size,
                     max_seq_len=64, num_kv_heads=cfg.num_kv_heads)
    sess = GenerationSession(mc, model, SamplingConfig(end_id=end_id,
                                                       pad_id=end_id),
                             decode_megakernel=decode_megakernel)
    toks, out_lens, _ = sess.decode(prompt, lens, max_new_tokens=max_new)
    return dict(tokens=np.asarray(toks), lens=np.asarray(out_lens),
                blobs=sess._mk_blobs is not None,
                eligible=model.megakernel_eligible(),
                kv_heads=model.blocks[0].attention.num_attention_kv_heads,
                attn_tp=model.blocks[0].attention.tp is not None,
                mlp_tp=model.blocks[0].mlp.proj.tp is not None)


@torch.inference_mode()
def serve(device, cfg, state, prompts, layout, end_id, max_new=8, **kw):
    """{request id: output tokens} of a ``ContinuousBatchingManager`` drain
    on the rank's shard (staggered admission), and the pool's KV heads."""
    from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import \
        from_jax_state
    from eddie_wang_hackathon2023_tpu_torch.runtime.batch_manager import (
        ContinuousBatchingManager, InferenceRequest)
    from eddie_wang_hackathon2023_tpu_torch.runtime.sampling import \
        SamplingConfig
    m = _mapping(layout)
    model = from_jax_state(state, cfg, device=device, mapping=m)
    queue = [InferenceRequest(i, np.asarray(p, np.int32),
                              max_new_tokens=max_new, end_id=end_id)
             for i, p in enumerate(prompts)]
    results = {}

    def send(r):
        if r.finished:
            results[r.request_id] = [int(t) for t in r.output_ids]
    mgr = ContinuousBatchingManager(
        model, SamplingConfig(end_id=end_id, pad_id=end_id),
        max_batch_size=2, max_seq_len=64,
        get_inference_requests=lambda n: [queue.pop(0)] if queue else [],
        send_response=send, device=device, **kw)
    mgr.run()
    heads = (mgr.pool.shape[3] if getattr(mgr, "pool", None) is not None
             else mgr.cache.shape[3])
    return dict(results=results, kv_heads=int(heads))


@torch.inference_mode()
def fp8_pair(device, state, x, layout):
    """An FP8Linear (16 -> 32, column-parallel, not gathered) then an
    FP8RowLinear (32 -> 16, row-parallel) on the rank's shard: the JAX
    FP8 test's pair."""
    from eddie_wang_hackathon2023_tpu_torch.parallel.sharding import \
        shard_linear, shard_state
    from eddie_wang_hackathon2023_tpu_torch.quantization.fp8_layers import (
        FP8Linear, FP8RowLinear)
    m = _mapping(layout)
    pair = torch.nn.Module()
    pair.col, pair.row = FP8Linear(16, 32), FP8RowLinear(32, 16)
    shard_linear(pair.col, m.tp, "col")
    shard_linear(pair.row, m.tp, "row")
    pair.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in shard_state(state, pair).items()})
    return pair.row(pair.col(torch.from_numpy(x))).numpy()


@torch.inference_mode()
def ring(device, q, k, v, causal):
    """This rank's rows of ``ring_attention`` over the world, and the
    rows of the K/V shard it held."""
    from eddie_wang_hackathon2023_tpu_torch.ops.ring_attention import \
        ring_attention
    m = _mapping((1, torch.distributed.get_world_size()))
    n = q.shape[2] // m.tp_size
    rows = slice(m.tp_rank * n, (m.tp_rank + 1) * n)
    ks = torch.from_numpy(k[:, :, rows])
    out = ring_attention(torch.from_numpy(q[:, :, rows]), ks,
                         torch.from_numpy(v[:, :, rows]), m.tp,
                         causal=causal)
    return dict(out=out.numpy(), kv_rows=int(ks.shape[2]))
