"""The port's tensor and data parallelism (``parallel/``) against the JAX
package's, on the CPU.

Each rank of the port is a process spawned by ``parallel.start_ranks``
(gloo, one thread) that holds only its shard and calls the collectives
itself; the JAX side runs in this process on the 8 virtual CPU devices of
``tests/conftest.py``, as ``tests/test_parallel.py`` runs it.  The rank
functions live in ``tests/torch_parallel_ranks.py`` (a spawned rank
imports the module of its target, which must not import jax); each world
size is spawned once (``ranks2``, ``ranks4``, ``ranks8``) with every job
of this module, the dry run and chip_smoke's rehearsal spawn their own.

The mirrors of ``tests/test_parallel.py`` take its configs and seeds; the
GPT-2 models are built from seeded numpy states of the JAX package's
``DecoderLMHead`` with GPT-2's config (vocab 96, d 32, 2 layers, 4 heads,
64 positions) where the JAX tests draw HF's initialiser from
``torch.manual_seed`` (transformers is not imported here).  Tolerances:
logits within 2e-3 of the JAX sharded and single-device runs (the JAX
tests' own), tokens exact, ``shard_state`` bit-equal to the JAX
``shard_state``'s addressable shard wherever both split a parameter the
same way (Whisper's ``mlp2`` is the one float parameter they split apart:
a column ``Linear`` in the JAX block, row-parallel here).
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_ranks as R
from eddie_wang_hackathon2023_tpu.models.decoder import \
    DecoderConfig as JConfig
from eddie_wang_hackathon2023_tpu.models.decoder import \
    DecoderLMHead as JModel
from eddie_wang_hackathon2023_tpu.models.whisper import (
    CrossAttnKV as JCrossAttnKV, WhisperConfig as JWhisperConfig,
    WhisperDecoder as JWhisperDecoder, WhisperEncoder as JWhisperEncoder)
from eddie_wang_hackathon2023_tpu.parallel import Mapping as JMapping
from eddie_wang_hackathon2023_tpu.parallel import shard_state as j_shard_state
from eddie_wang_hackathon2023_tpu.quantization import QuantMode as JQ
from eddie_wang_hackathon2023_tpu.quantization.surgery import \
    weight_only_quantize_state as j_woq
from eddie_wang_hackathon2023_tpu_torch.models.decoder import DecoderConfig
from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import \
    from_jax_state as dec_from_jax_state
from eddie_wang_hackathon2023_tpu_torch.models.whisper import (
    WhisperConfig, from_jax_state)
from eddie_wang_hackathon2023_tpu_torch.models.whisper.model import (
    CrossAttnKV, WhisperDecoder, WhisperEncoder)
from eddie_wang_hackathon2023_tpu_torch.models.whisper.pipeline import (
    DecodingOptions, WhisperPipeline)
from eddie_wang_hackathon2023_tpu_torch.parallel import (
    Mapping, init_distributed, parallelize, shard_state, spawn_ranks,
    start_ranks)
from eddie_wang_hackathon2023_tpu_torch.parallel.dryrun import (
    _cross_state, _jax_layout_zeros_or_normal, dryrun_multichip)
from eddie_wang_hackathon2023_tpu_torch.quantization.mode import QuantMode
from eddie_wang_hackathon2023_tpu_torch.runtime import (
    GenerationSession, ModelConfig, SamplingConfig)

TINY_DIMS = dict(n_mels=8, n_vocab=100, n_audio_ctx=20, n_audio_state=32,
                 n_audio_head=4, n_audio_layer=2, n_text_ctx=24,
                 n_text_state=32, n_text_head=4, n_text_layer=2,
                 dtype="float32")
JTINY = JWhisperConfig(**TINY_DIMS)
TINY = WhisperConfig(**TINY_DIMS)
LAYOUTS = [(1, 2), (2, 2), (1, 4)]
# the ranks' backend and device (the launcher's defaults are nccl on cuda)
CPU = dict(backend="gloo", device="cpu")
MEL = np.random.RandomState(0).randn(2, 8, 40).astype(np.float32)
TOKENS = np.array([[5, 17, 42], [3, 9, 27]], dtype=np.int32)
GPT2 = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
            max_position_embeddings=64, position_embedding="learned",
            hidden_act="gelu")
PROMPT = np.array([[5, 11, 17, 23], [2, 3, 4, 5]], dtype=np.int32)
CB_PROMPTS = [[5, 11, 17, 23], [2, 3], [40, 41, 42, 43, 44], [7]]
# a Whisper with heads of 64 and the real vocab (its tokenizer), for the
# pipelines
PIPE = WhisperConfig(n_mels=80, n_vocab=51865, n_audio_ctx=150,
                     n_audio_state=128, n_audio_head=2, n_audio_layer=2,
                     n_text_ctx=48, n_text_state=128, n_text_head=2,
                     n_text_layer=2, dtype="float32")
PIPE_MEL = np.random.RandomState(7).randn(2, 80, 300).astype(np.float32)


@pytest.fixture
def one_cpu_thread():
    """One intra-op thread for a rehearsal of many tiny ops (the test
    runner's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_state(module):
    return {k: np.asarray(v) for k, v in module.state_dict().items()}


# -- the JAX side -------------------------------------------------------------

@pytest.fixture(scope="module")
def whisper():
    """The JAX test's tiny Whisper (random_init of PRNGKeys 0, 1, 2), and
    its states as numpy."""
    enc, dec, ckv = (JWhisperEncoder(JTINY), JWhisperDecoder(JTINY),
                     JCrossAttnKV(JTINY))
    enc.random_init(jax.random.PRNGKey(0), 0.05)
    dec.random_init(jax.random.PRNGKey(1), 0.05)
    ckv.random_init(jax.random.PRNGKey(2), 0.05)
    return (enc, dec, ckv), tuple(_np_state(m) for m in (enc, dec, ckv))


def _jax_golden(models):
    enc, dec, ckv = models
    cross = ckv(enc(jnp.asarray(MEL)))
    cache = dec.new_kv_cache(2)
    logits, cache = dec(jnp.asarray(TOKENS), cache, cross, 0,
                        jnp.array([3, 3]))
    step, _ = dec(jnp.asarray([[7], [8]]), cache, cross, 3,
                  jnp.array([4, 4]))
    return np.asarray(logits), np.asarray(step)


def _jax_sharded(models, devices, dp, tp):
    """The JAX test's sharded run at (dp, tp)."""
    enc, dec, ckv = models
    mesh = JMapping(world_size=dp * tp, dp_size=dp, tp_size=tp,
                    devices=devices).mesh
    enc_p, dec_p, ckv_p = (j_shard_state(m.state_dict(), m.pspecs(), mesh)
                           for m in models)
    dp_sh = NamedSharding(mesh, P("dp"))
    xa = jax.jit(lambda p, x: enc.apply(p, x))(
        enc_p, jax.device_put(MEL, NamedSharding(mesh, P("dp", None, None))))
    cross = jax.jit(lambda p, x: ckv.apply(p, x))(ckv_p, xa)
    cache = jax.device_put(dec.new_kv_cache(2), NamedSharding(
        mesh, P(None, "dp", None, "tp", None, None)))
    step = jax.jit(lambda p, t, c, cr, w, s: dec.apply(p, t, c, cr, w, s))
    logits, cache = step(dec_p, jax.device_put(TOKENS, NamedSharding(
        mesh, P("dp", None))), cache, cross, 0,
        jax.device_put(np.array([3, 3], np.int32), dp_sh))
    sl, _ = step(dec_p, jax.device_put(np.array([[7], [8]], np.int32),
                                       NamedSharding(mesh, P("dp", None))),
                 cache, cross, 3,
                 jax.device_put(np.array([4, 4], np.int32), dp_sh))
    return np.asarray(logits), np.asarray(sl)


def _jax_decoder(kw, seed, woq=0):
    """(JAX model, its state: numpy, quantised for ``woq`` bits) with
    LayerNorm weights 1 + N(0, 0.02) and the rest N(0, 0.2)."""
    jm = JModel(JConfig(**kw, dtype="float32"))
    rs = np.random.RandomState(seed)
    state = {}
    for name, p in jm.named_parameters():
        x = rs.randn(*p.shape).astype(np.float32)
        norm = name.endswith("layernorm.weight") or name == "ln_f.weight"
        state[name] = 1 + 0.02 * x if norm else 0.2 * x
    if woq:
        jm, state = j_woq(jm, state, JQ.use_weight_only(woq == 4))
        state = {k: np.asarray(v) for k, v in state.items()}
    jm.load_state_dict({k: jnp.asarray(v) for k, v in state.items()},
                       strict=False)
    return jm, state


def _port_config(kw, woq=0):
    return DecoderConfig(**kw, dtype="float32", quant_mode=(
        QuantMode.use_weight_only(woq == 4) if woq else QuantMode(0)))


def _jax_generate(jm, kw, prompt=PROMPT, max_new=8):
    from eddie_wang_hackathon2023_tpu.runtime import (
        GenerationSession as JSession, ModelConfig as JMC,
        SamplingConfig as JSC)
    mc = JMC(vocab_size=kw["vocab_size"], num_layers=kw["num_layers"],
             num_heads=kw["num_heads"], hidden_size=kw["hidden_size"],
             max_seq_len=64, num_kv_heads=kw.get("num_kv_heads"))
    toks, lens, _ = JSession(mc, jm, JSC(end_id=95, pad_id=95)).decode(
        prompt, np.full((prompt.shape[0],), prompt.shape[1]),
        max_new_tokens=max_new)
    return np.asarray(toks), np.asarray(lens)


def _jax_serve(jm, prompts=CB_PROMPTS):
    from eddie_wang_hackathon2023_tpu.runtime.batch_manager import (
        ContinuousBatchingManager as JCBM, InferenceRequest as JReq)
    from eddie_wang_hackathon2023_tpu.runtime.sampling import \
        SamplingConfig as JSC
    results = {}
    q = [JReq(i, np.asarray(p, np.int32), max_new_tokens=8, end_id=95)
         for i, p in enumerate(prompts)]
    JCBM(jm, JSC(end_id=95, pad_id=95), max_batch_size=2, max_seq_len=64,
         params=jm.state_dict(),
         get_inference_requests=lambda n: [q.pop(0)] if q else [],
         send_response=lambda r: results.__setitem__(
             r.request_id, [int(t) for t in r.output_ids])
         if r.finished else None).run()
    return results


# the decoder-only models of the spawned jobs: name -> (config kwargs, seed,
# woq bits)
DECODERS = {
    "gpt2": (GPT2, 0, 0),
    "gpt2_woq8": (GPT2, 1, 8),
    "gpt2_cb": (GPT2, 3, 0),
    # int4 in groups of 128: at d 256 the rank's K (128) takes the group,
    # at d 128 (K 64 a rank) the attention block stays whole (its MLP, K
    # 512 -> 256 a rank, shards)
    "woq4_divides": (dict(GPT2, hidden_size=256), 4, 4),
    "woq4_whole": (dict(GPT2, hidden_size=128, num_heads=2), 5, 4),
    "llama_gqa": (dict(GPT2, hidden_size=128, num_kv_heads=2,
                       position_embedding="rope", norm="rmsnorm",
                       gated_mlp=True, hidden_act="silu", attn_bias=False,
                       mlp_bias=False, tie_word_embeddings=False), 6, 0),
    "mqa": (dict(GPT2, hidden_size=128, num_kv_heads=1), 7, 0),
    # the megakernel gate's model (tests/test_megakernel.py:885-921: d 128)
    "gate": (dict(GPT2, hidden_size=128), 8, 0),
}


@pytest.fixture(scope="module")
def decoders():
    return {name: _jax_decoder(kw, seed, woq)
            for name, (kw, seed, woq) in DECODERS.items()}


def _gen_job(decoders, name, layout, **kw):
    cfg_kw, _, woq = DECODERS[name]
    return ("generate", dict(cfg=_port_config(cfg_kw, woq),
                             state=decoders[name][1], prompt=PROMPT,
                             lens=np.array([4, 4]), max_new=8, layout=layout,
                             end_id=95, **kw))


def _whisper_job(whisper, layout, recipe="", states=None):
    return ("whisper_logits", dict(cfg=TINY, states=states or whisper[1],
                                   recipe=recipe, mel=MEL, tokens=TOKENS,
                                   layout=layout))


def _pipe_states():
    with torch.device("meta"):
        shapes = WhisperEncoder(PIPE), WhisperDecoder(PIPE)
    enc, dec = (_jax_layout_zeros_or_normal(m, np.random.default_rng(s))
                for m, s in zip(shapes, (10, 11)))
    return enc, dec, _cross_state(PIPE, np.random.default_rng(12))


@pytest.fixture(scope="module")
def woq_whisper(whisper):
    """The JAX test's weight-only int8 Whisper decoder (PRNGKey 1) and the
    cross K/V of ``RandomState(3)``'s encoder output."""
    base = JWhisperDecoder(JTINY)
    base.random_init(jax.random.PRNGKey(1), 0.05)
    qdec, qstate = j_woq(base, base.state_dict(),
                         JQ.use_weight_only(False))
    qdec.load_state_dict(qstate, strict=False)
    xa = np.random.RandomState(3).randn(2, 20, 32).astype(np.float32)
    cross = np.asarray(whisper[0][2](jnp.asarray(xa)))
    return _np_state(qdec), cross, qdec


@pytest.fixture(scope="module")
def fp8():
    """The JAX FP8 test's column + row pair (PRNGKey 2, scales of amax 8)
    and its single-device output."""
    from eddie_wang_hackathon2023_tpu.module import Module
    from eddie_wang_hackathon2023_tpu.quantization.fp8_layers import (
        FP8Linear as JFP8Linear, FP8RowLinear as JFP8RowLinear,
        fp8_scales_from_amax)

    class Pair(Module):
        def __init__(self):
            super().__init__()
            self.col = JFP8Linear(16, 32, dtype="float32",
                                  gather_output=False)
            self.row = JFP8RowLinear(32, 16, dtype="float32")

        def forward(self, x):
            return self.row(self.col(x))

    m = Pair()
    m.random_init(jax.random.PRNGKey(2), 0.1)
    for name, p in m.named_parameters():
        if name.endswith("scaling_factor"):
            p.value = jnp.asarray([fp8_scales_from_amax(8.0)], jnp.float32)
    x = np.random.RandomState(3).randn(2, 5, 16).astype(np.float32)
    return m, _np_state(m), x


@pytest.fixture(scope="module")
def spawned(whisper, decoders, woq_whisper, fp8):
    """The world-2, world-4 and world-8 jobs, spawned side by side before
    any waits for them."""
    return dict(ranks4=_spawn4(whisper, decoders, woq_whisper, fp8),
                ranks2=_spawn2(whisper, decoders),
                ranks8=_spawn8(whisper))


def _spawn4(whisper, decoders, woq_whisper, fp8):
    """Every world-4 job, one spawn: Whisper at (2, 2) and (1, 4), GPT-2
    float and woq8 at tp 4, serving at tp 4 (dense and paged), the woq
    Whisper decoder at dp 2 x tp 2, the FP8 pair at tp 4, the Whisper
    pipeline at dp 2 x tp 2."""
    dec_state, cross, _ = woq_whisper
    cb = decoders["gpt2_cb"][1]
    jobs = [_whisper_job(whisper, (2, 2)), _whisper_job(whisper, (1, 4)),
            _gen_job(decoders, "gpt2", (1, 4)),
            _gen_job(decoders, "gpt2_woq8", (1, 4)),
            ("serve", dict(cfg=_port_config(GPT2), state=cb,
                           prompts=CB_PROMPTS, layout=(1, 4), end_id=95)),
            ("serve", dict(cfg=_port_config(GPT2), state=cb,
                           prompts=CB_PROMPTS, layout=(1, 4), end_id=95,
                           paged=True, tokens_per_block=8)),
            ("whisper_decoder_logits", dict(
                cfg=TINY, dec_state=dec_state, cross=cross, recipe="woq8",
                tokens=TOKENS, layout=(2, 2))),
            ("fp8_pair", dict(state=fp8[1], x=fp8[2], layout=(1, 4))),
            ("whisper_transcribe", dict(cfg=PIPE, states=_pipe_states(),
                                        mel=PIPE_MEL, layout=(2, 2),
                                        decode_megakernel=False))]
    return ["w22", "w14", "gpt2", "woq8", "cb_dense", "cb_paged",
            "woq_whisper", "fp8", "pipe_dp"], start_ranks(R.bundle, 4, jobs,
                                                          **CPU)


def _results(names_spawned):
    names, sp = names_spawned
    return dict(zip(names, zip(*sp.result())))


@pytest.fixture(scope="module")
def ranks4(spawned):
    return _results(spawned["ranks4"])


@pytest.fixture(scope="module")
def ranks2(spawned):
    return _results(spawned["ranks2"])


@pytest.fixture(scope="module")
def ranks8(spawned):
    return _results(spawned["ranks8"])["vocab"]


def _vocab_padded(whisper):
    """The JAX test's padded-vocab case: the decoder's state with 4 zero
    vocab rows (104 = 8 x 13) and the cross K/V of RandomState(0)'s
    encoder output."""
    (_, _, ckv), (_, dec_sd, _) = whisper
    state = dict(dec_sd)
    w = state["token_embedding.weight"]
    state["token_embedding.weight"] = np.concatenate(
        [w, np.zeros((4, w.shape[1]), w.dtype)])
    xa = (np.random.RandomState(0).randn(2, 20, 32) * 0.1).astype(np.float32)
    return state, np.asarray(ckv(jnp.asarray(xa)))


def _spawn8(whisper):
    state, cross = _vocab_padded(whisper)
    cfg = dataclasses.replace(TINY, vocab_pad_multiple=8)
    return ["vocab"], start_ranks(R.bundle, 8, [(
        "whisper_decoder_logits", dict(cfg=cfg, dec_state=state, cross=cross,
                                       recipe="", tokens=TOKENS,
                                       layout=(1, 8)))], **CPU)


def _spawn2(whisper, decoders):
    """Every world-2 job, one spawn: Whisper at (1, 2), woq4 at tp 2
    (the group divides the rank's K, and does not), LLaMA GQA and MQA at
    tp 2, the megakernel gate (decoder-only and Whisper)."""
    jobs = [_whisper_job(whisper, (1, 2)),
            _gen_job(decoders, "woq4_divides", (1, 2)),
            _gen_job(decoders, "woq4_whole", (1, 2)),
            _gen_job(decoders, "llama_gqa", (1, 2)),
            _gen_job(decoders, "mqa", (1, 2)),
            _gen_job(decoders, "gate", (1, 2), decode_megakernel=True),
            ("whisper_transcribe", dict(cfg=PIPE, states=_pipe_states(),
                                        mel=PIPE_MEL[:1], layout=(1, 2),
                                        decode_megakernel=True))]
    return ["w12", "woq4_divides", "woq4_whole", "llama_gqa", "mqa", "gate",
            "pipe_gate"], start_ranks(R.bundle, 2, jobs, **CPU)


def _ranks(layout, ranks2, ranks4):
    return (ranks2["w12"] if layout == (1, 2) else
            ranks4["w22" if layout == (2, 2) else "w14"])


def _gather_dp(results, key="logits"):
    """The batch joined from the dp ranks (tp rank 0 of each); every tp
    rank of a dp rank must hold the same."""
    by_dp = {}
    for r in results:
        prev = by_dp.setdefault(r["dp_rank"], r)
        np.testing.assert_array_equal(prev[key], r[key])
    return np.concatenate([by_dp[d][key] for d in sorted(by_dp)])


# -- the mirrors of tests/test_parallel.py ----------------------------------

@pytest.mark.parametrize("dp,tp", LAYOUTS)
def test_sharded_whisper_matches_single_device(whisper, cpu_devices, ranks2,
                                               ranks4, dp, tp):
    ref_logits, ref_step = _jax_golden(whisper[0])
    j_logits, j_step = _jax_sharded(whisper[0], cpu_devices[:dp * tp], dp,
                                    tp)
    res = _ranks((dp, tp), ranks2, ranks4)
    logits, step = _gather_dp(res), _gather_dp(res, "step")
    for ref, jsh, got in ((ref_logits, j_logits, logits),
                          (ref_step, j_step, step)):
        np.testing.assert_allclose(got, ref, atol=2e-3)
        np.testing.assert_allclose(got, jsh, atol=2e-3)
    # each rank's caches hold its heads; no rank takes the megakernel
    assert {r["cache_heads"] for r in res} == {4 // tp}
    assert {r["cross_heads"] for r in res} == {4 // tp}
    assert not any(r["megakernel"] for r in res)


def test_vocab_padding_shards_and_matches(whisper, ranks8):
    """Vocab 100 padded to 104 shards over tp 8 (13 rows a rank); 4 heads
    do not divide 8, so the attention blocks stay whole (the MLPs shard);
    the logits, sliced back to 100, match the unpadded JAX decoder."""
    cfg = dataclasses.replace(TINY, vocab_pad_multiple=8)
    assert cfg.padded_vocab == 104
    (_, dec, _), _ = whisper
    _, cross = _vocab_padded(whisper)
    ref, _ = dec(jnp.asarray(TOKENS), dec.new_kv_cache(2), jnp.asarray(cross),
                 0, jnp.array([3, 3]))
    ref = np.asarray(ref)
    assert {r["vocab_rows"] for r in ranks8} == {13}
    for r in ranks8:
        assert r["logits"].shape[-1] == 100
        np.testing.assert_allclose(r["logits"], ref, atol=2e-3)


def test_sharded_gpt_generation_matches(decoders, ranks4):
    ref = _jax_generate(decoders["gpt2"][0], GPT2)
    for r in ranks4["gpt2"]:
        np.testing.assert_array_equal(r["tokens"], ref[0])
        np.testing.assert_array_equal(r["lens"], ref[1])
        assert r["kv_heads"] == 1


def test_mapping_validation(cpu_devices):
    with pytest.raises(ValueError):
        Mapping(world_size=8, dp_size=3, tp_size=2)
    # the rank layout is the JAX mesh's device order
    jm = JMapping(world_size=8, dp_size=2, tp_size=4, devices=cpu_devices)
    for rank in range(8):
        m = Mapping(world_size=8, rank=rank, dp_size=2, tp_size=4)
        dev = jm.mesh.devices[m.dp_rank, m.tp_rank, m.pp_rank]
        assert dev == cpu_devices[rank]
        assert m.tp_group == list(range(8)) == jm.tp_group
        assert rank in m.tp.ranks and rank in m.dp.ranks
        assert (m.tp.size, m.dp.size) == (4, 2)
    assert Mapping(world_size=8, rank=5, dp_size=2, tp_size=4).tp.ranks == \
        (4, 5, 6, 7)
    assert Mapping(world_size=8, rank=5, dp_size=2).tp_size == 4


def test_sharded_woq_generation_matches(decoders, ranks4):
    ref = _jax_generate(decoders["gpt2_woq8"][0], GPT2)
    assert any(k.endswith("qweight") for k in decoders["gpt2_woq8"][1])
    for r in ranks4["woq8"]:
        np.testing.assert_array_equal(r["tokens"], ref[0])
        np.testing.assert_array_equal(r["lens"], ref[1])


@pytest.mark.parametrize("mode", ["cb_dense", "cb_paged"])
def test_sharded_continuous_batching_matches(decoders, ranks4, mode):
    """Serving at tp 4 (the dense slot cache, and the block pool of [L,
    N + 1, 2, Hkv / 4, T, D]) equals the JAX single-device manager, and
    every rank agrees."""
    ref = _jax_serve(decoders["gpt2_cb"][0])
    res = ranks4[mode]
    for r in res:
        assert r["results"] == ref
        assert r["kv_heads"] == 1


def test_sharded_woq_whisper_decoder(woq_whisper, ranks4):
    _, cross, qdec = woq_whisper
    ref, _ = qdec(jnp.asarray(TOKENS), qdec.new_kv_cache(2),
                  jnp.asarray(cross), 0, jnp.array([3, 3]))
    ref = np.asarray(ref)
    got = _gather_dp(ranks4["woq_whisper"])
    np.testing.assert_allclose(got, ref, atol=2e-3)


# -- beyond tests/test_parallel.py --------------------------------------------

def _check_shards(jmodel, pmodel_fn, tp, devices, stacked_apart=(),
                  make=parallelize):
    """For each rank of tp, ``shard_state`` of the port's model against
    the JAX ``shard_state``'s addressable shard on the matching device:
    every parameter the port splits, the JAX rule splits too and the two
    shards are bit-equal (except ``stacked_apart``, split on another dim
    here); every other one the port keeps whole (the JAX rule may still
    split a parameter of a block the port keeps whole: ``_legalize``
    decides per parameter, the port per block).  ``make(model,
    mapping)`` makes the rank's model.  Returns the number of (rank,
    parameter) pairs split by both."""
    from eddie_wang_hackathon2023_tpu_torch.parallel.sharding import \
        state_index
    state = _np_state(jmodel)
    mesh = JMapping(world_size=tp, tp_size=tp, devices=devices[:tp]).mesh
    jsh = j_shard_state(jmodel.state_dict(), jmodel.pspecs(), mesh)
    n_split = 0
    for rank in range(tp):
        m = Mapping(world_size=tp, rank=rank, tp_size=tp)
        model = pmodel_fn()
        make(model, m)
        mine = shard_state(state, model, m)
        split_here = state_index(model)
        dev = mesh.devices[0, rank, 0]
        for k, v in state.items():
            arr = jsh[k]
            shard = next(np.asarray(s.data) for s in arr.addressable_shards
                         if s.device == dev)
            split = any(a is not None for a in tuple(arr.sharding.spec))
            if k in stacked_apart and k in split_here or (
                    k in stacked_apart and k.endswith(".bias")
                    and split_here):
                # split on its out-features in the JAX block, on its
                # in-features here (the bias then whole)
                assert split, k
                if k.endswith(".bias"):
                    assert mine[k] is v, k
                else:
                    n = v.shape[-1] // tp
                    np.testing.assert_array_equal(
                        mine[k], v[..., rank * n:(rank + 1) * n])
            elif k in split_here:
                assert split, k
                n_split += 1
                np.testing.assert_array_equal(mine[k], shard, err_msg=k)
            else:
                assert mine[k] is v, k
    return n_split


def _shard_like_decoder(ckv, m):
    """The cross-KV made for the heads of a sharded decoder's cross
    attention, as ``from_jax_state`` makes it."""
    dec = parallelize(WhisperDecoder(TINY), m)
    ckv.shard_like(dec.blocks[0].cross_attn)


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_shard_state_bit_equal_to_jax(whisper, decoders, cpu_devices, tp):
    """Whisper's encoder, decoder and cross-KV and GPT-2 at tp 2, 4 and 8
    (tp 8: the heads (4) and the Whisper vocab (100) do not divide, the
    JAX ``_legalize`` case: both keep them whole, the MLPs split)."""
    (enc, dec, ckv), _ = whisper
    apart = ("blocks.mlp2.weight", "blocks.mlp2.bias")
    n = 0
    n += _check_shards(enc, lambda: WhisperEncoder(TINY), tp, cpu_devices,
                       apart)
    n += _check_shards(dec, lambda: WhisperDecoder(TINY), tp, cpu_devices,
                       apart)
    n += _check_shards(ckv, lambda: CrossAttnKV(TINY), tp, cpu_devices,
                       make=_shard_like_decoder)
    if tp < 8:
        from eddie_wang_hackathon2023_tpu_torch.models.decoder import \
            DecoderLMHead
        n += _check_shards(decoders["gpt2"][0],
                           lambda: DecoderLMHead(_port_config(GPT2)), tp,
                           cpu_devices)
    assert n > 0


@pytest.mark.parametrize("case", ["woq4_divides", "woq4_whole"])
def test_woq4_tp2_token_exact(decoders, ranks2, case):
    """int4 in groups of 128 at tp 2: where the rank's row-parallel K is a
    multiple of the group the attention shards (1 KV head a rank), where
    it is not the attention block stays whole (both heads on each rank);
    tokens equal the JAX single-device model's either way."""
    cfg_kw, _, _ = DECODERS[case]
    ref = _jax_generate(decoders[case][0], cfg_kw)
    for r in ranks2[case]:
        np.testing.assert_array_equal(r["tokens"], ref[0])
        assert r["attn_tp"] == (case == "woq4_divides") and r["mlp_tp"]
        assert r["kv_heads"] == 2


@pytest.mark.parametrize("case", ["llama_gqa", "mqa"])
def test_grouped_heads_tp2_token_exact(decoders, ranks2, case):
    """LLaMA's GQA (4 heads over 2 KV heads: one a rank) and MQA (one KV
    head, held by both ranks) at tp 2, token-exact with JAX."""
    cfg_kw, _, _ = DECODERS[case]
    ref = _jax_generate(decoders[case][0], cfg_kw)
    for r in ranks2[case]:
        np.testing.assert_array_equal(r["tokens"], ref[0])
        assert r["kv_heads"] == 1


def test_fp8_linear_sharded_tp(fp8, ranks4):
    """tests/test_fp8.py's column + row FP8 pair at tp 4 against the JAX
    single-device run (atol 2e-4, that test's)."""
    m, _, x = fp8
    ref = np.asarray(m(jnp.asarray(x)))
    for got in ranks4["fp8"]:
        np.testing.assert_allclose(got, ref, atol=2e-4)


def test_megakernel_gate_under_tp(decoders, ranks2):
    """The counterpart of tests/test_megakernel.py:885-921: an unsharded
    session packs the megakernel's blobs; a tp-2 one packs none and decodes
    layer by layer to the same tokens (decoder-only and Whisper)."""
    cfg_kw, _, _ = DECODERS["gate"]
    pc = _port_config(cfg_kw)
    model = dec_from_jax_state(decoders["gate"][1], pc, device="cpu")
    assert model.megakernel_eligible()
    mc = ModelConfig(vocab_size=96, num_layers=2, num_heads=4,
                     hidden_size=128, max_seq_len=64)
    sess = GenerationSession(mc, model, SamplingConfig(end_id=95, pad_id=95),
                             decode_megakernel=True)
    toks, lens, _ = sess.decode(PROMPT[:1], np.array([4]), max_new_tokens=8)
    assert sess._mk_blobs is not None
    res = ranks2["gate"]
    for r in res:
        assert not r["blobs"] and not r["eligible"]
    # the sharded session decoded both prompts: the first equals batch 1's
    np.testing.assert_array_equal(res[0]["tokens"][:1], toks)
    # Whisper: the unsharded pipeline through the megakernel's plain version
    enc, dec, ckv = from_jax_state(*_pipe_states(), PIPE, device="cpu")
    assert dec.megakernel_eligible()
    pipe = WhisperPipeline(PIPE, enc, dec, ckv, DecodingOptions(
        language="en", sample_len=8), decode_megakernel=True)
    want = [r.tokens for r in pipe.transcribe(PIPE_MEL[:1])]
    assert pipe._mk_blobs is not None
    for r in ranks2["pipe_gate"]:
        assert not r["blobs"]
        assert r["tokens"] == want


def test_data_parallel_transcription(ranks4):
    """The pipeline at dp 2 x tp 2: each dp rank transcribes its row and
    every rank returns both rows, equal to one process's batch of 2."""
    enc, dec, ckv = from_jax_state(*_pipe_states(), PIPE, device="cpu")
    pipe = WhisperPipeline(PIPE, enc, dec, ckv, DecodingOptions(
        language="en", sample_len=8), decode_megakernel=False)
    want = [r.tokens for r in pipe.transcribe(PIPE_MEL)]
    for r in ranks4["pipe_dp"]:
        assert r["tokens"] == want


@pytest.mark.parametrize("int8", [False, True])
def test_cross_kv_batch_is_contiguous(int8):
    """The cross K/V of a batch above 1 (a data-parallel rank's rows, the
    dry run's batch of 2) is the contiguous seq-minor cache the decode
    kernel takes (it refuses a strided one on the card)."""
    ckv = CrossAttnKV(TINY, int8_output=int8)
    state = {k: torch.randn(v.shape) * 0.05 if v.is_floating_point()
             else v for k, v in ckv.state_dict().items()}
    if int8:
        state["kv_scale"] = torch.full((TINY.n_text_layer,), 0.01)
    ckv.load_state_dict(state)
    out = ckv(torch.randn(2, TINY.n_audio_ctx, TINY.n_text_state))
    cache = out[0] if int8 else out
    assert cache.shape == (2, 2, 2, 4, 8, 20) and cache.is_contiguous()


def test_decode_proj_epilogue_off_under_tp():
    """Kernel 1's fused int8 out-projection would add the bias on every
    rank and skip the reduction: a tensor-parallel attention never takes
    it (the JAX ``_woq8_unsharded`` gate)."""
    from eddie_wang_hackathon2023_tpu_torch.layers import Attention
    attn = Attention(128, 2, causal=True,
                     quant_mode=QuantMode.use_weight_only(False))
    assert attn._decode_proj_operands(1) is not None
    m = Mapping(world_size=2, rank=1, tp_size=2)
    holder = torch.nn.Module()
    holder.attn = attn
    parallelize(holder, m)
    assert attn.num_attention_heads == 1 and attn.head_offset == 1
    assert attn.dense.row_parallel
    assert attn._decode_proj_operands(1) is None


def test_init_distributed_never_changes_backend():
    import torch.distributed as dist
    with pytest.raises(RuntimeError, match="nccl takes one card a rank"):
        init_distributed("nccl", "cpu", rank=0, world_size=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_distributed(rank=0, world_size=2)
    assert not dist.is_initialized()


def test_launchers_default_to_the_card():
    """The multi-rank entry points run on the card unless the caller asks
    for the CPU: nccl on cuda, as init_distributed."""
    import inspect
    for fn in (start_ranks, spawn_ranks, dryrun_multichip):
        params = inspect.signature(fn).parameters
        assert params["backend"].default == "nccl", fn.__name__
        assert params["device"].default == "cuda", fn.__name__


def test_dryrun_multichip_on_cpu():
    line = dryrun_multichip(4, device="cpu", backend="gloo")
    assert line.startswith("dryrun_multichip OK: dp=1 x tp=4")
    assert "large-v2 32L/d1280/h20 woq8+kv8 2 decode steps" in line


def test_chip_smoke_tp_paths_on_cpu(one_cpu_thread, monkeypatch):
    """chip_smoke.py's tp, tp_woq4, serve_tp and ring paths rehearsed on
    the CPU at tiny widths (Whisper d 256 with 4 heads of 64, GPT-class d
    128): the tokens and outputs equal the single-rank ones, the ranks
    agree (no kernel launches from CPU tensors)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    # the ranks' target is pickled by name: chip_smoke.tp_rank_jobs
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)
    spec.loader.exec_module(smoke)
    cfg = dataclasses.replace(PIPE, n_audio_state=256, n_audio_head=4,
                              n_text_state=256, n_text_head=4, n_text_ctx=96)
    built = smoke.build_whisper(torch, np, cfg, "cpu", smoke.SCANNED_RECIPE,
                                "scanned", keep_states=True)
    toks = smoke.whisper_pipeline(built, False, sample_len=8).transcribe(
        built["mel"])[0].tokens
    sc = dataclasses.replace(
        smoke.gpt_350m_config(), vocab_size=97, hidden_size=128,
        num_layers=2, num_heads=2, num_kv_heads=2, ffn_hidden_size=512,
        dtype="float32")
    served, replay = {}, {}
    # the serve path's first SERVE_TP_REQUESTS requests are all serve_tp
    # compares
    monkeypatch.setattr(smoke, "SERVE_REQUESTS", smoke.SERVE_TP_REQUESTS)
    smoke.serve_path(torch, np, config=sc, device="cpu", outputs=served,
                     recorded=replay)
    e2e, counts = smoke.tp_paths(torch, np, built, toks, served, replay,
                                 device="cpu", serve_config=sc, sample_len=8,
                                 ring_shape=(1, 2, 64, 16))
    assert e2e["tp"]["tokens"] == list(toks)
    assert e2e["tp"]["vocab_rows"] == 51866 // 2
    assert e2e["serve_tp"]["kv_heads"] == 1
    # fp32 here: the replayed logits agree far inside the card's band
    assert e2e["tp"]["teacher_forced_rel_err"] < 1e-4
    assert e2e["tp_woq4"]["rel_err"] < 1e-4
    assert e2e["serve_tp"]["rel_err"] < 1e-4
    assert set(counts) == {"tp", "tp_woq4", "serve_tp"}
