"""The decoder families of the port (GPT-2, LLaMA with and without GQA,
OPT, GPT-J, GPT-NeoX; Bloom and ChatGLM-6B are in
tests/test_torch_families_b.py) against the JAX package and HF on the CPU,
at tiny sizes.  Tiny HF models are built from ``transformers`` config objects with
seeded random weights (no download); both packages map the same HF state
dict.

* ``functional.rope`` against the JAX ``rope``: GPT-NeoX halves, GPT-J
  interleaved pairs, a partial rotary dim (fp32, 1e-6 at positions up to
  2000: the angles agree to an ulp);
* ``rms_norm`` against the JAX one (fp32 1e-6, bf16 within one bf16
  step: the sums' orders differ);
* each family's mapper bit-equal to the JAX mapper, key for key;
* each family's prefill logits against JAX (fp32, 1e-5) and HF (fp32,
  2e-3, the JAX package's own zoo tolerance), and three single-token
  steps against JAX (logits and cache, 1e-5);
* greedy ``GenerationSession`` token-exact with the JAX session at batch 2
  (ragged left-padded prompts) for LLaMA, LLaMA-GQA, GPT-J, GPT-NeoX,
  GPT-2 and OPT; LLaMA beams (3) token-exact with the JAX session
  (indirection on both sides), scores within 1e-4; LLaMA paged serving
  token-exact with the JAX manager;
* LLaMA under ``woq8`` and ``woq4`` (per channel at these widths): the
  quantised state bit-equal to the JAX surgery's (``mlp.gate`` among the
  linears), logits within 1e-4, greedy tokens exact.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eddie_wang_hackathon2023_tpu_torch import functional as pf
from eddie_wang_hackathon2023_tpu_torch.models import families
from eddie_wang_hackathon2023_tpu_torch.models.decoder_convert import (
    from_jax_state, quantize_state)
from eddie_wang_hackathon2023_tpu_torch.quantization import QuantMode
from eddie_wang_hackathon2023_tpu_torch.runtime import (
    ContinuousBatchingManager, GenerationSession, InferenceRequest,
    ModelConfig, SamplingConfig)

V = 97
FAMILIES = ["gpt2", "llama", "llama_gqa", "opt", "gptj", "gptneox"]


def _hf(family):
    """A tiny HF model of the family, seeded: width 64, 2 layers, 4 heads
    of 16 (GPT-J rotates 8 interleaved channels of each, NeoX half)."""
    import transformers as T
    torch.manual_seed(0)
    h, layers, heads = 64, 2, 4
    if family == "gpt2":
        return T.GPT2LMHeadModel(T.GPT2Config(
            vocab_size=V, n_positions=64, n_embd=h, n_layer=layers,
            n_head=heads)).eval()
    if family in ("llama", "llama_gqa"):
        return T.LlamaForCausalLM(T.LlamaConfig(
            vocab_size=V, hidden_size=h, intermediate_size=172,
            num_hidden_layers=layers, num_attention_heads=heads,
            num_key_value_heads=2 if family == "llama_gqa" else heads,
            max_position_embeddings=64, tie_word_embeddings=False)).eval()
    if family == "opt":
        return T.OPTForCausalLM(T.OPTConfig(
            vocab_size=V, hidden_size=h, ffn_dim=4 * h,
            num_hidden_layers=layers, num_attention_heads=heads,
            max_position_embeddings=64, do_layer_norm_before=True,
            word_embed_proj_dim=h)).eval()
    if family == "gptj":
        return T.GPTJForCausalLM(T.GPTJConfig(
            vocab_size=V, n_positions=64, n_embd=h, n_layer=layers,
            n_head=heads, rotary_dim=8)).eval()
    if family == "gptneox":
        return T.GPTNeoXForCausalLM(T.GPTNeoXConfig(
            vocab_size=V, hidden_size=h, intermediate_size=4 * h,
            num_hidden_layers=layers, num_attention_heads=heads,
            max_position_embeddings=64, rotary_pct=0.5)).eval()
    raise ValueError(family)


_BUILT = {}


def _built(family, quant=""):
    """(HF model, JAX model, port model, port config) of a family, float32,
    built once a module (``quant`` "woq8"/"woq4": LLaMA quantised on both
    sides)."""
    key = (family, quant)
    if key not in _BUILT:
        from eddie_wang_hackathon2023_tpu.models.families import \
            build_from_hf as j_build
        hf = _BUILT.get((family, ""), (None,))[0] or _hf(family)
        fam = family.replace("_gqa", "")
        jm, jc = j_build(fam, hf, dtype="float32")
        kw = {}
        if quant:
            from eddie_wang_hackathon2023_tpu.quantization import \
                QuantMode as JQ
            from eddie_wang_hackathon2023_tpu.quantization.surgery import \
                weight_only_quantize_state as j_woq
            jm, jsd = j_woq(jm, jm.state_dict(),
                            JQ.use_weight_only(quant == "woq4"))
            jm.load_state_dict(jsd, strict=False)
            kw["quant_mode"] = QuantMode.use_weight_only(quant == "woq4")
        pm, pc = families.build_from_hf(fam, hf, dtype="float32",
                                        device="cpu", **kw)
        _BUILT[key] = (hf, jm, pm, pc)
    return _BUILT[key]


def _mc(c):
    return dict(vocab_size=c.vocab_size, num_layers=c.num_layers,
                num_heads=c.num_heads, hidden_size=c.hidden_size,
                max_seq_len=c.max_position_embeddings,
                num_kv_heads=c.num_kv_heads)


# -- functional ----------------------------------------------------------------

@pytest.mark.parametrize("neox,rd", [(True, None), (True, 8), (False, None),
                                     (False, 4)],
                         ids=["neox", "neox_partial", "gptj", "gptj_partial"])
def test_rope_matches_jax(neox, rd):
    """x [2, 5 positions, 3 heads, 16] at positions up to 2000 (as the JAX
    package's megakernel test holds its rotation matrix to
    ``functional.rope``, tests/test_megakernel.py:377)."""
    from eddie_wang_hackathon2023_tpu.functional import rope as j_rope
    rs = np.random.RandomState(7)
    x = rs.randn(2, 5, 3, 16).astype(np.float32)
    pos = rs.randint(0, 2000, (2, 5)).astype(np.int32)
    want = np.asarray(j_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, rd,
                             neox))
    got = pf.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0, rd,
                  neox)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if rd:                      # the channels past the rotary dim pass
        assert np.array_equal(got.numpy()[..., rd:], x[..., rd:])
    bf = pf.rope(torch.from_numpy(x).bfloat16(), torch.from_numpy(pos),
                 10000.0, rd, neox)
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    from eddie_wang_hackathon2023_tpu.functional import rms_norm as j_rms
    rs = np.random.RandomState(3)
    x = rs.randn(3, 64).astype(np.float32)
    w = (1 + 0.1 * rs.randn(64)).astype(np.float32)
    want = np.asarray(j_rms(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                            1e-6).astype(jnp.float32))
    t = getattr(torch, dtype)
    got = pf.rms_norm(torch.from_numpy(x).to(t), torch.from_numpy(w).to(t),
                      1e-6).float().numpy()
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# -- mappers and logits --------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_mapper_bit_equal_to_jax(family):
    from eddie_wang_hackathon2023_tpu.models.families import \
        FAMILIES as J_FAMILIES
    hf, _, _, pc = _built(family)
    fam = family.replace("_gqa", "")
    jc = J_FAMILIES[fam][0](hf.config, dtype="float32")
    sd = hf.state_dict()
    want = J_FAMILIES[fam][1](sd, jc)
    got = families.FAMILIES[fam][1](sd, pc)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    # the configs agree field for field (the port's QuantMode is its own)
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "num_kv_heads", "ffn_hidden_size", "position_embedding",
              "position_offset", "rotary_pct", "rotary_base",
              "neox_rotary_style", "norm", "norm_eps", "hidden_act",
              "gated_mlp", "attn_bias", "mlp_bias", "parallel_attn",
              "tie_word_embeddings", "lm_head_bias"):
        assert getattr(pc, f) == getattr(jc, f), f


@pytest.mark.parametrize("family", FAMILIES)
@torch.inference_mode()
def test_family_logits_match_jax_and_hf(family):
    """A 5-token prefill against HF and JAX, then three single-token steps
    (logits and the cache) against JAX."""
    hf, jm, pm, _ = _built(family)
    tokens = np.array([[3, 11, 25, 40, 7]], dtype=np.int32)
    ref = hf(torch.from_numpy(tokens).long()).logits.numpy()
    jl, jcache = jm(jnp.asarray(tokens), jm.new_kv_cache(1, 16), 0,
                    jnp.array([5]))
    cache = pm.new_kv_cache(1, 16)
    lg, cache = pm(torch.from_numpy(tokens).long(), cache, 0,
                   torch.tensor([5], dtype=torch.int32))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(lg.numpy(), ref, atol=2e-3)
    for i, tok in enumerate((9, 2, 40)):
        jl, jcache = jm(jnp.asarray([[tok]], jnp.int32), jcache, 5 + i,
                        jnp.array([6 + i]))
        lg, cache = pm(torch.tensor([[tok]]), cache, 5 + i, 6 + i)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(cache.numpy(), np.asarray(jcache), atol=1e-5)


# -- generation ----------------------------------------------------------------

def _jax_session(jm, c, sc, monkeypatch):
    from eddie_wang_hackathon2023_tpu.runtime import \
        GenerationSession as JSession
    from eddie_wang_hackathon2023_tpu.runtime import ModelConfig as JMC
    monkeypatch.setenv("EWT_DECODE_TAIL", "0")
    return JSession(JMC(**_mc(c)), jm, sc)


@pytest.mark.parametrize("family", ["llama", "llama_gqa", "gptj", "gptneox",
                                    "gpt2", "opt"])
def test_greedy_token_exact_with_jax_at_batch_2(family, monkeypatch):
    """Two ragged prompts (6 and 3 tokens, left-padded, bucketed to 8), 12
    new tokens, layer by layer on both sides."""
    from eddie_wang_hackathon2023_tpu.runtime import \
        SamplingConfig as JSampling
    _, jm, pm, c = _built(family)
    ids = np.random.RandomState(4).randint(0, 96, (2, 6)).astype(np.int32)
    lens = np.asarray([6, 3], np.int32)
    pt, pl, pc = GenerationSession(
        ModelConfig(**_mc(c)), pm,
        SamplingConfig(end_id=-1, pad_id=96)).decode(ids, lens,
                                                     max_new_tokens=12)
    jt, jl, jc = _jax_session(jm, c, JSampling(end_id=-1, pad_id=96),
                              monkeypatch).decode(ids, lens,
                                                  max_new_tokens=12)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_allclose(pc, jc, rtol=1e-4, atol=1e-5)


def test_llama_beams_token_exact_with_jax(monkeypatch):
    """Beam 3 over two prompts, 8 new tokens, through the cache
    indirection table on both sides."""
    from eddie_wang_hackathon2023_tpu.runtime import \
        SamplingConfig as JSampling
    _, jm, pm, c = _built("llama")
    ids = np.random.RandomState(5).randint(0, 96, (2, 5)).astype(np.int32)
    lens = np.asarray([5, 4], np.int32)
    sc = dict(end_id=-1, pad_id=96, num_beams=3)
    pt, pl, pc = GenerationSession(
        ModelConfig(**_mc(c)), pm, SamplingConfig(**sc)).decode(
            ids, lens, max_new_tokens=8)
    jt, jl, jc = _jax_session(jm, c, JSampling(**sc), monkeypatch).decode(
        ids, lens, max_new_tokens=8)
    assert pt.shape == (2, 3, 13)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_allclose(pc, jc, rtol=1e-4, atol=1e-5)


def _serve(cbm, req_cls, sc, model, prompts, **kw):
    results = {}
    queue = [req_cls(i, p, max_new_tokens=8, end_id=-1)
             for i, p in enumerate(prompts)]

    def get_requests(n):
        return [queue.pop(0)] if queue else []

    def send(r):
        if r.finished:
            results[r.request_id] = [int(t) for t in r.output_ids]

    cbm(model, sc, max_batch_size=2, max_seq_len=32, paged=True,
        tokens_per_block=8, get_inference_requests=get_requests,
        send_response=send, **kw).run()
    return results


def test_llama_paged_serving_token_exact_with_jax():
    """Four prompts of 2-7 tokens through 2 slots of a block-paged pool (8
    tokens a block), 8 new tokens each: RoPE at each row's own position."""
    from eddie_wang_hackathon2023_tpu.runtime.batch_manager import \
        ContinuousBatchingManager as JManager
    from eddie_wang_hackathon2023_tpu.runtime.batch_manager import \
        InferenceRequest as JRequest
    from eddie_wang_hackathon2023_tpu.runtime.sampling import \
        SamplingConfig as JSampling
    _, jm, pm, _ = _built("llama")
    rs = np.random.RandomState(8)
    prompts = [rs.randint(0, 96, n).astype(np.int32) for n in (5, 2, 7, 3)]
    got = _serve(ContinuousBatchingManager, InferenceRequest,
                 SamplingConfig(end_id=-1, pad_id=96), pm, prompts,
                 device="cpu")
    want = _serve(JManager, JRequest, JSampling(end_id=-1, pad_id=96), jm,
                  prompts)
    assert sorted(got) == list(range(4)) and got == want


@pytest.mark.parametrize("quant", ["woq8", "woq4"])
@torch.inference_mode()
def test_llama_weight_only_matches_jax(quant, monkeypatch):
    """The quantised state bit-equal (the gate quantised like fc and
    proj), a prefill's logits, and greedy tokens at batch 2."""
    from eddie_wang_hackathon2023_tpu.runtime import \
        SamplingConfig as JSampling
    hf, jm, pm, c = _built("llama", quant)
    jsd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    state = families.FAMILIES["llama"][1](hf.state_dict(), c)
    q = quantize_state(state, c)
    assert "blocks.mlp.gate.qweight" in q
    assert sorted(q) == sorted(jsd)
    for k in q:
        assert np.array_equal(np.asarray(q[k]), jsd[k]), k
    tokens = np.array([[3, 11, 25, 40, 7]], dtype=np.int32)
    jl, _ = jm(jnp.asarray(tokens), jm.new_kv_cache(1, 16), 0,
               jnp.array([5]))
    lg, _ = pm(torch.from_numpy(tokens).long(), pm.new_kv_cache(1, 16), 0,
               torch.tensor([5], dtype=torch.int32))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=1e-4)
    ids = np.random.RandomState(6).randint(0, 96, (2, 5)).astype(np.int32)
    lens = np.asarray([5, 2], np.int32)
    pt, pl, _ = GenerationSession(
        ModelConfig(**_mc(c)), pm,
        SamplingConfig(end_id=-1, pad_id=96)).decode(ids, lens,
                                                     max_new_tokens=8)
    jt, jl_, _ = _jax_session(jm, c, JSampling(end_id=-1, pad_id=96),
                              monkeypatch).decode(ids, lens,
                                                  max_new_tokens=8)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pl, jl_)


def test_no_port_module_imports_transformers_or_jax():
    """The mappers take a state dict: no module of the port imports
    ``transformers``, ``jax`` or the JAX package."""
    import ast
    root = os.path.join(os.path.dirname(__file__), "..",
                        "eddie_wang_hackathon2023_tpu_torch")
    bad = []
    for dirpath, _, names in os.walk(root):
        for name in names:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            for node in ast.walk(ast.parse(open(path).read())):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import)
                        else [node.module or ""]
                        if isinstance(node, ast.ImportFrom) else [])
                for m in mods:
                    top = m.split(".")[0]
                    if top in ("transformers", "jax",
                               "eddie_wang_hackathon2023_tpu"):
                        bad.append((path, m))
    assert not bad


def test_from_jax_state_takes_the_family_keys():
    """A separate LM head with its bias (GPT-J), RMSNorm weights without a
    bias and the gate (LLaMA) carry over from the JAX layout."""
    for family in ("gptj", "llama"):
        _, jm, _, c = _built(family)
        sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
        model = from_jax_state(sd, c, device="cpu")
        got = model.state_dict()
        if family == "gptj":
            assert torch.equal(got["lm_head.bias"],
                               torch.from_numpy(sd["lm_head.bias"]))
        else:
            assert "blocks.0.post_layernorm.bias" not in got
            assert torch.equal(got["blocks.1.mlp.gate.weight"],
                               torch.from_numpy(
                                   sd["blocks.mlp.gate.weight"][1]))
