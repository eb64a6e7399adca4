"""The port's custom-attention hook (``ops.flash_attention.set_custom_mha``)
and its example kernel (``examples/custom_kernel_torch``) against the JAX
package, on the CPU at tiny sizes.

* ``plain_custom_flash_mha`` against the JAX package's Pallas FMHA
  (``examples/custom_kernel/pallas_fmha.py``, ``interpret=True``), fp32,
  1e-5: causal and not, ``kv_valid_len`` below Lk (and 0: rows of zeros),
  the 3- and 4-token prompt prefill, and Lq 128 with Lk 256, which pins
  the Pallas kernel's top-left causal mask (the built-in flash kernel
  masks bottom-right); a block that does not divide a length raises
  ``ValueError`` where the Pallas version asserts;
* the hook's routing, with a spy, as ``tests/test_custom_kernel_example.py``
  does for the JAX package: the encoder's pad-once calls carry
  ``kv_valid_len``, the empty-cache prefill is causal, ``None`` restores
  the built-in dispatch;
* the tiny Whisper encoder with the user kernel installed against the JAX
  encoder with the Pallas FMHA installed, fp32, 1e-5;
* the plain causal mode of the flash kernel against the JAX ``flash_mha``,
  fp32, 1e-5;
* a one-thread CPU rehearsal of ``chip_smoke.py``'s custom path, and the
  example's ``run.py --device cpu``;
* the example and ``chip_smoke.py`` import neither jax nor the JAX
  package."""
import importlib.util
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eddie_wang_hackathon2023_tpu.models.whisper import (
    CrossAttnKV as JCrossAttnKV, WhisperConfig as JConfig,
    WhisperDecoder as JDecoder, WhisperEncoder as JEncoder)
from eddie_wang_hackathon2023_tpu.ops.flash_attention import (
    flash_mha as j_flash_mha, set_custom_mha as j_set_custom_mha)
from eddie_wang_hackathon2023_tpu_torch.models.whisper import (
    WhisperConfig, from_jax_state)
from eddie_wang_hackathon2023_tpu_torch.ops import flash_attention as fa

jax.config.update("jax_default_device", jax.devices("cpu")[0])

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _module(name, *path):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ck = _module("fmha_cuda", "examples", "custom_kernel_torch", "fmha_cuda.py")
pallas_fmha = _module("pallas_fmha", "examples", "custom_kernel",
                      "pallas_fmha.py")

# the Whisper dims of test_torch_whisper.py: n_audio_ctx 150 >= 128, so the
# encoder pads once to 256 rows and masks the keys past 150
DIMS = dict(n_mels=80, n_vocab=51865, n_audio_ctx=150, n_audio_state=64,
            n_audio_head=4, n_audio_layer=2, n_text_ctx=48,
            n_text_state=64, n_text_head=4, n_text_layer=2, dtype="float32")
JCFG = JConfig(**DIMS)
PCFG = WhisperConfig(**DIMS)
MEL = (np.random.RandomState(7).randn(1, 80, 2 * DIMS["n_audio_ctx"])
       .astype(np.float32))


def _random_state(module, rs, scale=0.05):
    return {n: (rs.standard_normal(p._shape) * scale).astype(np.float32)
            for n, p in module.named_parameters()}


@pytest.fixture(scope="module")
def states():
    return tuple(_random_state(m, np.random.RandomState(seed))
                 for m, seed in ((JEncoder(JCFG), 0), (JDecoder(JCFG), 1),
                                 (JCrossAttnKV(JCFG), 2)))


@pytest.fixture
def no_hook():
    """Both packages' hooks removed after the test, whatever it did."""
    yield
    fa.set_custom_mha(None)
    j_set_custom_mha(None)


def _hook_off() -> bool:
    """No user kernel installed: a flash_mha call adds no hook call."""
    before = fa.launches["custom_mha"]
    x = torch.zeros(1, 1, 2, 4)
    fa.flash_mha(x, x, x)
    return fa.launches["custom_mha"] == before


# -- the user kernel's plain version against the Pallas FMHA ---------------

# (B, H, Lq, Lk, D, causal, kv_valid_len)
FMHA_CASES = {
    "full": (1, 2, 256, 256, 64, False, None),
    "causal": (1, 2, 256, 256, 64, True, None),
    "valid_200": (2, 2, 256, 256, 32, False, 200),
    "causal_valid_200": (1, 2, 256, 256, 32, True, 200),
    "no_live_key": (1, 2, 128, 128, 16, False, 0),
    "valid_past_lk": (1, 2, 128, 128, 16, True, 300),
    "prefill_lq3": (1, 4, 3, 3, 16, True, None),
    "prefill_lq4": (1, 4, 4, 4, 16, True, None),
    "top_left_lq128_lk256": (1, 2, 128, 256, 32, True, None),
}


@pytest.mark.parametrize("case", sorted(FMHA_CASES))
def test_plain_custom_fmha_matches_pallas(case):
    b, h, lq, lk, d, causal, valid = FMHA_CASES[case]
    rs = np.random.RandomState(sorted(FMHA_CASES).index(case))
    q = rs.randn(b, h, lq, d).astype(np.float32)
    k, v = (rs.randn(b, h, lk, d).astype(np.float32) for _ in range(2))
    ref = np.asarray(pallas_fmha.custom_flash_mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_valid_len=valid, interpret=True))
    before = dict(ck.launches)
    out = ck.custom_flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              kv_valid_len=valid)
    assert ck.launches == before          # CPU tensors: the plain version
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    if valid == 0:
        assert not out.any()
    if lq != lk:
        # top-left, not causal_bias's bottom-right: the two differ here
        br = fa.plain_flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True)
        assert not np.allclose(out.numpy(), br.numpy(), atol=1e-2)


def test_custom_fmha_refuses_blocks_that_do_not_divide():
    q = np.zeros((1, 1, 200, 16), np.float32)
    with pytest.raises(AssertionError):
        pallas_fmha.custom_flash_mha(jnp.asarray(q), jnp.asarray(q),
                                     jnp.asarray(q), interpret=True)
    for fn in (ck.custom_flash_mha, ck.plain_custom_flash_mha):
        with pytest.raises(ValueError, match="block multiples"):
            fn(*(torch.from_numpy(q),) * 3)
        # bm = min(64, 200) = 64 does not divide 200 either
        with pytest.raises(ValueError):
            fn(*(torch.from_numpy(q[:, :, :128]),) * 3, block_n=96)


# -- the built-in causal mode against the JAX flash_mha --------------------

@pytest.mark.parametrize("valid", [None, 200])
def test_plain_causal_flash_matches_jax(valid):
    rs = np.random.RandomState(11)
    q, k, v = (rs.randn(1, 2, 256, 64).astype(np.float32) for _ in range(3))
    ref = np.asarray(j_flash_mha(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, scale=0.125,
                                 kv_valid_len=valid))
    for fn in (fa.flash_mha, fa.plain_flash_mha):
        out = fn(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v), causal=True, scale=0.125,
                 kv_valid_len=valid)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_kernel_takes_only_what_the_kernel_computes():
    """The built-in dispatch's static shape test: CPU tensors, and causal
    calls of fewer than MIN_FLASH_LEN query rows, at head dims other than
    64 or with more query rows than keys keep the plain version; every
    non-causal call on the card goes to the kernel, which refuses head dims
    other than 64 rather than hide the missing mode."""
    q = torch.empty(1, 2, 256, 64)
    assert not fa.kernel_takes(q, q, causal=True)        # not on the card
    assert not fa.kernel_takes(q, q)
    cuda_like = type("T", (), {"is_cuda": True, "shape": (1, 2, 256, 64)})
    short = type("T", (), {"is_cuda": True, "shape": (1, 2, 127, 64)})
    d128 = type("T", (), {"is_cuda": True, "shape": (1, 2, 256, 128)})
    assert fa.kernel_takes(cuda_like, cuda_like, causal=True)
    assert fa.kernel_takes(cuda_like, cuda_like)
    assert not fa.kernel_takes(short, short, causal=True)
    assert fa.kernel_takes(short, short)
    assert not fa.kernel_takes(d128, d128, causal=True)
    assert fa.kernel_takes(d128, d128)
    assert not fa.kernel_takes(cuda_like, short, causal=True)
    assert fa.kernel_takes(cuda_like, short, causal=False)


# -- the hook's routing ----------------------------------------------------

def _port(states):
    return from_jax_state(*states, PCFG, recipe="none", device="cpu")


@torch.inference_mode()
def test_set_custom_mha_routes_context_calls(states, no_hook):
    enc, dec, ckv = _port(states)
    calls = []

    def spy(q, k, v, *, causal, scale, kv_valid_len):
        calls.append((tuple(q.shape), tuple(k.shape), causal, scale,
                      kv_valid_len))
        return fa.plain_flash_mha(q, k, v, causal, scale, kv_valid_len)

    mel = torch.from_numpy(MEL)
    base = enc(mel)
    fa.reset_launches()
    fa.set_custom_mha(spy)
    xa = enc(mel)
    hd = DIMS["n_audio_state"] // DIMS["n_audio_head"]
    # the encoder's pad-once calls: 150 rows padded to 256, keys masked
    assert calls == [((1, 4, 256, hd), (1, 4, 256, hd), False, hd ** -0.5,
                      150)] * DIMS["n_audio_layer"]
    torch.testing.assert_close(xa, base, rtol=0, atol=0)
    # the empty-cache prefill of a 3-token prompt: causal, no length
    calls.clear()
    cross = ckv(xa)
    tokens = torch.tensor([[50258, 50259, 50359]])
    logits, _ = dec(tokens, dec.new_kv_cache(1), cross, 0, 3)
    assert [(c[0][2], c[2], c[4]) for c in calls] == [
        (3, True, None)] * DIMS["n_text_layer"]
    n = DIMS["n_audio_layer"] + DIMS["n_text_layer"]
    assert fa.launches["custom_mha"] == n
    # removed: the built-in dispatch again, and the same prefill logits
    fa.set_custom_mha(None)
    calls.clear()
    ref, _ = dec(tokens, dec.new_kv_cache(1), cross, 0, 3)
    torch.testing.assert_close(enc(mel), base, rtol=0, atol=0)
    assert not calls and _hook_off()
    torch.testing.assert_close(logits, ref, rtol=0, atol=0)


def test_hook_result_is_copied_into_out(no_hook):
    rs = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, 8, 16).astype(np.float32))
               for _ in range(3))
    fa.set_custom_mha(ck.custom_flash_mha)
    buf = torch.empty(1, 8, 2, 16)
    res = fa.flash_mha(q, k, v, causal=True, out=buf.transpose(1, 2))
    ref = ck.plain_custom_flash_mha(q, k, v, causal=True)
    assert torch.equal(buf.transpose(1, 2), ref) and torch.equal(res, ref)


# -- the tiny encoder with the hook against JAX's with its hook -------------

@torch.inference_mode()
def test_hooked_encoder_matches_jax_hooked_encoder(states, no_hook):
    enc_sd = states[0]
    jenc = JEncoder(JCFG)
    jenc.load_state_dict(dict(enc_sd))
    seen = []

    def j_hook(q, k, v, **kw):
        seen.append(kw["kv_valid_len"])
        return pallas_fmha.custom_flash_mha(q, k, v, interpret=True, **kw)

    j_set_custom_mha(j_hook)
    ref = np.asarray(jenc(MEL))
    j_set_custom_mha(None)
    # traced once for the scanned blocks
    assert seen and set(seen) == {150}
    enc, _, _ = _port(states)
    fa.reset_launches()
    fa.set_custom_mha(ck.custom_flash_mha)
    out = enc(torch.from_numpy(MEL)).numpy()
    assert fa.launches["custom_mha"] == DIMS["n_audio_layer"]
    assert out.shape == ref.shape == (1, 150, 64)
    # fp32 on both sides, the same function: 1e-5
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


# -- chip_smoke's custom path and the example, rehearsed on the CPU --------

@pytest.fixture
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_custom_path_on_cpu(one_cpu_thread, no_hook):
    """The custom path at a tiny size with head dim 64 as on the card:
    the bench recipe's model, transcription without, with and again
    without the hook (prompted), the hook's 2 + 2 calls, the encoder and
    the teacher-forced logits against the plain path, the timing.  No
    kernel launches from CPU tensors."""
    smoke = _module("chip_smoke", "chip_smoke.py")
    from eddie_wang_hackathon2023_tpu_torch.models.whisper import \
        BENCH_RECIPE
    cfg = WhisperConfig(**{**DIMS, "n_audio_state": 128, "n_audio_head": 2,
                           "n_text_state": 128, "n_text_head": 2,
                           "n_text_ctx": 96})
    built = smoke.build_whisper(torch, np, cfg, "cpu", BENCH_RECIPE,
                                "custom")
    e2e, counts = smoke.custom_path(torch, np, built, device="cpu")
    assert e2e["hook_calls_per_utt"] == 4
    assert counts["custom_mha"] == 4
    assert all(counts[k] == 0 for k in smoke.KERNELS
               if smoke.PATH_OF[k] == "custom")
    # sot_prev + the prompt cut to n_text_ctx // 2 - 1 + 3 sot tokens
    assert e2e["prompted_prefill_len"] == 1 + 47 + 3
    assert e2e["logits_rel_err"] < 1e-5
    assert e2e["encoder_block_rms_rel_err"] < 2e-2
    assert e2e["utt_per_s_hook"] > 0 and e2e["utt_per_s_builtin"] > 0
    assert _hook_off()


def test_example_runs_on_cpu():
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples",
                                      "custom_kernel_torch", "run.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.rstrip().endswith("custom kernel example OK")


def test_example_and_chip_smoke_import_no_jax():
    code = textwrap.dedent("""
        import importlib.util, os, sys
        sys.modules["jax"] = None
        for name, path in (
                ("fmha_cuda", "examples/custom_kernel_torch/fmha_cuda.py"),
                ("run", "examples/custom_kernel_torch/run.py"),
                ("chip_smoke", "chip_smoke.py")):
            spec = importlib.util.spec_from_file_location(name, path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        import eddie_wang_hackathon2023_tpu_torch.models.whisper
        bad = [m for m in sys.modules
               if m == "eddie_wang_hackathon2023_tpu"
               or m.startswith("eddie_wang_hackathon2023_tpu.")
               or (m.startswith("jax") and sys.modules[m] is not None)]
        assert not bad, bad
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0 and res.stdout.startswith("ok"), (
        res.stdout + res.stderr)
