"""Per-request sampling in the port's serving against the JAX package on the
CPU, token for token.  Both managers serve the same seeded HF GPT-2
(``tests/test_batch_manager.py``'s sharp model) and the same requests; the
port's noise is the JAX manager's own: its ``_gumbel(shape, where)`` is
replaced by ``jax.random.gumbel`` under the key the JAX manager folds for
the same draw (an admission's from its seed, slot and tick, a decode
tick's step from the tick and the step, a mixed tick's from the tick),
since ``jax.random.categorical(key, x)`` is ``argmax(x + gumbel(key,
x.shape))``.  Tokens are compared exactly.

* every knob as the manager's config: top-k, top-p, temperature (at the
  widest top-k), the repetition and presence penalties, min_length, bad
  words (one and two tokens) and stop words;
* requests with their own sampling beside the manager's defaults (a
  greedy request, top-p with stop words, penalties with a top-k past
  ``max_top_k``; the manager's bad words on top of a request's own);
* the same mix under ``steps_per_tick`` 2 and 4 and under mixed admission
  (dense and paged)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eddie_wang_hackathon2023_tpu_torch.runtime import (
    ContinuousBatchingManager, InferenceRequest, SamplingConfig)
from test_torch_serving_modes import (END, PROMPTS,  # noqa: F401
                                      one_thread, sharp)
from test_torch_whisper import one_cpu_thread  # noqa: F401 (a fixture)


def jax_noise(seed: int):
    """``_gumbel(shape, where)`` giving the JAX manager's noise of the draw
    ``where`` (its keys: ``runtime/batch_manager.py`` :858-860 for an
    admission, :1316 and :621 for a decode tick's step, :740 for a mixed
    tick)."""
    base = jax.random.PRNGKey(seed)

    def gumbel(shape, where):
        if where[0] == "admit":
            _, slot, s, tick = where
            key = jax.random.fold_in(base, (s * 1000003 + slot + tick)
                                     % (2 ** 31))
        elif where[0] == "tick":
            key = jax.random.fold_in(jax.random.fold_in(base, where[1]),
                                     where[2])
        else:
            key = jax.random.fold_in(base, where[1])
        return torch.from_numpy(np.array(
            jax.random.gumbel(key, tuple(shape), jnp.float32)))
    return gumbel


def serve(side, model, sc_kw, prompts=PROMPTS, own=None, new=10,
          end_ids=None, **kw):
    """{request id: output tokens} of one drain through the JAX manager or
    the port's (its noise the JAX manager's), the requests released one a
    poll.  ``sc_kw``: the manager's SamplingConfig fields; ``own``: a
    request's own fields (None: the manager's config); ``end_ids``: a
    request's end id (None: the config's)."""
    if side == "jax":
        from eddie_wang_hackathon2023_tpu.runtime.batch_manager import (
            ContinuousBatchingManager as Manager, InferenceRequest as Req)
        from eddie_wang_hackathon2023_tpu.runtime.sampling import \
            SamplingConfig as Sampling
    else:
        Manager, Req, Sampling = (ContinuousBatchingManager,
                                  InferenceRequest, SamplingConfig)
        kw["device"] = "cpu"
    base = dict(end_id=END, pad_id=END)
    own = own or [None] * len(prompts)
    end_ids = end_ids or [None] * len(prompts)
    queue = [Req(i, np.asarray(p, np.int32), max_new_tokens=new,
                 end_id=end_ids[i],
                 sampling=None if own[i] is None else Sampling(
                     **{**base, **own[i]}))
             for i, p in enumerate(prompts)]
    results = {}

    def send(r):
        if r.finished:
            results[r.request_id] = [int(t) for t in r.output_ids]
    sc = Sampling(**{**base, **sc_kw})
    mgr = Manager(model, sc, max_batch_size=2, max_seq_len=64,
                  get_inference_requests=lambda n: [queue.pop(0)] if queue
                  else [], send_response=send, **kw)
    if side == "port":
        mgr._gumbel = jax_noise(sc.random_seed)
    mgr.run()
    return results


def both(model_pair, sc_kw, **kw):
    """(JAX tokens, port tokens) of one drain."""
    jm, pm = model_pair
    return serve("jax", jm, sc_kw, **kw), serve("port", pm, sc_kw, **kw)


def greedy(model_pair):
    return serve("port", model_pair[1], {})


KNOBS = {
    "top_k": dict(temperature=0.8, top_k=5, random_seed=3),
    "top_p": dict(temperature=0.8, top_k=0, top_p=0.9, random_seed=3),
    # top_k <= 1 with top_p <= 0 is greedy: the widest top-k the manager
    # keeps (max_top_k)
    "temperature": dict(temperature=1.5, top_k=64, random_seed=4),
    "repetition_penalty": dict(repetition_penalty=1.8),
    "presence_penalty": dict(presence_penalty=3.0, temperature=0.6,
                             top_k=8, random_seed=5),
}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_each_knob_token_exact_with_jax(sharp, knob):  # noqa: F811
    """Four prompts through 2 slots, 10 new tokens, the knob in the
    manager's config: the port's tokens equal the JAX manager's, and differ
    from greedy decoding (the knob acts)."""
    want, got = both(sharp, KNOBS[knob])
    assert got == want and sorted(got) == [0, 1, 2, 3]
    assert got != greedy(sharp)


def test_min_length_token_exact_with_jax(sharp):  # noqa: F811
    """The end id is request 0's second greedy token: without min_length it
    ends there; with min_length 6 (greedy and sampled at top-k 4) it cannot
    end before 6 new tokens, as in the JAX manager."""
    base = greedy(sharp)
    end = base[0][1]
    ends = [end] * len(PROMPTS)
    short = serve("port", sharp[1], {}, end_ids=ends)
    assert short[0] == base[0][:2]
    for kw in (dict(min_length=6),
               dict(min_length=6, temperature=0.9, top_k=4, random_seed=9)):
        want, got = both(sharp, kw, end_ids=ends)
        assert got == want
        assert len(got[0]) >= 6 and end not in got[0][:5]


def test_bad_and_stop_words_token_exact_with_jax(sharp):  # noqa: F811
    """Bad words: request 0's first greedy token alone (banned always) and
    a two-token word made of request 2's first two greedy tokens (its
    second banned after its first); stop words: tokens 3 and 4 of request
    0's greedy output, which ends it there with the word kept.  Greedy and
    sampled (top-k 6), token-exact with the JAX manager."""
    base = greedy(sharp)
    bad = [[base[0][0]], base[2][:2]]
    stop = [base[0][2:4]]
    for kw in (dict(bad_words_list=bad), dict(stop_words_list=stop),
               dict(bad_words_list=bad, stop_words_list=stop,
                    temperature=0.9, top_k=6, random_seed=2)):
        want, got = both(sharp, kw)
        assert got == want
        if "temperature" not in kw and "bad_words_list" in kw:
            assert base[0][0] not in got[0]
            assert got[2][:2] != base[2][:2]
        if "temperature" not in kw and "stop_words_list" in kw:
            assert got[0] == base[0][:4]


# the manager's defaults, and each request's own sampling beside them
DEFAULTS = dict(temperature=0.7, top_k=6, random_seed=5,
                bad_words_list=[[17]])
OWN = [None,                                      # the manager's
       dict(temperature=0.0),                      # greedy (+ its bans)
       dict(temperature=0.9, top_k=0, top_p=0.8, random_seed=8,
            stop_words_list=[[50, 60], [2]]),
       dict(temperature=0.8, top_k=100, repetition_penalty=1.4,
            presence_penalty=0.5, min_length=3, random_seed=1,
            bad_words_list=[[9, 10]])]


def _mix_prompts():
    return PROMPTS + [[21, 22, 23], list(range(30, 48))]


@pytest.mark.parametrize("mode", [
    dict(), dict(steps_per_tick=2), dict(steps_per_tick=4),
    dict(mixed_admission=True, chunk_width=16),
    dict(mixed_admission=True, chunk_width=16, paged=True,
         tokens_per_block=8),
    dict(paged=True, tokens_per_block=8, steps_per_tick=2)],
    ids=["plain", "spt2", "spt4", "mixed_dense", "mixed_paged",
         "paged_spt2"])
def test_per_request_sampling_token_exact_with_jax(sharp, mode):  # noqa
    """Six requests through 2 slots, each with its own sampling or the
    manager's (``OWN``, cycled), the manager's defaults sampled at top-k 6
    with a bad word: token-exact with the JAX manager in each mode; the
    greedy request equals a greedy run under the manager's bad word."""
    prompts = _mix_prompts()
    own = [OWN[i % len(OWN)] for i in range(len(prompts))]
    want, got = both(sharp, DEFAULTS, prompts=prompts, own=own, **mode)
    assert got == want and sorted(got) == list(range(len(prompts)))
    assert all(17 not in toks for toks in got.values())
    if not mode:
        plain = serve("port", sharp[1], dict(bad_words_list=[[17]]),
                      prompts=prompts)
        assert got[1] == plain[1] and got[5] == plain[5]
