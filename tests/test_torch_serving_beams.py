"""Beam serving in the port's ``ContinuousBatchingManager`` against the JAX
package's on the CPU, token for token.  Both managers serve the same seeded
HF GPT-2 (``tests/test_batch_manager.py``'s sharp model, through
``test_torch_serving_modes.sharp``) and the same requests; where a request
samples, the port's noise is the JAX manager's own
(``test_torch_serving_sampling.jax_noise``: a width-1 admission's key, and
a beam tick's step k folded from the tick and k).

* dense beam serving (width 3, 2 slots, 3 prompts, 10 new tokens) equal to
  the JAX manager and to the port's offline ``GenerationSession``'s
  ``best_sequences`` (``tests/test_batch_manager.py:297-338``), also at
  two steps a tick;
* paged beams equal to dense beams at ``tokens_per_block=8`` (prompts of
  5, 3 and 7 tokens: the partial prompt block copied, and not), and a
  tight pool of ``2 * (3 * 3 + 1)`` blocks that recycles them;
* beams under mixed admission, dense and paged, a long prompt fed in three
  chunks and a greedy width-1 request beside them;
* greedy and sampled width-1 requests beside a beam request in one
  manager, with the JAX noise;
* beam stop words matched inside a ``steps_per_tick=4`` tick;
* MQA/GQA beams raising in both packages, and the refusals of widths
  past ``max_beam_width``."""
import numpy as np
import pytest

from eddie_wang_hackathon2023_tpu_torch.runtime import (
    ContinuousBatchingManager, GenerationSession, InferenceRequest,
    ModelConfig, SamplingConfig)
from test_torch_serving_modes import END, one_thread, sharp  # noqa: F401
from test_torch_serving_sampling import jax_noise
from test_torch_whisper import one_cpu_thread  # noqa: F401 (a fixture)

W = 3
PROMPTS = [[5, 11, 17, 23, 31], [40, 2, 9], [7, 8, 9, 10, 11, 12, 13]]


def serve(side, model, reqs, sc_kw=None, noise=None, mgrs=None, end=END,
          **kw):
    """{request id: output tokens} of one drain through the JAX manager
    (``side='jax'``) or the port's, the requests released one a poll.
    ``reqs``: (prompt, new tokens, the request's own SamplingConfig fields
    or None) each; ``sc_kw``: the manager's fields; ``noise``: the seed of
    the JAX noise the port's ``_gumbel`` is given; ``end``: the end and
    pad id."""
    if side == "jax":
        from eddie_wang_hackathon2023_tpu.runtime.batch_manager import (
            ContinuousBatchingManager as Manager, InferenceRequest as Req)
        from eddie_wang_hackathon2023_tpu.runtime.sampling import \
            SamplingConfig as Sampling
    else:
        Manager, Req, Sampling = (ContinuousBatchingManager,
                                  InferenceRequest, SamplingConfig)
        kw["device"] = "cpu"
    base = dict(end_id=end, pad_id=max(end, 0))
    queue = [Req(i, np.asarray(p, np.int32), max_new_tokens=n, end_id=end,
                 sampling=None if own is None else Sampling(**{**base,
                                                               **own}))
             for i, (p, n, own) in enumerate(reqs)]
    results = {}

    def send(r):
        if r.finished:
            results[r.request_id] = [int(t) for t in r.output_ids]
    mgr = Manager(model, Sampling(**{**base, **(sc_kw or {})}),
                  get_inference_requests=lambda n: [queue.pop(0)] if queue
                  else [], send_response=send, **kw)
    if side == "port" and noise is not None:
        mgr._gumbel = jax_noise(noise)
    if mgrs is not None:
        mgrs.append(mgr)
    mgr.run()
    return results


def beam_reqs(prompts=PROMPTS, new=10, width=W):
    return [(p, new, dict(num_beams=width)) for p in prompts]


def offline_best(pm, prompt, new, width=W):
    """The port's offline ``GenerationSession`` beam search of one prompt:
    its best sequence's new tokens."""
    sess = GenerationSession(
        ModelConfig(vocab_size=211, num_layers=3, num_heads=4,
                    hidden_size=48, max_seq_len=128), pm,
        SamplingConfig(end_id=END, pad_id=END, num_beams=width))
    t, lens, cum = sess.decode(np.asarray([prompt], np.int32),
                               np.array([len(prompt)]), max_new_tokens=new)
    best, best_lens = sess.best_sequences(t, lens, cum)
    return [int(x) for x in best[0, len(prompt):best_lens[0]]]


def test_dense_beam_serving_token_exact_with_jax_and_offline(sharp):
    """Three beam requests of width 3 through 2 slots of the dense slot
    cache (queued, a slot used twice), 10 new tokens: the port equals the
    JAX manager and the port's offline beam search; at two steps a tick
    too."""
    jm, pm = sharp
    kw = dict(max_batch_size=2, max_seq_len=64, max_beam_width=W)
    want = serve("jax", jm, beam_reqs(), **kw)
    mgrs = []
    got = serve("port", pm, beam_reqs(), mgrs=mgrs, **kw)
    assert got == want and sorted(got) == [0, 1, 2]
    for i, p in enumerate(PROMPTS):
        assert got[i] == offline_best(pm, p, 10)
    assert mgrs[0].prefills == 3 and mgrs[0].cache.shape[1] == 2 * W
    assert serve("port", pm, beam_reqs(), steps_per_tick=2, **kw) == \
        serve("jax", jm, beam_reqs(), steps_per_tick=2, **kw)


def test_paged_beams_equal_dense_and_a_tight_pool_recycles(sharp):
    """The same requests over the pool in blocks of 8 (prompts of 5, 3
    and 7 tokens: each prompt's partial block is copied into the sibling
    beams' private blocks) equal the dense beams and the JAX paged
    manager; a pool of 2 * (3 * 3 + 1) blocks, which holds two slots'
    chains and no more, recycles its blocks and serves the same."""
    jm, pm = sharp
    kw = dict(max_batch_size=2, max_seq_len=64, max_beam_width=W)
    dense = serve("port", pm, beam_reqs(), **kw)
    paged = dict(paged=True, tokens_per_block=8)
    mgrs = []
    assert serve("port", pm, beam_reqs(), mgrs=mgrs, **kw, **paged) == dense
    assert serve("jax", jm, beam_reqs(), **kw, **paged) == dense
    tight = dict(paged, num_blocks=2 * (W * 3 + 1))
    assert serve("port", pm, beam_reqs(), mgrs=mgrs, **kw, **tight) == dense
    assert mgrs[0].num_blocks == 2 * W * 8
    # every block back in the free list after the drain
    assert len(mgrs[1].kvman.blocks_manager.free_blocks) == 2 * (W * 3 + 1)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_beam_mixed_admission_token_exact_with_jax(sharp, paged):
    """``tests/test_batch_manager.py:340-369``'s requests (a prompt of 37
    tokens fed in three chunks of 16 while the other slot beam-decodes, a
    greedy width-1 request among three beam ones) through 2 slots: the
    port's mixed beam manager equals the JAX one and the port's beam
    manager without mixed admission; over the pool in blocks of 8."""
    jm, pm = sharp
    prompts = [[5, 11, 17, 23, 31], list(range(3, 40)), [40, 2, 9],
               [7, 8, 9, 10, 11, 12, 13]]
    reqs = [(p, 8, None if i == 2 else dict(num_beams=W))
            for i, p in enumerate(prompts)]
    kw = dict(max_batch_size=2, max_seq_len=64, max_beam_width=W)
    if paged:
        kw.update(paged=True, tokens_per_block=8)
    mixed = dict(mixed_admission=True, chunk_width=16)
    mgrs = []
    got = serve("port", pm, reqs, mgrs=mgrs, **kw, **mixed)
    assert got == serve("jax", jm, reqs, **kw, **mixed)
    assert got == serve("port", pm, reqs, **kw)
    assert mgrs[0].mixed_ticks >= 3 and mgrs[0].prefills == 0
    if not paged:
        # chunk_width columns of slack, rounded up to 4
        assert mgrs[0].cache.shape[-1] == 64 + 16


@pytest.mark.parametrize("spt", [1, 2])
def test_width_one_requests_beside_beams_with_jax_noise(sharp, spt):
    """A greedy request, a sampled one (top-k 5 at temperature 0.8) and a
    beam request of width 3, five requests in all through 2 slots of one
    beam manager whose own config samples: token-exact with the JAX
    manager, the port given the JAX noise of each draw; the greedy
    request equals a plain greedy manager's tokens up to its end id."""
    jm, pm = sharp
    greedy, samp = dict(temperature=0.0), dict(temperature=0.8, top_k=5,
                                               random_seed=3)
    beam = dict(num_beams=W)
    reqs = [([5, 11, 17, 23, 31], 10, greedy), ([40, 2, 9], 10, beam),
            ([7, 8, 9], 9, samp), ([3, 4], 7, None),
            ([21, 22, 23], 10, dict(beam, repetition_penalty=1.3))]
    sc_kw = dict(temperature=0.7, top_k=6, random_seed=5)
    kw = dict(max_batch_size=2, max_seq_len=64, max_beam_width=W,
              steps_per_tick=spt)
    want = serve("jax", jm, reqs, sc_kw, **kw)
    got = serve("port", pm, reqs, sc_kw, noise=5, **kw)
    assert got == want and sorted(got) == [0, 1, 2, 3, 4]
    plain = serve("port", pm, [reqs[0]], max_batch_size=2, max_seq_len=64)
    assert got[0] == [t for t in plain[0] if t != END][:len(got[0])]


def test_beam_stop_words_in_a_four_step_tick(sharp):
    """A beam request whose stop word is made of tokens 3 and 4 of its
    best sequence: the stopped beam freezes inside a four-step tick, so
    the tick gives the one-step manager's tokens (ending with the word),
    as the JAX manager's does (``tests/test_batch_manager.py:471-502``)."""
    jm, pm = sharp
    kw = dict(max_batch_size=2, max_seq_len=64, max_beam_width=W)
    base = serve("port", pm, beam_reqs([[5, 11, 17, 23, 31]]), **kw)[0]
    stop = dict(num_beams=W, stop_words_list=[base[2:4]])
    reqs = [([5, 11, 17, 23, 31], 10, stop)]
    one = serve("port", pm, reqs, steps_per_tick=1, **kw)[0]
    four = serve("port", pm, reqs, steps_per_tick=4, **kw)[0]
    assert four == one == serve("jax", jm, reqs, steps_per_tick=4, **kw)[0]
    assert len(one) < len(base) and one[-2:] == base[2:4]
    # a stop word longer than the device's word buffer cannot be matched
    # inside a multi-step tick (the JAX manager's refusal)
    long_stop = [(reqs[0][0], 10, dict(num_beams=W,
                                       stop_words_list=[[1, 2, 3, 4, 5]]))]
    for side, model in (("jax", jm), ("port", pm)):
        with pytest.raises(ValueError, match="max_bad_word_len"):
            serve(side, model, long_stop, steps_per_tick=2, **kw)


def test_gqa_beams_raise_in_both_packages():
    """A GQA decoder (4 query heads over 2 KV heads) serving a beam
    request: the JAX manager's beam step fails (its beam attention
    reshapes the cache with the query heads: TypeError), the port's
    attention raises ``NotImplementedError``; dense and paged."""
    from test_torch_decoder import GQA, _models
    jm, pm, _ = _models(GQA, False, seed=2)
    reqs = [([5, 6, 7], 4, dict(num_beams=2))]
    for paged in (dict(), dict(paged=True, tokens_per_block=8)):
        kw = dict(max_batch_size=1, max_seq_len=32, max_beam_width=2,
                  end=-1, **paged)
        with pytest.raises(TypeError):
            serve("jax", jm, reqs, **kw)
        with pytest.raises(NotImplementedError):
            serve("port", pm, reqs, **kw)


def test_widths_past_max_beam_width_raise(sharp):
    """A request of 4 beams in a manager of width 3 raises
    ``ValueError`` in both packages; the port also refuses a manager whose
    own config asks for more beams than it holds, and a beam request in a
    width-1 manager (which the JAX manager would serve greedily)."""
    jm, pm = sharp
    kw = dict(max_batch_size=2, max_seq_len=64, max_beam_width=W)
    for side, model in (("jax", jm), ("port", pm)):
        with pytest.raises(ValueError, match="beams"):
            serve(side, model, beam_reqs([[1, 2]], width=4), **kw)
    with pytest.raises(ValueError, match="max_beam_width"):
        ContinuousBatchingManager(pm, SamplingConfig(num_beams=4),
                                  max_beam_width=W, device="cpu")
    with pytest.raises(ValueError, match="max_beam_width"):
        serve("port", pm, beam_reqs([[1, 2]], width=2), max_batch_size=2,
              max_seq_len=64)


def test_beam_manager_state_after_a_drain(sharp):
    """After a drain the beam manager has answered every request once,
    holds no slot, and its counters say what ran (one admission prefill a
    request, as many decode steps as ticks at one step a tick)."""
    _, pm = sharp
    mgrs = []
    got = serve("port", pm, beam_reqs(), mgrs=mgrs, max_batch_size=2,
                max_seq_len=64, max_beam_width=W)
    mgr = mgrs[0]
    assert sorted(got) == [0, 1, 2] and not mgr.slot_request
    assert mgr.prefills == 3 and mgr.decode_steps == mgr.decode_ticks > 0
    assert mgr.sched.num_active == 0 and not mgr._beam_hist
