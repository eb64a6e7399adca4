"""The megakernel design probes (``tools/megakernel_probes.py`` and the
scripts ``tools/megakernel_probe{,2,3}.py``) against the JAX package's
``benchmarks/megakernel_probe{,2,3}.py``, on the CPU.

* each plain version against its Pallas kernel, run in interpret mode with
  the scripts' module constant ``NP`` cut to 3 panels (K = N = 1280 as in
  the scripts): ``probe_flat``, ``probe_hm`` at rows 20 and 60, the
  relayout's ``none`` and ``reshape`` and the pair projection's four modes,
  on the same seeded numpy inputs, within one bf16 step of the value
  (rtol 2^-7, atol 1e-5 of the largest magnitude: both sum in fp32 in
  their own order and round once to bf16);
* ``torch_baseline_flat``'s last panel against ``probe_xla``, which
  returns only the last panel (its ``lax.scan`` carry);
* the wrappers on CPU tensors run the plain versions, and refuse the
  shapes the kernels do not take (``ValueError``) on every device;
* the default item of the kernels (``item_plan``);
* a one-thread CPU rehearsal of each script's ``main(["--device",
  "cpu"])`` and of ``chip_smoke.py``'s probes path with the panels cut;
  ``--device cuda`` without a card exits non-zero;
* ``tools/megakernel_stage_probe.py``'s stamped source has a stamp at each
  of the megakernel's grid barriers, block 0's and every block's, and its
  stage and barrier tables;
* none of the new files imports jax or the JAX package."""
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
from jax.experimental.pallas import tpu as pltpu

jax.config.update("jax_default_device", jax.devices("cpu")[0])

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import megakernel_probes as mp  # noqa: E402

PANELS = 3
RTOL = 2 ** -7


def _module(name, *path):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_probes():
    """The three JAX scripts, loaded by path."""
    return tuple(_module(f"jax_megakernel_probe{i}", "benchmarks",
                         f"megakernel_probe{i}.py") for i in ("", "2", "3"))


@pytest.fixture
def cut(jax_probes, monkeypatch):
    for mod in jax_probes:
        monkeypatch.setattr(mod, "NP", PANELS)
    return jax_probes


@pytest.fixture
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, p=PANELS):
    """Seeded numpy operands: the int8 blob, x (bf16 values held in fp32),
    scales, the KV tile (bf16 values) and the pair-layout context."""
    rs = np.random.RandomState(seed)
    blob = rs.randint(-127, 128, (p, mp.K, mp.N)).astype(np.int8)
    x = (rs.randn(1, mp.K) * 0.1).astype(np.float32)
    scales = rs.rand(p, 1, mp.N).astype(np.float32) * 0.01
    kv = (rs.randn(1, mp.H, mp.D, mp.KV_COLS) * 0.1).astype(np.float32)
    ctx = (rs.randn(mp.HP, mp.DL) * 0.1).astype(np.float32)
    return blob, x, scales, kv, ctx


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


def _close(port, ref):
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(port.float().numpy(), ref, rtol=RTOL,
                               atol=1e-5 * np.abs(ref).max())


# -- the plain versions against the Pallas kernels, in interpret mode -------

def test_flat_matches_pallas(cut):
    blob, x, scales, _, _ = _inputs(0)
    with pltpu.force_tpu_interpret_mode():
        ref = cut[0].probe_flat(jnp.asarray(blob), jnp.asarray(
            x, jnp.bfloat16), jnp.asarray(scales))
    out = mp.probe_flat(torch.from_numpy(blob), _bf16(x),
                        torch.from_numpy(scales))
    assert out.shape == ref.shape == (PANELS, 1, mp.N)
    _close(out, ref)


@pytest.mark.parametrize("rows", [20, 60])
def test_hm_matches_pallas(cut, rows):
    np_ = mp.hm_panels(rows, PANELS)
    rs = np.random.RandomState(rows)
    blob = rs.randint(-127, 128, (np_, rows, mp.K, mp.D)).astype(np.int8)
    xb = (rs.randn(rows, 1, mp.K) * 0.1).astype(np.float32)
    s = rs.rand(np_, rows, mp.D).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = cut[0].probe_hm(jnp.asarray(blob), jnp.asarray(xb, jnp.bfloat16),
                              jnp.asarray(s), rows, np_)
    out = mp.probe_hm(torch.from_numpy(blob), _bf16(xb), torch.from_numpy(s))
    assert out.shape == ref.shape == (np_, rows, mp.D)
    _close(out, ref)


@pytest.mark.parametrize("mode", ["none", "reshape"])
def test_relayout_matches_pallas(cut, mode):
    blob, x, _, kv, _ = _inputs(1)
    with pltpu.force_tpu_interpret_mode():
        ref = cut[1].probe(jnp.asarray(blob), jnp.asarray(x, jnp.bfloat16),
                           jnp.asarray(kv, jnp.bfloat16), mode)
    out = mp.probe_relayout(torch.from_numpy(blob), _bf16(x), _bf16(kv), mode)
    assert out.shape == ref.shape == (PANELS, 1, mp.N)
    _close(out, ref)


@pytest.mark.parametrize("mode", ["gemv", "pair_loop", "flat_f32",
                                  "flat_bf16"])
def test_pair_proj_matches_pallas(cut, mode):
    blob, _, _, _, ctx = _inputs(2)
    with pltpu.force_tpu_interpret_mode():
        ref = cut[2].probe(jnp.asarray(blob), jnp.asarray(ctx), mode)
    out = mp.probe_pair_proj(torch.from_numpy(blob), torch.from_numpy(ctx),
                             mode)
    assert out.shape == ref.shape == (PANELS, 1, mp.N)
    _close(out, ref)


def test_torch_baseline_matches_probe_xla(cut):
    """``probe_xla`` returns its scan's carry, the last panel [1, N]; the
    port's loop returns every panel, the last of them equal to it."""
    blob, x, scales, _, _ = _inputs(3)
    ref = cut[0].probe_xla(jnp.asarray(blob), jnp.asarray(x, jnp.bfloat16),
                           jnp.asarray(scales))
    out = mp.torch_baseline_flat(torch.from_numpy(blob), _bf16(x),
                                 torch.from_numpy(scales))
    assert ref.shape == (1, mp.N) and out.shape == (PANELS, 1, mp.N)
    _close(out[-1], ref)
    _close(out, np.asarray(mp.plain_probe_flat(
        torch.from_numpy(blob), _bf16(x), torch.from_numpy(scales)).float()))


# -- shapes and items ------------------------------------------------------

def _refused():
    blob = torch.zeros(2, 1280, 1280, dtype=torch.int8)
    x = torch.zeros(1, 1280, dtype=torch.bfloat16)
    s = torch.zeros(2, 1, 1280)
    kv = torch.zeros(1, 20, 64, 128, dtype=torch.bfloat16)
    ctx = torch.zeros(10, 128)
    hm = torch.zeros(2, 20, 1280, 64, dtype=torch.int8)
    xb = torch.zeros(20, 1, 1280, dtype=torch.bfloat16)
    s_hm = torch.zeros(2, 20, 64)
    return {
        "k_not_16": lambda: mp.probe_flat(blob[:, :1272], x[:, :1272], s),
        "n_not_32": lambda: mp.probe_flat(blob[..., :1264], x, s[..., :1264]),
        "cols_not_dividing": lambda: mp.probe_flat(
            blob[..., :1248], x, s[..., :1248], cols=256),
        "ksplit_uneven": lambda: mp.probe_flat(blob, x, s, cols=32, ksplit=3),
        "scales_shape": lambda: mp.probe_flat(blob, x, s[:1]),
        "hm_rows_off_the_panel": lambda: mp.probe_hm(hm, xb[:10], s_hm),
        "hm_not_64": lambda: mp.probe_hm(hm[..., :32], xb, s_hm[..., :32]),
        "relayout_kv_heads": lambda: mp.probe_relayout(blob, x, kv[:, :10],
                                                       "reshape"),
        "relayout_mode": lambda: mp.probe_relayout(blob, x, kv, "transpose"),
        "pair_blob_off_the_ctx": lambda: mp.probe_pair_proj(
            blob[:, :640, :640], ctx, "pair_loop"),
        "pair_ctx_shape": lambda: mp.probe_pair_proj(blob, ctx[:5],
                                                     "flat_f32"),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    with pytest.raises(ValueError):
        _refused()[case]()


def test_cpu_tensors_take_the_plain_versions():
    blob, x, scales, kv, ctx = (torch.from_numpy(a) for a in _inputs(4, 2))
    x, kv = x.bfloat16(), kv.bfloat16()
    mp.reset_launches()
    assert torch.equal(mp.probe_flat(blob, x, scales),
                       mp.plain_probe_flat(blob, x, scales))
    assert torch.equal(mp.probe_relayout(blob, x, kv, "reshape"),
                       mp.plain_probe_relayout(blob, x, kv, "reshape"))
    assert torch.equal(mp.probe_pair_proj(blob, ctx, "pair_loop"),
                       mp.plain_probe_pair_proj(blob, ctx, "pair_loop"))
    assert mp.launches == {k: 0 for k in mp.launches}


def test_item_plan():
    """The widest item of the whole of K where the grid fills the card;
    one panel splits K until two blocks an SM or 80-row slices."""
    assert mp.item_plan(128, 1280, 1280, 132) == (256, 1)
    assert mp.item_plan(42 * 60, 64, 1280, 132) == (64, 1)
    assert mp.item_plan(128, 1280, 128, 132) == (256, 1)
    assert mp.item_plan(1, 1280, 1280, 132) == (256, 16)
    assert mp.item_plan(8, 1280, 1280, 132) == (256, 8)


# -- the scripts and chip_smoke's probes path, rehearsed on the CPU ----------

SCRIPTS = ("megakernel_probe", "megakernel_probe2", "megakernel_probe3")


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_runs_on_cpu(name, one_cpu_thread, monkeypatch, capsys):
    script = _module(name, "tools", f"{name}.py")
    monkeypatch.setattr(script, "NP", PANELS)
    mp.reset_launches()
    assert script.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith(f"{name} OK")
    assert "not timed" in out and " ms " not in out
    assert mp.launches == {k: 0 for k in mp.launches}


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_without_a_card_exits_nonzero(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    script = _module(name, "tools", f"{name}.py")
    assert script.main(["--device", "cuda"]) != 0


def test_chip_smoke_probes_path_on_cpu(one_cpu_thread, capsys):
    smoke = _module("chip_smoke", "chip_smoke.py")
    rows = {k: v for k, v in smoke.KERNELS.items()
            if smoke.PATH_OF[k] == "probes"}
    assert {k: (v["source"], v["replaces"]) for k, v in rows.items()} == {
        "probe_flat_gemv": ("tools/megakernel_probes.cu",
                            "benchmarks/megakernel_probe.py:61"),
        "probe_hm_gemv": ("tools/megakernel_probes.cu",
                          "benchmarks/megakernel_probe.py:85"),
        "probe_relayout": ("tools/megakernel_probes.cu",
                           "benchmarks/megakernel_probe2.py:48"),
        "probe_pair_proj": ("tools/megakernel_probes.cu",
                            "benchmarks/megakernel_probe3.py:48")}
    assert set(rows) == set(mp.launches)
    e2e, counts = smoke.probes_path(torch, device="cpu", panels=PANELS)
    assert counts == {k: 0 for k in rows}
    out = capsys.readouterr().out
    for name in SCRIPTS:
        assert f"{name} OK" in out


# -- the stage probe's stamps ------------------------------------------------

def test_stage_probe_stamps_every_barrier():
    sp = _module("megakernel_stage_probe", "tools",
                 "megakernel_stage_probe.py")
    src = open(os.path.join(REPO, "eddie_wang_hackathon2023_tpu_torch",
                            "csrc", "decoder_layer.cu")).read()
    # the layer is a loop over its 8 stages, each ending in one grid
    # barrier, 6 of them with a GEMV and its wait in the ring
    assert "for (int st = 0; st < kLayerStages; ++st)" in src
    assert "constexpr int kLayerStages = 8;" in src and len(sp.STAGES) == 8
    assert src.count("grid_sync(a.barrier, gen);") == 1
    assert src.count("gemv_stage(a, ring, l, g,") == 1
    assert src.count(sp.RING_WAIT) == 1
    out = sp.stamped_source(src)
    assert out.count("STAMP();") == 4      # kernel start, end; barrier in, out
    # every block: its start, barrier in and out
    assert [out.count(f"BSTAMP({s});") for s in (-1, 0, 1)] == [1, 1, 1]
    # block 0: before and after the ring's wait
    assert [out.count(f"WSTAMP({s});") for s in (0, 1)] == [1, 1]
    wait = out[out.index("uint32_t ring_wait("):]
    wait = wait[:wait.index("\n}\n")]
    assert (wait.index("WSTAMP(0);") < wait.index("mbar_wait(")
            < wait.index("WSTAMP(1);"))
    body = out[out.index("void grid_sync("):]
    body = body[:body.index("\n}\n")]
    assert body.count("STAMP();") == 2
    assert body.index("STAMP();") < body.index("BSTAMP(0);") < body.index(
        "__syncthreads();")
    assert body.rstrip().endswith("__syncthreads();\n  STAMP();\n  BSTAMP(1);")
    for entry in ("read_stamps", "read_wait_stamps", "read_block_stamps"):
        assert f'extern "C" int {entry}' in out
    stripped = out.replace(
        "  if (sz) {\n    WSTAMP(0);\n    mbar_wait(", "  if (sz) mbar_wait(")
    stripped = stripped.replace(
        "(r.done / kSlots) & 1);\n    WSTAMP(1);\n  }\n",
        "(r.done / kSlots) & 1);\n")
    for line in ("  STAMP();\n", "  BSTAMP(-1);\n", "  BSTAMP(0);\n",
                 "  BSTAMP(1);\n"):
        stripped = stripped.replace(line, "")
    assert stripped.startswith(src[:100])
    body = stripped[stripped.index("\nnamespace {"):]
    assert body[:body.rindex('extern "C" int reset_stamps')].strip() == \
        src[src.index("\nnamespace {"):].strip()


def test_stage_table():
    sp = _module("megakernel_stage_probe", "tools",
                 "megakernel_stage_probe.py")
    # two layers: every stage works 10 and waits 3, the tail is 5
    stamps, t = [100], 100
    for _ in range(2 * len(sp.STAGES)):
        stamps += [t + 10, t + 13]
        t += 13
    stamps.append(t + 5)
    work, wait, total, tail = sp.stage_table(stamps, 2)
    assert work == [20] * 8 and wait == [6] * 8
    assert total == 2 * 8 * 13 + 5 and tail == 5
    with pytest.raises(ValueError):
        sp.stage_table(stamps[:-1], 2)


def test_ring_waits():
    sp = _module("megakernel_stage_probe", "tools",
                 "megakernel_stage_probe.py")
    # two layers of six waits: wait i lasts i + 1
    waits = [(10 * i, 10 * i + i + 1) for i in range(12)]
    assert sp.ring_waits(waits, 2) == [1 + 7, 2 + 8, 3 + 9, 4 + 10, 5 + 11,
                                       6 + 12]
    with pytest.raises(ValueError):
        sp.ring_waits(waits[:-1], 2)


def test_gemv_split():
    sp = _module("megakernel_stage_probe", "tools",
                 "megakernel_stage_probe.py")
    # one layer: stage s's barrier entered at 100 s + 90, left at 100 s +
    # 100; start at 0; each GEMV stage waits for its weights from 10 to 20
    # after the previous barrier's exit (the start, for the first)
    stamps = [0]
    for st in range(len(sp.STAGES)):
        stamps += [100 * st + 90, 100 * st + 100]
    stamps.append(900)
    waits = [(100 * st + 10, 100 * st + 20) for st in sp.GEMV_AT]
    before, after = sp.gemv_split(stamps, waits, 1)
    assert before == [10] * 6 and after == [70] * 6


def test_sass_sizes():
    sp = _module("megakernel_stage_probe", "tools",
                 "megakernel_stage_probe.py")
    listing = """
\t\tFunction : _Z10megakernelIaEv8MegaArgs
        /*0000*/                   MOV R1, c[0x0][0x28] ;   /* 0x000 */
                                                             /* 0x000 */
        /*0010*/                   S2R R0, SR_TID.X ;       /* 0x000 */
\t\tFunction : _Z10megakernelI13__nv_bfloat16Ev8MegaArgs
        /*0000*/                   EXIT ;                   /* 0x000 */
"""
    assert sp.sass_sizes(listing) == {"_Z10megakernelIaEv8MegaArgs": 2,
                                      "_Z10megakernelI13__nv_bfloat16Ev8"
                                      "MegaArgs": 1}


def test_barrier_table():
    sp = _module("megakernel_stage_probe", "tools",
                 "megakernel_stage_probe.py")
    # one layer, two blocks starting at 0 and 2; block 1 arrives 4 after
    # block 0 at every barrier, the release comes 1 after the last arrival,
    # block 1 leaves 1 after block 0
    n = len(sp.STAGES)
    entries, exits, t = [[], []], [[], []], 0
    for _ in range(n):
        entries[0].append(t + 10)
        entries[1].append(t + 14)
        exits[0].append(t + 15)
        exits[1].append(t + 16)
        t += 15
    bar = sp.barrier_table([0, 2], entries, exits, 1)
    assert bar["behind"] == [4] * n and bar["latency"] == [1] * n
    assert bar["spread"] == [4] * n and bar["span"] == [14] * n
    # block 0's wait splits into behind + latency
    assert all(x - e == b + lat for x, e, b, lat in zip(
        exits[0], entries[0], bar["behind"], bar["latency"]))
    with pytest.raises(ValueError):
        sp.barrier_table([0, 2], entries, [exits[0], exits[1][:-1]], 1)


def test_tools_import_no_jax():
    code = textwrap.dedent("""
        import importlib.util, sys
        sys.modules["jax"] = None
        sys.path.insert(0, "tools")
        import megakernel_probes
        for name in ("megakernel_probe", "megakernel_probe2",
                     "megakernel_probe3", "megakernel_stage_probe"):
            spec = importlib.util.spec_from_file_location(
                name, f"tools/{name}.py")
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
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
