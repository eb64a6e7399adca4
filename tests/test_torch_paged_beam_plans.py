"""The host-side plans of the paged decode kernel and of the beam entry of
the decode kernel, as pure functions, on the CPU (a few seconds, no JAX).

The wrappers in ``ops/decode_attention.py`` decide each plan and pass it to
the C entry, which checks it and refuses any other:

* ``paged_plan(max_blocks, T, rep)`` (``csrc/paged_decode_attention.cu``): a
  cluster of at most 8 blocks over the table's tokens, each a slice of
  ``width`` tokens walked by ``warps`` warps of 32 tokens in ``rounds``
  rounds, ``heads`` query heads a block (one at rep 1: no padded query
  lane);
* ``beam_plan(S, bw, D, itemsize)`` (``csrc/decode_attention.cu``): kernel
  1's split of the S columns (``decode_splits``, ``split_width``), walked in
  rounds of ``cols`` columns (a multiple of 16, at most 256), times ``rs``
  splits of the group's bw source rows (any bw), at most 8 blocks a
  cluster, each block's rows staged ``rows`` at a time, so that the panels
  fit a block's shared memory.

Each test emulates, in Python, what the kernel does with the plan: which
tokens or columns each (rank, round, warp) takes for a row of a given
length and start, so that every valid pool block's token and every valid
column is covered exactly once; and what the C entry checks, so that the
plan is one it takes."""
import math

import pytest

from eddie_wang_hackathon2023_tpu_torch.ops import decode_attention as da

# the C entries' limits (csrc/paged_decode_attention.cu, decode_attention.cu)
MAX_SPLITS = 8
SMEM_LIMIT = 226 * 1024


def paged_entry_accepts(plan, MB, T, rep, D):
    """The checks of the C entry ``paged_decode_attention`` on a plan."""
    s, w, wa, r, h = (plan[k] for k in ("splits", "width", "warps",
                                        "rounds", "heads"))
    return (1 <= s <= MAX_SPLITS and w >= 32 and w % 32 == 0
            and s * w >= MB * T and (s - 1) * w < MB * T
            and wa in (1, 2, 4) and r == -(-w // (wa * 32))
            and h in (1, 2) and 1 <= rep <= 128 and D % 16 == 0
            and 16 <= D <= 128)


def paged_tokens(plan, MB, T, seq):
    """[(rank, round, warp, token)] of every token the kernel reads for a
    row of length ``seq``, as its ``round_span`` takes them."""
    cap = MB * T
    seq = min(seq, cap)
    if seq <= 0:
        return []
    per_round = plan["warps"] * 32
    out = []
    for rank in range(plan["splits"]):
        lo_r = rank * plan["width"]
        hi_r = min(seq, lo_r + plan["width"])
        n_r = max(0, hi_r - lo_r)
        n_rounds = -(-n_r // per_round)
        assert n_rounds <= plan["rounds"]
        for ro in range(n_rounds):
            for warp in range(plan["warps"]):
                base = lo_r + ro * per_round + warp * 32
                nv = min(max(hi_r - base, 0), 32)
                out += [(rank, ro, warp, base + t) for t in range(nv)]
    return out


PAGED_SHAPES = {
    # (max_blocks, T, rep, D)
    "serve": (4, 32, 1, 64),            # GPT-350M: 16 KV heads of 64
    "mqa": (4, 32, 16, 128),            # one KV head under 16 query heads
    "gqa": (9, 16, 4, 64),
    "pool past 2^31": (3, 32, 16, 128),
    "long": (1000, 16, 1, 64),
    "rep 128": (5, 8, 128, 128),
}


@pytest.mark.parametrize("shape", sorted(PAGED_SHAPES))
def test_paged_plan_covers_each_token_once(shape):
    MB, T, rep, D = PAGED_SHAPES[shape]
    plan = da.paged_plan(MB, T, rep)
    assert paged_entry_accepts(plan, MB, T, rep, D)
    lengths = range(0, MB * T + 2) if MB * T <= 1024 else (
        0, 1, 31, 32, 33, MB * T // 3, MB * T - 1, MB * T, MB * T + 5)
    for seq in lengths:
        toks = [t for *_, t in paged_tokens(plan, MB, T, seq)]
        assert sorted(toks) == list(range(min(seq, MB * T)))
        # each pool block of the row's table is read by the tokens it holds
        blocks = {t // T for t in toks}
        assert blocks == set(range(-(-min(seq, MB * T) // T)))


@pytest.mark.parametrize("T", [1, 8, 16, 32, 64])
@pytest.mark.parametrize("MB", [1, 2, 3, 4, 5, 8, 9, 33, 64, 257])
def test_paged_plan_limits(MB, T):
    """The cluster is at most 8, from the table width alone; every slice
    holds tokens; a block's warps are a power of 2, at most 4."""
    for rep in (1, 2, 3, 4, 16, 128):
        plan = da.paged_plan(MB, T, rep)
        assert paged_entry_accepts(plan, MB, T, rep, 64)
        assert 1 <= plan["splits"] <= MAX_SPLITS
        assert plan["warps"] <= da.PAGED_WARPS
        assert plan["heads"] >= min(rep, da.PAGED_HEADS)
        assert plan["heads"] < 2 * rep or plan["heads"] == 1
        assert (plan["splits"] - 1) * plan["width"] < MB * T


def test_paged_plan_at_the_serve_shape():
    """The serve path (table width 4 of 32 tokens, rep 1): one block of 4
    warps a (KV head, row), one round, one query head a block."""
    assert da.paged_plan(4, 32, 1) == dict(splits=1, width=128, warps=4,
                                           rounds=1, heads=1)
    assert da.paged_plan(4, 32, 16)["heads"] == da.PAGED_HEADS


def beam_entry_accepts(plan, S, bw, D, itemsize):
    """The checks of the C entry ``beam_decode_attention`` on a plan."""
    s, w, c, r, rs, rows = (plan[k] for k in ("splits", "width", "cols",
                                              "rounds", "rs", "rows"))
    return (S >= 4 and S % 4 == 0 and bw >= 1 and 1 <= s
            and 1 <= rs <= bw and s * rs <= MAX_SPLITS
            and w >= 4 and w % 4 == 0 and s * w >= S and (s - 1) * w < S
            and 16 <= c <= 256 and c % 16 == 0 and r == -(-w // c)
            and 1 <= rows <= -(-bw // rs) and D <= 128
            and da.beam_smem_bytes(min(bw, 16), rows, D, c, itemsize,
                                   s * rs) <= SMEM_LIMIT)


def beam_rows(plan, bw):
    """Each row split's source rows [r_lo, r_lo + nr), as the kernel takes
    them."""
    rs = plan["rs"]
    return [range(ri * bw // rs, (ri + 1) * bw // rs) for ri in range(rs)]


def beam_row_rounds(plan, bw):
    """Each row split's rounds of source rows, ``rows`` at a time, as the
    kernel's ``pair`` takes them."""
    return [[part[t:t + plan["rows"]]
             for t in range(0, len(part), plan["rows"])]
            for part in beam_rows(plan, bw)]


def beam_columns(plan, S, seq, start):
    """[(rank, round, column)] of every cached column the beam entry reads
    for a group of length ``seq`` (the fresh token included) and ``start``,
    as its ``span`` takes them."""
    cache_len = min(seq - 1, S)
    out = []
    for rank in range(plan["splits"]):
        c_begin = rank * plan["width"]
        lo_b = max(start, c_begin)
        hi_b = min(cache_len, c_begin + plan["width"])
        if lo_b >= hi_b:
            continue
        c_first = (lo_b - c_begin) // plan["cols"]
        c_last = (hi_b - 1 - c_begin) // plan["cols"]
        assert c_last < plan["rounds"]
        for c in range(c_first, c_last + 1):
            col0 = c_begin + c * plan["cols"]
            va, vb = max(lo_b - col0, 0), min(hi_b - col0, plan["cols"])
            # the copies: 4-column groups inside the row
            assert 0 <= va < vb and ((vb + 3) & ~3) + col0 <= S
            out += [(rank, c, col0 + j) for j in range(va, vb)]
    return out


@pytest.mark.parametrize("S,bw,D,itemsize", [
    (448, 5, 64, 2),          # the beam path: large-v2 self cache, beam 5
    (448, 5, 64, 1),
    (448, 1, 64, 2),
    (448, 3, 64, 2),
    (1500, 5, 64, 2),         # the rounding pin's S
    (1500, 5, 64, 1),
    (1504, 5, 128, 2),
    (4, 5, 64, 2),
    (16, 2, 64, 2),
    (2048, 16, 64, 2),
    (2048, 8, 128, 2),
    (2063 // 4 * 4, 5, 64, 2),
    (448, 17, 64, 2),         # two tiles of query beams
    (448, 33, 64, 1),
    (1500, 16, 128, 2),       # the rows staged in two rounds
    (1500, 24, 128, 2),
    (2048, 40, 128, 1),
])
@pytest.mark.parametrize("groups", [1, 2])
def test_beam_plan_covers_each_column_once(S, bw, D, itemsize, groups):
    """Every valid column of each group (lengths from 1 to S + 1, a start
    inside a slice, a start that masks a whole slice) is read by exactly
    one (rank, round) of the cluster; the plan is one the C entry takes."""
    plan = da.beam_plan(S, bw, D, itemsize)
    assert beam_entry_accepts(plan, S, bw, D, itemsize)
    assert plan["splits"] == da.decode_splits(S)
    assert plan["width"] == da.split_width(S, plan["splits"])
    # each source row of the group is staged by exactly one row split, in
    # exactly one of its rounds
    rows = [r for part in beam_rows(plan, bw) for r in part]
    assert rows == list(range(bw)) and all(beam_rows(plan, bw))
    rounds = [r for part in beam_row_rounds(plan, bw) for rr in part
              for r in rr]
    assert rounds == rows
    assert all(0 < len(rr) <= plan["rows"]
               for part in beam_row_rounds(plan, bw) for rr in part)
    seqs = sorted({1, 2, 44, S // 2, S // 2 + 1, S, S + 1})
    starts = (0, 9, plan["width"] + 3 if plan["splits"] > 1 else S // 2)
    for g in range(groups):
        for seq in seqs:
            for start in starts:
                cols = [c for *_, c in beam_columns(plan, S, seq + g, start)]
                want = list(range(start, min(seq + g - 1, S)))
                assert sorted(cols) == want


@pytest.mark.parametrize("bw", [1, 2, 5, 8, 12, 16, 17, 24, 64])
@pytest.mark.parametrize("S", [448, 1500])
def test_beam_plan_rounds_fit_the_budget(S, bw):
    """A round's panels fit a block and are the widest that do (up to 256
    columns) with all of a block's source rows; where even 16 columns of
    them do not fit (past 12 rows at head dim 128 in bf16 at S 1500), 16
    columns of the most rows that do.  Every beam width has a plan."""
    for D, itemsize in ((64, 2), (128, 2), (64, 1)):
        plan = da.beam_plan(S, bw, D, itemsize)
        c, rows, nr = plan["cols"], plan["rows"], -(-bw // plan["rs"])
        qn, blocks = min(bw, 16), plan["splits"] * plan["rs"]
        assert beam_entry_accepts(plan, S, bw, D, itemsize)
        assert da.beam_smem_bytes(qn, rows, D, c, itemsize,
                                  blocks) <= da.KERNEL_SMEM
        if rows == nr:
            assert (c >= plan["width"] or c == da.BEAM_COLS
                    or da.beam_smem_bytes(qn, rows, D, c + 16, itemsize,
                                          blocks) > da.KERNEL_SMEM)
        else:
            assert c == 16 and da.beam_smem_bytes(
                qn, rows + 1, D, c, itemsize, blocks) > da.KERNEL_SMEM
        assert plan["rounds"] == math.ceil(plan["width"] / c)
    assert da.beam_plan(448, 16, 128, 2)["rs"] == 2
    # at S 1500 the 6 slices leave no room to split the rows over blocks
    assert da.beam_plan(1500, 12, 128, 2)["rows"] == 12
    assert da.beam_plan(1500, 13, 128, 2)["rows"] == 12


def test_beam_plan_at_the_beam_path_shape():
    """Whisper large-v2 at beam 5 (S 448): two slices of 224, each in one
    round, times 2 splits of the 5 source rows (a cluster of 4), so a
    length of 44 takes the first slice's 2 blocks, of 2 and 3 rows."""
    plan = da.beam_plan(448, 5, 64, 2)
    assert plan == dict(splits=2, width=224, cols=224, rounds=1, rs=2,
                        rows=3)
    assert [list(r) for r in beam_rows(plan, 5)] == [[0, 1], [2, 3, 4]]
    assert {(r, c) for r, c, _ in beam_columns(plan, 448, 44, 0)} == {(0, 0)}
