"""Port parity: the neighborhood layout and the fused beam search.

- make_neighborhood_tables + pack_meta equal the JAX package's bit for
  bit on the same store and graph;
- the plain PyTorch version of kernel K1 (what the wrapper runs on CPU
  tensors) tracks the Pallas kernel in interpret mode on the same
  tables, at the shapes of tests/test_pallas_beam.py. The tolerances
  are that test's (id-set overlap >= 0.95, scores within 3e-3 where the
  ids agree), for the same reason: the bf16 rounding of the products
  may be kept or dropped by XLA's fusion on the JAX side;
- the properties the CUDA kernel's design rests on, held exactly on the
  plain version's own steps: an idle step is the identity (so stopping
  there equals the fixed trip count), the argmin selections are the
  first unexpanded finite positions, candidates at or above the beam's
  last score never enter, and placing by position equals the stable
  sort."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_vss_tpu.models.graph import (
    make_neighborhood_tables as j_tables,
    quantize_queries_i8 as j_quant,
)
from duckdb_vss_tpu.ops.pallas_beam import (TB, beam_search_pallas,
                                            pack_meta as j_pack)
from duckdb_vss_tpu.utils.config import MetricKind as JMetric
from duckdb_vss_tpu_torch.models.graph import (make_neighborhood_tables,
                                               quantize_queries_i8)
from duckdb_vss_tpu_torch.ops import fused_beam as fb
from duckdb_vss_tpu_torch.utils.config import MetricKind

torch.set_num_threads(2)


def _graph(seed, n=2048, d=128, m0=32):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    vecs[11] = 0.0  # an all-zero row: scale 1, all-zero int8 tile row
    vec_sq = (vecs * vecs).sum(1).astype(np.float32)
    nbr = rng.integers(0, n, (n, m0)).astype(np.int32)
    nbr[rng.random((n, m0)) < 0.1] = -1
    nbr[:4, 3] = 11
    return rng, vecs, vec_sq, nbr


def test_neighborhood_tables_and_meta_bitwise():
    _, vecs, vec_sq, nbr = _graph(0)
    jv, js, jq = j_tables(jnp.asarray(vecs), jnp.asarray(vec_sq),
                          jnp.asarray(nbr), chunk=512)
    jm = j_pack(jnp.asarray(nbr), js, jq)
    tv, ts, tq = make_neighborhood_tables(
        torch.from_numpy(vecs), torch.from_numpy(vec_sq),
        torch.from_numpy(nbr), chunk=300)
    tm = fb.pack_meta(torch.from_numpy(nbr), ts, tq)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm.shape == (2048, 128) and (tm[:, 96:] == -1).all()


def test_quantize_queries_bitwise():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(20, 128)).astype(np.float32)
    q[2] = 0.0
    # under jit, as the JAX package always runs it (inside its search and
    # insert programs): XLA then computes absmax / 127 as absmax *
    # f32(1/127), one ulp off the eager division for some rows
    j8, js = jax.jit(j_quant)(jnp.asarray(q))
    t8, ts = quantize_queries_i8(torch.from_numpy(q))
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("metric,ef", [("l2sq", 16), ("ip", 16),
                                       ("l2sq", 64)])
def test_plain_beam_matches_pallas_interpret(metric, ef):
    rng, vecs, vec_sq, nbr = _graph(3)
    n, d = vecs.shape
    m0, expand, steps, b = nbr.shape[1], 4, 6, TB
    tv, ts, tq = make_neighborhood_tables(
        torch.from_numpy(vecs), torch.from_numpy(vec_sq),
        torch.from_numpy(nbr))
    meta = fb.pack_meta(torch.from_numpy(nbr), ts, tq)
    q = rng.normal(size=(b, d)).astype(np.float32)
    q_sq = (q * q).sum(1).astype(np.float32)
    seeds = rng.integers(0, n, (b, ef)).astype(np.int32)
    seed_s = np.sort(np.abs(rng.normal(size=(b, ef))).astype(np.float32), 1)

    want_s, want_i, want_nd = beam_search_pallas(
        jnp.asarray(q), jnp.asarray(q_sq), jnp.asarray(seed_s),
        jnp.asarray(seeds), jnp.asarray(meta.numpy()),
        jnp.asarray(tv.numpy()), ef=ef, expand=expand, m0=m0, d=d,
        max_steps=steps, metric=JMetric(metric), interpret=True)
    calls = fb.beam_search_plain.calls
    launches = fb.fused_beam_search.launches
    got_s, got_i, got_nd, got_exp = fb.fused_beam_search(
        torch.from_numpy(q), torch.from_numpy(q_sq),
        torch.from_numpy(seed_s), torch.from_numpy(seeds), meta, tv,
        ef=ef, expand=expand, m0=m0, d=d, max_steps=steps,
        metric=MetricKind(metric))
    # CPU tensors take the plain version; no kernel launch is counted
    assert fb.beam_search_plain.calls == calls + 1
    assert fb.fused_beam_search.launches == launches

    got_i, want_i = got_i.numpy(), np.asarray(want_i)
    got_s, want_s = got_s.numpy(), np.asarray(want_s)
    overlap = np.mean([len(set(got_i[i]) & set(want_i[i])) / ef
                       for i in range(b)])
    assert overlap >= 0.95, overlap
    same = got_i == want_i
    np.testing.assert_allclose(got_s[same], want_s[same], rtol=3e-3,
                               atol=3e-3)
    assert int(got_nd) > 0 and abs(int(got_nd) - int(want_nd)) <= 0.05 * int(
        want_nd)
    # every step expands E live entries while the beam has unexpanded ones
    assert 0 < int(got_exp) <= b * steps * expand


def test_plain_beam_cosine_zero_norms_and_dead_beams():
    """Cosine epilogue with zero-norm queries and rows, and queries whose
    seed beam is empty (no live selection: nothing is read or kept)."""
    rng, vecs, vec_sq, nbr = _graph(5, n=512)
    tv, ts, tq = make_neighborhood_tables(
        torch.from_numpy(vecs), torch.from_numpy(vec_sq),
        torch.from_numpy(nbr))
    meta = fb.pack_meta(torch.from_numpy(nbr), ts, tq)
    b, ef = 8, 16
    q = rng.normal(size=(b, 128)).astype(np.float32)
    q[1] = 0.0
    q_sq = (q * q).sum(1).astype(np.float32)
    seeds = rng.integers(0, 512, (b, ef)).astype(np.int32)
    seed_s = np.sort(np.abs(rng.normal(size=(b, ef))).astype(np.float32), 1)
    seeds[7] = -1
    seed_s[7] = fb.INF_SCORE
    s, i, nd, n_exp = fb.beam_search_plain(
        torch.from_numpy(q), torch.from_numpy(q_sq), torch.from_numpy(seed_s),
        torch.from_numpy(seeds), meta, tv, ef=ef, expand=4, m0=32, d=128,
        max_steps=5, metric=MetricKind.COSINE)
    s, i = s.numpy(), i.numpy()
    assert (i[7] == -1).all() and (s[7] >= fb.INF_SCORE).all()
    # a zero query scores exactly 1 against every nonzero row
    assert np.all(s[1][i[1] >= 0] <= 1.0)
    assert np.all(np.diff(s, axis=1) >= 0)  # beams stay ascending
    for row in i:
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)  # no repeats
    assert int(nd) > 0 and int(n_exp) <= 7 * 5 * 4


def _beam_inputs(seed, metric, b=12, ef=16, n=256, m0=32, empty=False):
    """A small graph's tables and an ascending seed beam. Query 1 is a
    zero vector and query 2 has an empty beam; with ``empty`` every beam
    is."""
    rng, vecs, vec_sq, nbr = _graph(seed, n=n, m0=m0)
    tv, ts, tq = make_neighborhood_tables(
        torch.from_numpy(vecs), torch.from_numpy(vec_sq),
        torch.from_numpy(nbr))
    meta = fb.pack_meta(torch.from_numpy(nbr), ts, tq)
    q = rng.normal(size=(b, 128)).astype(np.float32)
    q[1] = 0.0
    seeds = rng.integers(0, n, (b, ef)).astype(np.int32)
    seed_s = np.sort(np.abs(rng.normal(size=(b, ef))).astype(np.float32), 1)
    seeds[:, 6:], seed_s[:, 6:] = -1, fb.INF_SCORE  # six seeds, INF padded
    seeds[3, 5] = seeds[3, 0]  # a repeated seed keeps its id beside INF
    seed_s[3, 5] = fb.INF_SCORE
    dead = slice(None) if empty else 2
    seeds[dead], seed_s[dead] = -1, fb.INF_SCORE
    q_t = torch.from_numpy(q)
    tables = (meta[:, :m0],
              meta[:, m0:2 * m0].contiguous().view(torch.float32),
              meta[:, 2 * m0:3 * m0].contiguous().view(torch.float32), tv)
    state = (torch.from_numpy(seed_s), torch.from_numpy(seeds),
             torch.zeros((b, ef), dtype=torch.bool))
    kw = dict(ef=ef, expand=4, m0=m0, d=128, metric=MetricKind(metric))
    return state, (q_t.to(torch.bfloat16), (q_t * q_t).sum(1)), tables, kw, \
        (q_t, meta, tv)


@pytest.mark.parametrize("metric,empty", [("l2sq", False), ("ip", False),
                                          ("cosine", False), ("l2sq", True)])
def test_idle_step_is_identity_so_early_exit_is_exact(metric, empty):
    """Once a step selects nothing, that step and every later one leave
    the beam, its flags and both counts as they are (the first merge
    alone turns ids beside INF into -1). A loop that stops at a query's
    first idle step therefore equals the fixed trip count. Exact."""
    steps = 40
    state, qs, tables, kw, (q_t, meta, tv) = _beam_inputs(7, metric,
                                                          empty=empty)
    b = state[0].shape[0]
    frozen = [None] * b  # beam and counts at each query's first idle step
    n_dist_q = torch.zeros(b, dtype=torch.int64)
    n_exp_q = torch.zeros(b, dtype=torch.int64)
    for step in range(steps):
        s, i, e, kept, live = fb.plain_step(*state, *qs, *tables, **kw)
        idle = (live == 0).numpy()
        assert (kept[live == 0] == 0).all()
        for r in np.nonzero(idle)[0]:
            before = [t[r] for t in state]
            if step == 0:  # the first merge writes -1 beside INF
                before[1] = torch.where(before[0] >= fb.INF_SCORE, -1,
                                        before[1])
            for got, want in zip((s[r], i[r], e[r]), before):
                assert torch.equal(got, want)
            if frozen[r] is None:
                frozen[r] = (s[r], i[r], int(n_dist_q[r]), int(n_exp_q[r]))
        n_dist_q, n_exp_q = n_dist_q + kept, n_exp_q + live
        state = (s, i, e)
    assert all(f is not None for f in frozen), "a query never went idle"
    n_dist, n_exp = int(n_dist_q.sum()), int(n_exp_q.sum())
    if empty:
        assert n_dist == 0 and n_exp == 0 and (state[1] == -1).all()
    else:
        assert n_exp > b  # the live queries did expand
    # the search that stops at the first idle step == the fixed trip count
    for r, (s_r, i_r, nd_r, ne_r) in enumerate(frozen):
        assert torch.equal(s_r, state[0][r]) and torch.equal(i_r, state[1][r])
        assert nd_r == int(n_dist_q[r]) and ne_r == int(n_exp_q[r])
    seed_s, seed_i, _ = _beam_inputs(7, metric, empty=empty)[0]
    want = fb.beam_search_plain(q_t, qs[1], seed_s, seed_i, meta, tv,
                                max_steps=steps, **kw)
    assert torch.equal(want[0], state[0]) and torch.equal(want[1], state[1])
    assert int(want[2]) == n_dist and int(want[3]) == n_exp


def _first_unexpanded(beam_s, beam_e, expand):
    """The kernel's selection: the first E positions that are unexpanded
    and finite; (pos, ok) with dead selections at position 0."""
    ok = (~beam_e & (beam_s < fb.INF_SCORE)).numpy()
    pos = np.zeros((len(ok), expand), np.int64)
    live = np.zeros((len(ok), expand), bool)
    for r, row in enumerate(ok):
        hits = np.nonzero(row)[0][:expand]
        pos[r, :len(hits)] = hits
        live[r, :len(hits)] = True
    return pos, live


@pytest.mark.parametrize("expand", [1, 4, 8])
def test_argmin_selection_is_first_unexpanded_positions(expand):
    """On an ascending beam the E argmin passes (ties to the lowest
    position) pick the first E unexpanded finite positions, at every
    step, ties included. Exact."""
    state, qs, tables, kw, _ = _beam_inputs(9, "l2sq")
    kw["expand"] = expand
    # ties: pairs of equal seed scores
    state[0][:, 1] = state[0][:, 0]
    state[0][:, 3] = state[0][:, 2]
    seen_dead = seen_live = False
    for _ in range(16):
        pos, ok, marked = fb.plain_select(state[0], state[2], expand)
        want_pos, want_ok = _first_unexpanded(state[0], state[2], expand)
        np.testing.assert_array_equal(ok.numpy(), want_ok)
        np.testing.assert_array_equal(pos.numpy()[want_ok],
                                      want_pos[want_ok])
        want_marked = state[2].clone()
        for r in range(len(want_pos)):
            want_marked[r, want_pos[r][want_ok[r]]] = True
        assert torch.equal(marked, want_marked)
        seen_dead |= bool((~want_ok).any())
        seen_live |= bool(want_ok.any())
        assert (np.diff(state[0].numpy(), axis=1) >= 0).all()  # ascending
        state = fb.plain_step(*state, *qs, *tables, **kw)[:3]
    assert seen_dead and seen_live


def _merge_by_position(beam_s, beam_i, beam_e, cand_s, cand_i, ef):
    """The kernel's merge, one query: drop candidates >= the beam's last
    score, rank the survivors by (score, block position), add the beam
    entries <= each (binary search); a beam entry moves down by the
    survivors strictly below it."""
    new_s = np.full(ef, np.nan, np.float32)
    new_i = np.full(ef, -7, np.int64)
    new_e = np.zeros(ef, bool)
    surv = [c for c in range(len(cand_s)) if cand_s[c] < beam_s[ef - 1]]
    for j in range(ef):
        pos = j + sum(cand_s[c] < beam_s[j] for c in surv)
        if pos < ef:
            new_s[pos], new_e[pos] = beam_s[j], beam_e[j]
            new_i[pos] = -1 if beam_s[j] >= fb.INF_SCORE else beam_i[j]
    for c in surv:
        rank = sum((cand_s[u] < cand_s[c])
                   or (cand_s[u] == cand_s[c] and u < c) for u in surv)
        pos = rank + int(np.searchsorted(beam_s, cand_s[c], side="right"))
        if pos < ef:
            new_s[pos], new_i[pos], new_e[pos] = cand_s[c], cand_i[c], False
    return new_s, new_i, new_e


@pytest.mark.parametrize("seed,fill", [(0, 16), (1, 16), (2, 9), (3, 0)])
def test_pruned_merge_by_position_equals_stable_sort(seed, fill):
    """Scores are small integers, so ties abound: with the beam, among
    the candidates, with the beam's last score. Dropping the candidates
    at or above the beam's last score before the stable merge gives the
    same beam, and so does placing by position. Exact."""
    rng = np.random.default_rng(seed)
    b, ef, c = 32, 16, 24
    beam_s = np.sort(rng.integers(0, 12, (b, ef)).astype(np.float32), 1)
    beam_s[:, fill:] = fb.INF_SCORE
    beam_i = rng.integers(0, 1000, (b, ef))
    beam_e = rng.random((b, ef)) < 0.5
    cand_s = rng.integers(0, 14, (b, c)).astype(np.float32)
    cand_i = rng.integers(1000, 2000, (b, c))
    dropped = rng.random((b, c)) < 0.3  # masked by the dedup
    cand_s[dropped], cand_i[dropped] = fb.INF_SCORE, -1
    t = [torch.from_numpy(a) for a in (beam_s, beam_i, beam_e, cand_s,
                                       cand_i)]
    want = fb.plain_merge(*t, ef)
    pruned = t[3] >= t[0][:, ef - 1:ef]
    got = fb.plain_merge(t[0], t[1], t[2],
                         torch.where(pruned, fb.INF_SCORE, t[3]),
                         torch.where(pruned, -1, t[4]), ef)
    assert bool(pruned.any()) and not bool(pruned.all())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for r in range(b):
        s, i, e = _merge_by_position(beam_s[r], beam_i[r], beam_e[r],
                                     cand_s[r], cand_i[r], ef)
        np.testing.assert_array_equal(s, want[0][r].numpy())
        np.testing.assert_array_equal(i, want[1][r].numpy())
        np.testing.assert_array_equal(e, want[2][r].numpy())


def test_pruning_is_exact_on_real_steps(monkeypatch):
    """On the steps of a real search (ip scores, negative ones too):
    masking every candidate whose score is >= the beam's last score
    before the merge changes nothing."""
    state, qs, tables, kw, _ = _beam_inputs(11, "ip")
    merge = fb.plain_merge
    seen = [0]

    def pruned_merge(beam_s, beam_i, beam_e, cand_s, cand_i, ef):
        want = merge(beam_s, beam_i, beam_e, cand_s, cand_i, ef)
        drop = cand_s >= beam_s[:, ef - 1:ef]
        seen[0] += int((drop & (cand_s < fb.INF_SCORE)).sum())
        got = merge(beam_s, beam_i, beam_e,
                    torch.where(drop, fb.INF_SCORE, cand_s),
                    torch.where(drop, -1, cand_i), ef)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        return want

    monkeypatch.setattr(fb, "plain_merge", pruned_merge)
    for _ in range(12):
        state = fb.plain_step(*state, *qs, *tables, **kw)[:3]
    assert seen[0] > 0  # live candidates were pruned


@pytest.mark.parametrize("d", [16, 48, 128, 256])
def test_ordered_row_sum(d):
    """The plain version's stated sum order: exact on small integers
    (any order is), within f32 rounding of torch's own sum on floats,
    and add for add what the docstring says, for widths below, at and
    above one run of 128."""
    rng = np.random.default_rng(d)
    ints = rng.integers(-500, 500, (3, 5, d)).astype(np.float32)
    got = fb.ordered_row_sum(torch.from_numpy(ints))
    assert got.shape == (3, 5)
    np.testing.assert_array_equal(got.numpy(), ints.sum(-1))
    x = rng.normal(size=(7, d)).astype(np.float32)
    got = fb.ordered_row_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, x.astype(np.float64).sum(-1), rtol=0,
                               atol=1e-5)
    want = np.zeros(7, np.float32)
    for r in range(7):
        lanes = []
        for lane in range(8):
            a = [np.float32(0)] * 4
            for run in range(0, d, 128):
                for i in range(4):
                    for e in range(4):
                        k = run + 16 * lane + 4 * i + e
                        if k < d:
                            a[i] = np.float32(a[i] + x[r, k])
            lanes.append(np.float32(np.float32(a[0] + a[1])
                                    + np.float32(a[2] + a[3])))
        lanes = [np.float32(lanes[j] + lanes[j + 4]) for j in range(4)]
        lanes = [np.float32(lanes[j] + lanes[j + 2]) for j in range(2)]
        want[r] = np.float32(lanes[0] + lanes[1])
    np.testing.assert_array_equal(got, want)


def test_kernel_shape_checks():
    """The wrapper raises, never clamps, for shapes the kernel cannot
    take: shared memory over a Hopper block's 227 KB, or D not a
    multiple of 16."""
    fb.check_kernel_shapes(64, 4, 32, 128)  # the defaults fit
    fb.check_kernel_shapes(128, 8, 32, 128)
    # nine blocks of the default shape fit an SM's 227 KB (1 KB reserved
    # for each), four at ef 128 / expand 8
    assert fb.smem_bytes(64, 4, 32, 128) == 23856
    assert 9 * (fb.smem_bytes(64, 4, 32, 128) + 1024) <= 232_448
    assert 4 * (fb.smem_bytes(128, 8, 32, 128) + 1024) <= 232_448
    # more selections than eight are taken, each with a slot of its own
    # for its node, a staged meta row and a tile
    fb.check_kernel_shapes(64, 12, 8, 128)
    fb.check_kernel_shapes(64, 40, 4, 128)
    for e in (8, 9, 16, 33):
        assert (fb.smem_bytes(64, e + 1, 4, 128) - fb.smem_bytes(64, e, 4, 128)
                >= 4 + 4 * 12 + 4 * 128)
    # 8-byte words stay aligned for odd shapes too
    assert fb.smem_bytes(10, 3, 5, 16) % 4 == 0
    with pytest.raises(ValueError, match="shared memory"):
        fb.check_kernel_shapes(128, 8, 32, 1024)
    with pytest.raises(ValueError, match="multiple of 16"):
        fb.check_kernel_shapes(64, 4, 32, 120)
    with pytest.raises(ValueError):
        fb.check_kernel_shapes(4, 8, 32, 128)
