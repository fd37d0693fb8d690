"""The tables a search reads and the choice of its path, for HNSWIndex
and for ShardedHNSWIndex on a grid of CPU slots, at small sizes.

- Which derived tables (the upper-level table, the int8 neighborhood
  layout with its meta rows, the bf16 traversal copy, the augmented
  table) each mutation keeps and which it drops. The single index:
  an incremental add keeps the layout (it refreshes the rows it
  changes) and drops the rest; the bulk path drops everything; a
  capacity growth drops the layout and the upper table; isolate drops
  the layout; compact drops everything; remove drops nothing. The
  sharded index drops every table of every replica row on every
  mutation but remove, which keeps them all.
- The layout gate on each side of ``nbr_budget_bytes``: the single
  index takes the layout on the CPU within the budget, the sharded
  index's ``"auto"`` only on CUDA, its budget summed over the shards
  that share a device.
- Which descent and which base beam run: the mxu descent (a spy on
  graph.mxu_descent) or the beam descent (graph.beam_descent); kernel
  K1 (its plain version's call count on the CPU) while the layout is on
  and ef <= 128, else the step-by-step beam.
- Both compactions against a plain reference of the plan: live nodes
  first by level descending, then by old slot; every edge remapped,
  edges into tombstones dropped; dead rows +0.0 in the single index,
  multiplied by zero in the sharded one.
"""

import numpy as np
import pytest
import torch

from duckdb_vss_tpu_torch.models import graph as tgraph
from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex
from duckdb_vss_tpu_torch.ops import fused_beam as fb
from duckdb_vss_tpu_torch.parallel import sharded as tsh
from duckdb_vss_tpu_torch.utils.config import HNSWConfig

torch.set_num_threads(2)

D = 16
CFG = dict(m=8, m0=16)
NAMES = ("upper", "nbr", "trav", "aug")


def _rows(seed, n, d=D):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(32, d)).astype(np.float32)
    return (centers[rng.integers(0, 32, n)]
            + 0.3 * rng.normal(size=(n, d))).astype(np.float32)


# -- what each index has built ----------------------------------------------

def built(idx) -> dict:
    """name -> the single index's built table, None where it has none."""
    return {n: idx.tables.built.get(n) for n in NAMES}


def build_all(idx) -> None:
    """Build every table the single index can hold."""
    idx.tables.upper()
    idx.tables.neighborhood(idx.layout, idx.nbr_budget_bytes)
    idx.tables.traversal(idx.traversal_dtype)
    idx.tables.aug()


def traversal(idx):
    return idx.tables.traversal(idx.traversal_dtype)


def layout_on(idx) -> bool:
    return idx.tables.use_layout(idx.layout, idx.nbr_budget_bytes)


def shard_built(sh) -> dict:
    """(replica row, local shard) -> name -> built table or None."""
    return {key: {n: t.built.get(n) for n in NAMES}
            for key, t in sh.tables.items()}


def build_shards(sh) -> None:
    sh.search_tables()


def shard_budget_ok(sh) -> bool:
    return all(t.fits(sh.nbr_budget_bytes) for t in sh.tables.values())


# -- the single index ---------------------------------------------------------

def single(layout="neighborhood", n=600, cap=1024, **kw):
    idx = HNSWIndex(D, HNSWConfig(**CFG), capacity=cap, device="cpu",
                    build_batch=64, layout=layout, use_aug=True, **kw)
    idx.bulk_threshold = 64
    if n:
        idx.add(_rows(1, n), np.arange(n))
    return idx


# every mutation of the single index, and the tables it drops
SINGLE_DROPS = {
    "add": ({"upper", "trav", "aug"},
            lambda idx: idx.add(_rows(2, 40), np.arange(10_000, 10_040))),
    "bulk add": (set(NAMES),
                 lambda idx: idx.add(_rows(3, 200), np.arange(200))),
    "reserve growth": ({"upper", "nbr"}, lambda idx: idx.reserve(4096)),
    "remove": (set(), lambda idx: idx.remove(np.arange(0, 300, 7))),
    "isolate": ({"nbr"}, lambda idx: (idx.remove(np.arange(0, 300, 7)),
                                      build_all(idx), idx.isolate())),
    "compact": (set(NAMES), lambda idx: (idx.remove(np.arange(0, 300, 7)),
                                         build_all(idx), idx.compact())),
}


@pytest.mark.parametrize("mutation", list(SINGLE_DROPS))
def test_single_index_drops(mutation):
    """Each mutation of HNSWIndex drops its own set of tables and keeps
    the others, the very objects."""
    drops, mutate = SINGLE_DROPS[mutation]
    idx = single(n=0 if mutation == "bulk add" else 600)
    build_all(idx)
    before = built(idx)
    assert all(t is not None for t in before.values()), before
    mutate(idx)
    after = built(idx)
    for name in NAMES:
        if name in drops:
            assert after[name] is None, name
        else:
            assert after[name] is before[name], name


def test_single_index_tables_follow_the_settings():
    """The traversal copy is the store itself for a bf16 store and none
    for traversal_dtype="f32"; the augmented table is built only with
    use_aug and a bf16 traversal."""
    idx = single(scalar_kind="bf16")
    assert traversal(idx) is idx.store._vectors
    f32 = single(traversal_dtype="f32")
    assert traversal(f32) is None
    f32.search(_rows(4, 4), 5)
    assert built(f32)["aug"] is None and built(f32)["trav"] is None
    flat = single(layout="flat")
    flat.search(_rows(4, 4), 5)
    assert built(flat)["aug"] is not None and built(flat)["nbr"] is None


@pytest.mark.parametrize("layout,delta,on", [
    ("auto", 0, True), ("auto", -1, False), ("neighborhood", -1, True),
    ("flat", 0, False)])
def test_single_layout_gate(layout, delta, on):
    """capacity x m0 x d_pad bytes against nbr_budget_bytes, on the CPU
    as on a card; "neighborhood" forces the layout, "flat" refuses it."""
    idx = single(layout=layout, n=100)
    idx.nbr_budget_bytes = idx.store.capacity * CFG["m0"] * idx.store.d_pad \
        + delta
    assert layout_on(idx) is on
    idx.search(_rows(4, 4), 5)
    assert (built(idx)["nbr"] is not None) is on


@pytest.mark.parametrize("descent", ["mxu", "beam"])
@pytest.mark.parametrize("ef", [64, 160])
@pytest.mark.parametrize("layout", ["neighborhood", "flat"])
def test_single_search_path(layout, ef, descent, monkeypatch):
    """The index's descent setting picks the descent; K1 runs the base
    beam while the layout is on and ef <= 128, the step-by-step beam
    otherwise."""
    idx = single(layout=layout, descent=descent)
    seen = []
    for name in ("mxu_descent", "beam_descent"):
        real = getattr(tgraph, name)
        monkeypatch.setattr(tgraph, name, lambda *a, _r=real, _n=name, **k: (
            seen.append(_n), _r(*a, **k))[1])
    calls, steps = fb.beam_search_plain.calls, tgraph.beam_search.steps
    idx.search(_rows(4, 8), 5, ef=ef)
    assert seen == [f"{descent}_descent"]
    k1 = layout == "neighborhood" and ef <= tgraph.FUSED_MAX_EF
    assert fb.beam_search_plain.calls - calls == int(k1)
    # the beam descent's level-1 beam steps too; the base beam only
    # when K1 does not run
    if descent == "mxu":
        assert (tgraph.beam_search.steps > steps) is not k1


def test_single_k1_switch_off(monkeypatch):
    """use_pallas_beam=False: the step-by-step beam over the int8 tiles,
    whatever ef."""
    idx = single(use_pallas_beam=False)
    calls, steps = fb.beam_search_plain.calls, tgraph.beam_search.steps
    idx.search(_rows(4, 8), 5, ef=64)
    assert fb.beam_search_plain.calls == calls
    assert tgraph.beam_search.steps > steps


# -- the sharded index -------------------------------------------------------

def sharded(layout="neighborhood", n=600, devices=("cpu", "cpu"), n_q=1):
    mesh = tsh.make_mesh(len(devices) // n_q, n_q, devices=list(devices))
    sh = tsh.ShardedHNSWIndex(D, HNSWConfig(**CFG), mesh,
                              capacity_per_shard=1024, build_batch=64,
                              layout=layout)
    if n:
        sh.add(_rows(1, n), np.arange(n))
    return sh


SHARDED_MUTATIONS = {
    "add": lambda sh: sh.add(_rows(2, 40), np.arange(10_000, 10_040)),
    "bulk add": lambda sh: sh.add(_rows(3, 200), np.arange(200)),
    "reserve growth": lambda sh: sh.reserve(4096),
    "remove": lambda sh: sh.remove(np.arange(0, 300, 7)),
    "isolate": lambda sh: (sh.remove(np.arange(0, 300, 7)),
                           build_shards(sh), sh.isolate()),
    "compact": lambda sh: (sh.remove(np.arange(0, 300, 7)),
                           build_shards(sh), sh.compact()),
}


@pytest.mark.parametrize("mutation", list(SHARDED_MUTATIONS))
def test_sharded_index_drops(mutation, monkeypatch):
    """Every mutation of ShardedHNSWIndex drops every table of every
    replica row, but remove, which writes tombstones only and keeps
    them all."""
    monkeypatch.setattr(tsh, "BULK_THRESHOLD", 64)
    sh = sharded(n=0 if mutation == "bulk add" else 600, n_q=2,
                 devices=["cpu"] * 4)
    build_shards(sh)
    before = shard_built(sh)
    assert len(before) == 4
    for tabs in before.values():
        assert tabs["upper"] is not None and tabs["nbr"] is not None
        assert tabs["trav"] is None and tabs["aug"] is None
    SHARDED_MUTATIONS[mutation](sh)
    after = shard_built(sh)
    for key, tabs in after.items():
        for name in ("upper", "nbr"):
            if mutation == "remove":
                assert tabs[name] is before[key][name], (key, name)
            else:
                assert tabs[name] is None, (key, name)


def test_sharded_flat_layout_builds_the_traversal_copy():
    """Without the layout each shard searches over the bf16 traversal
    copy; a mutation drops it with the rest."""
    sh = sharded(layout="flat")
    build_shards(sh)
    tabs = shard_built(sh)
    assert all(t["trav"] is not None and t["nbr"] is None
               for t in tabs.values())
    sh.add(_rows(2, 8), np.arange(10_000, 10_008))
    assert all(t["trav"] is None for t in shard_built(sh).values())


@pytest.mark.parametrize("devices", [["cpu"] * 2, ["cpu", "cpu:0"]])
def test_sharded_budget_sums_the_shards_of_a_device(devices):
    """The budget is summed over the shards each device holds: two
    shards on one CPU need twice one shard's table, two devices one
    each."""
    sh = sharded(n=0, devices=devices)
    per_shard = sh.cap * CFG["m0"] * sh.d_pad
    share = 2 if len(set(devices)) == 1 else 1
    sh.nbr_budget_bytes = per_shard * share
    assert shard_budget_ok(sh)
    sh.nbr_budget_bytes -= 1
    assert not shard_budget_ok(sh)


@pytest.mark.parametrize("ef", [64, 160])
@pytest.mark.parametrize("layout", ["neighborhood", "auto"])
def test_sharded_search_path(layout, ef, monkeypatch):
    """Every shard descends through the mxu descent; K1 runs once per
    shard while the layout is on (forced; "auto" refuses it on the CPU)
    and the shard's ef <= 128."""
    sh = sharded(layout=layout)
    seen = []
    for name in ("mxu_descent", "beam_descent"):
        real = getattr(tgraph, name)
        monkeypatch.setattr(tgraph, name, lambda *a, _r=real, _n=name, **k: (
            seen.append(_n), _r(*a, **k))[1])
    calls = fb.beam_search_plain.calls
    sh.search(_rows(4, 8), 5, ef=ef, ef_local=ef)
    assert seen == ["mxu_descent"] * 2
    k1 = layout == "neighborhood" and ef <= tgraph.FUSED_MAX_EF
    assert fb.beam_search_plain.calls - calls == 2 * int(k1)


# -- compaction ---------------------------------------------------------------

def reference_compact(valid, levels, upper_slot, nb0, un):
    """The compaction plan written out plainly: the new graph arrays
    and the old slot of each new one."""
    cap, cap_u = len(valid), un.shape[0]
    live = [s for s in range(cap) if valid[s]]
    order = sorted(live, key=lambda s: (-levels[s], s))
    new_of = {o: i for i, o in enumerate(order)}

    def remap(row):
        return [new_of.get(int(x), -1) if x >= 0 else -1 for x in row]

    out = {"neighbors0": np.full_like(nb0, -1),
           "upper_neighbors": np.full_like(un, -1),
           "upper_slot": np.full((cap,), -1, np.int32),
           "upper_node": np.full((cap_u,), -1, np.int32),
           "levels": np.full((cap,), -1, np.int32)}
    n_up = 0
    for i, o in enumerate(order):
        out["neighbors0"][i] = remap(nb0[o])
        out["levels"][i] = levels[o]
        if levels[o] >= 1:
            out["upper_neighbors"][n_up] = remap(un[upper_slot[o]])
            out["upper_slot"][i] = n_up
            out["upper_node"][n_up] = i
            n_up += 1
    out["entry_node"] = 0 if order else -1
    out["max_level"] = int(levels[order[0]]) if order else -1
    out["upper_count"] = n_up
    return out, np.asarray(order, np.int64)


def _check_graph(got, want):
    for f, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[f]), w, err_msg=f)


def test_single_compact_follows_the_plan():
    idx = single(n=600)
    idx.remove(np.arange(0, 600, 5))
    st, g = idx.store, idx.graph
    vecs = st._vectors.numpy().copy()
    keys = st._keys.copy()
    want, order = reference_compact(
        st._valid.numpy(), g.levels.numpy(), g.upper_slot.numpy(),
        g.neighbors0.numpy(), g.upper_neighbors.numpy())
    idx.compact()
    _check_graph({f: getattr(idx.graph, f).numpy()
                  for f in tgraph.GraphState._fields}, want)
    n = len(order)
    np.testing.assert_array_equal(idx.store._vectors.numpy()[:n],
                                  vecs[order])
    # dead rows are written as +0.0
    assert not idx.store._vectors.numpy()[n:].view(np.uint32).any()
    np.testing.assert_array_equal(idx.store._keys[:n], keys[order])
    assert (idx.store._keys[n:] == -1).all()
    assert idx.store._valid.numpy().sum() == n == len(idx)


def test_sharded_compact_follows_the_plan():
    sh = sharded(n=600, layout="flat")
    sh.remove(np.arange(0, 600, 5))
    # a negative first row shows the dead rows' signed zeros
    for j in range(2):
        sh._view("vectors", j)[0, :D] = -1.0
    pre = {f: sh._gather(f).numpy().copy()
           for f in tsh.STORE_FIELDS + tsh.GRAPH_FIELDS}
    keys = sh._keys.copy()
    sh.compact()
    post = {f: sh._gather(f).numpy() for f in pre}
    for i in range(2):
        want, order = reference_compact(
            pre["valid"][i], pre["levels"][i], pre["upper_slot"][i],
            pre["neighbors0"][i], pre["upper_neighbors"][i])
        _check_graph({f: post[f][i] for f in tsh.GRAPH_FIELDS}, want)
        n = len(order)
        vecs = post["vectors"][i]
        np.testing.assert_array_equal(vecs[:n], pre["vectors"][i][order])
        # dead rows: shard row 0 multiplied by zero, -0.0 where it was
        # negative
        np.testing.assert_array_equal(
            vecs[n:].view(np.uint32),
            np.broadcast_to((pre["vectors"][i][0] * np.float32(0)).view(
                np.uint32), vecs[n:].shape))
        assert np.signbit(vecs[n:, :D]).all()
        np.testing.assert_array_equal(sh._keys[i, :n], keys[i][order])
        assert post["valid"][i].sum() == n
