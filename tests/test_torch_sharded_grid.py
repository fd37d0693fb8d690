"""The port's sharded index over a grid of device slots in one process
(make_mesh(..., devices=[...])), on the CPU at small sizes.

- A q = 1 grid of CPU slots answers as the one-device mesh, bit for
  bit: keys, scores, counts, stats, every array and the saved file,
  through add (bulk build and insert), remove, isolate, compact,
  reserve, a second add and search, for ShardedFlatIndex and
  ShardedHNSWIndex. ``["cpu", "cpu:0", ...]`` names the CPU twice, so
  the grid keeps two groups of shards, interleaved: it stands in for
  two cards in one replica row.
- A (q 2, shard 4) grid of 8 CPU slots against the JAX package's
  make_mesh(4, 2) over conftest's 8 virtual CPU devices, one graph
  carried across (convert.sharded_from_arrays): keys equal within ties
  and scores within the f32 bound of tests/test_torch_topk.py (two
  libraries' sums), every shard of both replica rows searched, and the
  replicas equal bit for bit after every mutation.
- A file saved from a grid loads into the JAX package and into a
  one-device port mesh, and both answer as the grid did.
- The entry's dry run on grids of 1, 2, 4 and 8 CPU slots; a grid that
  names a card this host lacks raises.
"""

import numpy as np
import pytest
import torch

from duckdb_vss_tpu.parallel import sharded as jsh
from duckdb_vss_tpu.utils.config import HNSWConfig as JConfig
from duckdb_vss_tpu_torch import entry as port_entry
from duckdb_vss_tpu_torch.ops import fused_beam as fb
from duckdb_vss_tpu_torch.parallel import sharded as tsh
from duckdb_vss_tpu_torch.utils.config import HNSWConfig, MetricKind
from duckdb_vss_tpu_torch.utils.convert import sharded_to_arrays
from test_torch_sharded import (SMALL, _bits, assert_same_state, carried,
                                clustered)
from test_torch_topk import (assert_same_ids_within_ties,
                             assert_scores_within, score_bound)

torch.set_num_threads(2)

FIELDS = tsh.STORE_FIELDS + tsh.GRAPH_FIELDS
GRIDS = {"2 slots": ["cpu"] * 2, "4 slots": ["cpu"] * 4,
         "2 groups": ["cpu", "cpu:0", "cpu", "cpu:0"]}


def assert_same_arrays(a, b):
    """Every array of two sharded HNSW indexes equal, bit for bit."""
    x, y = sharded_to_arrays(a), sharded_to_arrays(b)
    assert x.keys() == y.keys()
    for name in x:
        if name == "_free_slots":
            assert [list(f) for f in x[name]] == [list(f) for f in y[name]]
        else:
            np.testing.assert_array_equal(_bits(x[name]), _bits(y[name]),
                                          err_msg=name)


def assert_replicas_equal(idx):
    """Every field of every shard equal in every replica row, bit for
    bit, and each on the device its slot names."""
    for j in range(len(idx.mesh.shards)):
        for r, row in enumerate(idx.mesh.grid):
            g, _ = idx._where[(r, j)]
            assert g.device == row[j].device
            for f in (FIELDS if hasattr(idx, "config")
                      else tsh.STORE_FIELDS):
                np.testing.assert_array_equal(
                    _bits(idx._view(f, j, r).numpy()),
                    _bits(idx._view(f, j, 0).numpy()), err_msg=f"{f} {r}")


def test_grid_places_shards_and_replicas():
    """Slot (r, j) is devices[r * S + j]; a group is one row's shards on
    one device; without ``devices`` the grid is one slot."""
    names = ["cpu", "cpu:0", "cpu:0", "cpu"]
    mesh = tsh.make_mesh(2, 2, devices=names)
    assert mesh.shape == {"q": 2, "shard": 2}
    assert [[(str(s.device), s.shards) for s in row] for row in mesh.grid] \
        == [[("cpu", (0,)), ("cpu:0", (1,))], [("cpu:0", (0,)), ("cpu", (1,))]]
    idx = tsh.ShardedHNSWIndex(8, HNSWConfig(**SMALL), mesh)
    assert sorted((g.row, str(g.device), g.shards) for g in idx.groups) == [
        (0, "cpu", (0,)), (0, "cpu:0", (1,)), (1, "cpu", (1,)),
        (1, "cpu:0", (0,))]
    one = tsh.make_mesh(4, 2, device="cpu")
    assert one.grid == ((tsh.Slot(torch.device("cpu"), (0, 1, 2, 3)),),)
    assert [len(row) for row in tsh.make_mesh(4, 2,
                                              devices=["cpu"] * 8).grid] \
        == [4, 4]


@pytest.mark.parametrize("grid", GRIDS)
def test_grid_flat_equals_one_device(grid):
    devices = GRIDS[grid]
    s = len(devices)
    rng = np.random.default_rng(5)
    d, k = 24, 10
    v = rng.normal(size=(2500, d)).astype(np.float32)
    q = rng.normal(size=(40, d)).astype(np.float32)
    one = tsh.ShardedFlatIndex(d, MetricKind.L2SQ,
                               tsh.make_mesh(s, device="cpu"))
    on_grid = tsh.ShardedFlatIndex(d, MetricKind.L2SQ,
                                   tsh.make_mesh(s, devices=devices))
    for idx in (one, on_grid):
        idx.add(v[:2000], np.arange(2000))
    outs = [idx.search(q, k) for idx in (one, on_grid)]
    for idx in (one, on_grid):
        idx.reserve(4096)
        idx.add(v[2000:], np.arange(2000, 2500))
    outs += [idx.search(q, k) for idx in (one, on_grid)]
    for a, b in (outs[:2], outs[2:]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(one._vectors.numpy(),
                                  on_grid._vectors.numpy())
    assert on_grid.cap == one.cap == 4096


@pytest.mark.parametrize("grid,n_first", [("2 slots", 512), ("4 slots", 512),
                                          ("2 groups", 4096)])
def test_grid_hnsw_equals_one_device(grid, n_first, tmp_path):
    """Every step on the grid and on the one-device mesh: the same keys,
    scores, counts, stats, arrays and file bytes. The first add of
    4096 rows bulk-builds, of 512 inserts."""
    devices = GRIDS[grid]
    s = len(devices)
    v, q = clustered(11, n_first + 256, 24, 16)
    keys = np.arange(len(v), dtype=np.int64) * 3
    pair = [tsh.ShardedHNSWIndex(16, HNSWConfig(**SMALL), mesh,
                                 capacity_per_shard=n_first // s,
                                 build_batch=64)
            for mesh in (tsh.make_mesh(s, device="cpu"),
                         tsh.make_mesh(s, devices=devices))]

    def same(what):
        a, b = (idx.search(q, 5, ef=32) for idx in pair)
        np.testing.assert_array_equal(a[1], b[1], err_msg=what)
        np.testing.assert_array_equal(a[0], b[0], err_msg=what)
        np.testing.assert_array_equal(pair[0].counts, pair[1].counts)
        assert pair[0].stats() == pair[1].stats(), what
        assert_same_arrays(*pair)

    for idx in pair:
        idx.add(v[:n_first], keys[:n_first])
    assert len(pair[1].build_stats) == (s if n_first >= 4096 else 0)
    same("first add")
    for idx in pair:
        assert idx.remove(keys[100:300]) == 200
    same("remove")
    for idx in pair:
        idx.isolate()
    same("isolate")
    for idx in pair:
        idx.compact()
    same("compact")
    for idx in pair:
        idx.reserve(2 * idx.cap)
        idx.add(v[n_first:], keys[n_first:])  # the insert path
    same("reserve and insert")
    paths = [str(tmp_path / f"{i}.vss") for i in range(2)]
    for idx, path in zip(pair, paths):
        idx.save(path)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    back = tsh.ShardedHNSWIndex.load(paths[0], pair[1].mesh)
    np.testing.assert_array_equal(back.search(q, 5, ef=32)[0],
                                  pair[1].search(q, 5, ef=32)[0])


def test_replica_rows_equal_one_row(tmp_path):
    """(q 2, shard 2) on four CPU slots against the one-row mesh of two
    shards, bit for bit: after the bulk build and an insert, after
    remove, isolate and compact, and after save and load onto the grid.
    Each replica row, given the same queries (one chunk of two copies:
    row 0 answers the first, row 1 the second), returns the one-row
    mesh's keys and scores; every field is equal in both rows; the two
    files are byte-equal."""
    v, q = clustered(19, 4096 + 256, 24, 16)
    keys = np.arange(len(v), dtype=np.int64) * 5
    one, grid = (tsh.ShardedHNSWIndex(16, HNSWConfig(**SMALL), mesh,
                                      capacity_per_shard=4096,
                                      build_batch=64)
                 for mesh in (tsh.make_mesh(2, device="cpu"),
                              tsh.make_mesh(2, 2, devices=["cpu"] * 4)))

    def same(what, index=grid):
        for ef_local in (16, 32):
            want = one.search(q, 5, ef_local=ef_local)
            got = index.search(np.concatenate([q, q]), 5, ef_local=ef_local)
            for rows, name in ((slice(None, len(q)), "row 0"),
                               (slice(len(q), None), "row 1")):
                np.testing.assert_array_equal(got[1][rows], want[1],
                                              err_msg=f"{what}, {name}")
                np.testing.assert_array_equal(got[0][rows], want[0],
                                              err_msg=f"{what}, {name}")
        assert_same_arrays(one, index)
        assert_replicas_equal(index)

    for idx in (one, grid):
        idx.add(v[:4096], keys[:4096])  # the bulk build
        idx.add(v[4096:], keys[4096:])  # the insert path
    same("add")
    for idx in (one, grid):
        assert idx.remove(keys[::7]) == len(keys[::7])
        idx.isolate()
        idx.compact()
    same("remove, isolate and compact")
    paths = [str(tmp_path / f"{name}.vss") for name in ("one", "grid")]
    for idx, path in zip((one, grid), paths):
        idx.save(path)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    same("load", tsh.ShardedHNSWIndex.load(paths[1], grid.mesh))


@pytest.fixture(scope="module")
def jax_q2():
    """A JAX index on make_mesh(4, 2) (8 virtual CPU devices) and its
    data."""
    v, q = clustered(17, 768, 32, 16)
    keys = np.arange(len(v), dtype=np.int64)
    j = jsh.ShardedHNSWIndex(16, JConfig(**SMALL), jsh.make_mesh(4, 2),
                             capacity_per_shard=1024, build_batch=64)
    j.add(v, keys)
    return j, v, q, keys


def assert_answers_match(got, want, v, q):
    bound = score_bound(q, v, "l2sq")
    assert_scores_within(got[0], want[0], bound, "l2sq")
    assert_same_ids_within_ties(got[1], want[1], want[0], 2 * bound, "l2sq")


def test_grid_q2_matches_jax(jax_q2):
    """(q 2, shard 4) on 8 CPU slots against the JAX package's (q 2,
    shard 4) mesh on one carried graph: answers within ties and the
    bound before and after remove and compact, both rows' shards
    searched, replicas equal."""
    j, v, q, keys = jax_q2
    mesh = tsh.make_mesh(4, 2, devices=["cpu"] * 8)
    t = carried(j, mesh, layout="neighborhood")
    assert_replicas_equal(t)
    calls = fb.beam_search_plain.calls
    assert_answers_match(t.search(q, 5, ef=32), j.search(q, 5, ef=32), v, q)
    # K1's plain version once per shard of each replica row
    assert fb.beam_search_plain.calls - calls == 8
    for (_, shard), tabs in t.tables.items():
        for x, y in zip(tabs.built["nbr"], t.tables[(0, shard)].built["nbr"]):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
    tables = {key: tabs.built["nbr"] for key, tabs in t.tables.items()}
    for idx in (j, t):
        idx.remove(keys[200:260])
    # tombstones reach every replica row, and every row keeps its tables
    assert_replicas_equal(t)
    assert all(t.tables[key].built["nbr"] is n for key, n in tables.items())
    assert_answers_match(t.search(q, 5, ef=32), j.search(q, 5, ef=32), v, q)
    for idx in (j, t):
        idx.compact()
    assert_same_state(t, j, skip=("_vec_sq",))
    assert_replicas_equal(t)
    assert_answers_match(t.search(q, 5, ef=32), j.search(q, 5, ef=32), v, q)


def test_grid_file_opens_in_jax_and_one_device(tmp_path):
    """A file saved from a (q 2, shard 4) grid holds the same arrays in a
    one-device port mesh and answers there, and in the JAX package, as
    the grid does."""
    v, q = clustered(23, 768, 32, 16)
    keys = np.arange(len(v), dtype=np.int64) * 5
    g = tsh.ShardedHNSWIndex(16, HNSWConfig(**SMALL),
                             tsh.make_mesh(4, 2, devices=["cpu"] * 8),
                             capacity_per_shard=1024, build_batch=64)
    g.add(v, keys)
    g.remove(keys[:30])
    assert_replicas_equal(g)
    path = str(tmp_path / "grid.vss")
    g.save(path)
    one = tsh.ShardedHNSWIndex.load(path, tsh.make_mesh(4, 2, device="cpu"))
    jl = jsh.ShardedHNSWIndex.load(path, jsh.make_mesh(4, 2))
    assert_same_arrays(one, g)
    want = g.search(q, 5, ef=32)
    assert_answers_match(one.search(q, 5, ef=32), want, v, q)
    assert_answers_match(jl.search(q, 5, ef=32), want, v, q)


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_dryrun_multichip_on_a_grid(n_devices, capsys):
    port_entry.dryrun_multichip(n_devices, device="cpu",
                                devices=["cpu"] * n_devices)
    n_q = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    assert (f"mesh={{'q': {n_q}, 'shard': {n_devices // n_q}}}"
            in capsys.readouterr().out)


@pytest.mark.parametrize("devices,n_cards,error", [
    (["cuda:0"], 0, RuntimeError),  # no card at all
    (["cuda:0", "cuda:1"], 1, ValueError),  # a card past the last
    (["cpu"] * 3, 0, ValueError),  # not a grid of 1 x 2 slots
])
def test_make_mesh_grid_raises(devices, n_cards, error, monkeypatch):
    """A slot never turns into another device: a missing card raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n_cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    with pytest.raises(error):
        tsh.make_mesh(2 if len(devices) == 3 else None, devices=devices)
