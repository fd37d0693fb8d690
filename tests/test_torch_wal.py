"""Port parity: the WAL (utils/wal.py), the block store
(utils/blockstore.py), checkpoint and reopen (sql/engine.py) against the
JAX package's, both ways.

- The same record gives the same WAL frame, byte for byte, in both
  packages, and the same DML/DDL through both engines gives the same
  log file; either package replays the other's log. A torn tail or a
  corrupt CRC ends the replay at the last whole record.
- The block store reuses freed blocks before it grows the file, on the
  native library and on the pure-Python file (forced by patching
  ``blockstore._get_lib``); each backend reads the other's blocks, and
  the JAX package's block manager reads the port's.
- A database checkpointed and reopened answers as before; WAL records
  after the checkpoint replay on top of it; a directory written by
  either package opens in the other (cross-open) and answers the same
  queries.

Tolerances: distances emitted by the two engines are f32 sums of d
squares in two libraries, held within 2 d 2^-24 of each other
(relative); neighbour ids must be equal wherever the reference's gap to
the next distance exceeds twice that (``assert_same_ids_within_ties``
of tests/test_torch_topk.py). Where a database is reopened in the
package that wrote it, its answers must be equal exactly.
"""

import struct

import numpy as np
import pytest
import torch

from duckdb_vss_tpu.sql import engine as jengine
from duckdb_vss_tpu.utils import blockstore as jblockstore
from duckdb_vss_tpu.utils import wal as jwal
from duckdb_vss_tpu_torch.sql import engine as tengine
from duckdb_vss_tpu_torch.utils import blockstore as tblockstore
from duckdb_vss_tpu_torch.utils import wal as twal
from test_torch_topk import assert_same_ids_within_ties

torch.set_num_threads(2)

N, D, K = 300, 8, 5
REL = 2 * D * 2.0 ** -24  # two f32 sums of D squares, relative

RECORDS = {
    "insert": {"op": "insert", "table": "t", "rows": [
        {"id": 3, "vec": np.arange(4, dtype=np.float32) - 1.5,
         "name": "a'b"},
        {"id": 4, "vec": None, "name": None}]},
    "delete": {"op": "delete", "table": "t",
               "rowids": np.array([5, 1, 9], np.int64)},
    "create_table": {"op": "create_table", "name": "t",
                     "columns": {"id": "BIGINT", "vec": ["FLOAT", 4]}},
    "create_index": {"op": "create_index", "name": "i", "table": "t",
                     "column": "vec", "options": {"metric": "cosine",
                                                  "m": 8}},
    "set": {"op": "set", "key": "hnsw_ef_search", "value": 99.5},
    "nested": {"op": "x", "a": [np.zeros((2, 3), np.float64),
                                {"b": np.int64(7), "c": np.float32(0.5)}]},
}


def _same(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    return a == b


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_wal_frames_byte_equal_and_replay_across(name, tmp_path):
    rec = RECORDS[name]
    logs = {}
    for pkg, mod in (("jax", jwal), ("port", twal)):
        w = mod.WriteAheadLog(str(tmp_path / f"{pkg}.wal"), fsync=True)
        w.append(rec)
        w.append({"op": "tail"})
        w.close()
        logs[pkg] = (tmp_path / f"{pkg}.wal").read_bytes()
    assert logs["jax"] == logs["port"]
    assert logs["port"][:4] == struct.pack("<I", twal.MAGIC)
    # each package replays the other's file
    for mod, other in ((twal, "jax"), (jwal, "port")):
        got = list(mod.WriteAheadLog(str(tmp_path / f"{other}.wal")).replay())
        assert len(got) == 2 and got[1] == {"op": "tail"}
        assert _same(got[0], jwal._decode(jwal._encode(rec)))


@pytest.mark.parametrize("damage", ["torn", "crc"])
def test_wal_damaged_tail(damage, tmp_path):
    """Replay stops at the last whole record, in both packages."""
    p = str(tmp_path / "w.wal")
    w = twal.WriteAheadLog(p)
    for op in "abc":
        w.append({"op": op, "v": np.full(3, ord(op), np.int32)})
    w.close()
    data = bytearray(open(p, "rb").read())
    if damage == "torn":
        data += struct.pack("<III", twal.MAGIC, 1000, 0) + b"short"
        want = ["a", "b", "c"]
    else:
        data[-1] ^= 0xFF
        want = ["a", "b"]
    open(p, "wb").write(bytes(data))
    for mod in (twal, jwal):
        assert [r["op"] for r in mod.WriteAheadLog(p).replay()] == want


def _ops(db, E, vecs):
    """The same DML/DDL through either engine (E: its expr module)."""
    db.set("hnsw_enable_experimental_persistence", True)
    t = db.create_table("items", {"id": "BIGINT", "name": "VARCHAR",
                                  "vec": ("FLOAT", D)})
    t.insert({"id": np.arange(N), "name": [f"n{i}" for i in range(N)],
              "vec": list(vecs)})
    t.insert([{"id": 999, "name": "nullvec", "vec": None}])
    db.create_hnsw_index("idx", "items", "vec")
    t.delete(rowids=[5, 6])
    t.delete(predicate=E.col("id") > N - 3)
    db.create_table("extra", {"x": "BIGINT"})
    db.drop_table("extra")
    db.set("hnsw_ef_search", 40)
    db.pragma_hnsw_compact_index("idx")
    return t


def test_engine_logs_byte_equal(tmp_path):
    from duckdb_vss_tpu.sql import expr as jE
    from duckdb_vss_tpu_torch.sql import expr as tE

    vecs = np.random.default_rng(1).normal(size=(N, D)).astype(np.float32)
    jdb = jengine.Database(path=str(tmp_path / "jax"))
    _ops(jdb, jE, vecs)
    jdb.wal.close()
    tdb = tengine.Database(path=str(tmp_path / "port"), device="cpu",
                           wal_fsync=False)
    assert not tdb.wal.fsync
    _ops(tdb, tE, vecs)
    tdb.wal.close()
    a = (tmp_path / "jax" / "vss.wal").read_bytes()
    b = (tmp_path / "port" / "vss.wal").read_bytes()
    assert a == b and len(a) > N * D * 4


@pytest.mark.parametrize("backend", ["native", "python"])
def test_block_store_reuse_and_both_backends(backend, tmp_path,
                                              monkeypatch):
    rng = np.random.default_rng(2)
    blobs = [rng.bytes(n) for n in (10, tblockstore._USABLE,
                                    tblockstore._USABLE + 1, 3 * 2**18)]
    if backend == "python":
        monkeypatch.setattr(tblockstore, "_get_lib", lambda: None)
    path = str(tmp_path / "data.vssblk")
    mgr = tblockstore.BlockManager(path)
    assert isinstance(mgr._file, tblockstore._NativeFile
                      if backend == "native" else tblockstore._PyFile)
    ids = [mgr.write_blob(b) for b in blobs]
    assert [len(i) for i in ids] == [1, 1, 2, 4]
    total = mgr.total_blocks()
    assert total == 8
    mgr.free_blob(ids[3] + ids[1])
    again = mgr.write_blob(blobs[3])  # reuses freed blocks, lowest first
    assert sorted(again) == sorted(ids[3] + ids[1])[:4]
    assert mgr.total_blocks() == total and mgr.free_blocks == [
        max(ids[3] + ids[1])]
    assert mgr.read_blob(again) == blobs[3]
    mgr.close()
    # the other backend and the JAX package read the same blocks
    monkeypatch.undo()
    if backend == "native":
        monkeypatch.setattr(tblockstore, "_get_lib", lambda: None)
    other = tblockstore.BlockManager(path)
    jmgr = jblockstore.BlockManager(path)
    for m in (other, jmgr):
        assert m.read_blob(ids[0]) == blobs[0]
        assert m.read_blob(ids[2]) == blobs[2]
        assert m.read_blob(again) == blobs[3]
        m.close()


def test_block_store_detects_corruption(tmp_path, monkeypatch):
    path = str(tmp_path / "data.vssblk")
    mgr = tblockstore.BlockManager(path)
    ids = mgr.write_blob(b"x" * 1000)
    mgr.close()
    with open(path, "r+b") as f:
        f.seek(tblockstore._BF_HDR + 8 + 10)
        f.write(b"y")
    for lib in (True, False):
        if not lib:
            monkeypatch.setattr(tblockstore, "_get_lib", lambda: None)
        m = tblockstore.BlockManager(path)
        with pytest.raises(tblockstore.BlockStoreError):
            m.read_blob(ids)
        m.close()


# -- databases on disk ------------------------------------------------------


def _make(mod, path, seed=3, **kw):
    rng = np.random.default_rng(seed)
    db = mod.Database(path=str(path), **kw)
    db.set("hnsw_enable_experimental_persistence", True)
    t = db.create_table("items", {"id": "BIGINT", "name": "VARCHAR",
                                  "vec": ("FLOAT", D)})
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    t.insert({"id": np.arange(N), "name": [f"n{i}" for i in range(N)],
              "vec": list(vecs)})
    t.insert([{"id": 999, "name": "nullvec", "vec": None}])
    return db, t, vecs


def _topk_sql(db, qv):
    lit = "[" + ", ".join(repr(float(x)) for x in qv) + f"]::FLOAT[{D}]"
    return db.execute(f"SELECT id, name, array_distance(vec, {lit}) AS d "
                      f"FROM items ORDER BY array_distance(vec, {lit}) "
                      f"LIMIT {K}")


def assert_same_answers(tdb, jdb, qs):
    """Row counts, columns and index sizes equal; per query, distances
    within the f32 bound and ids equal outside ties."""
    assert tdb.table("items").row_count == jdb.table("items").row_count
    assert sorted(tdb.indexes) == sorted(jdb.indexes)
    for name in jdb.indexes:
        assert len(tdb.indexes[name].index) == len(jdb.indexes[name].index)
        tdb.indexes[name].index.layout = "flat"  # the JAX CPU search path
    for qv in qs:
        got, want = _topk_sql(tdb, qv), _topk_sql(jdb, qv)
        assert list(got) == list(want)
        bound = REL * np.asarray(want["d"], np.float64)
        assert np.all(np.abs(got["d"] - want["d"]) <= bound + 1e-7)
        tol = np.full(1, 2 * bound.max() + 1e-7)
        assert_same_ids_within_ties(got["id"][None], want["id"][None],
                                    want["d"][None], tol, "l2")
        by_id = dict(zip(want["id"].tolist(), want["name"].tolist()))
        assert all(by_id.get(i, n) == n for i, n in
                   zip(got["id"].tolist(), got["name"].tolist()))


def test_checkpoint_reopen_roundtrip(tmp_path):
    """The port's own round trip: CHECKPOINT, reopen, the same answers
    exactly; WAL records after the checkpoint replay on top."""
    db, t, vecs = _make(tengine, tmp_path / "db", device="cpu")
    db.create_hnsw_index("idx", "items", "vec")
    t.delete(rowids=[5, 6])
    qs = vecs[[10, 20, 30]] + 0.01
    before = [_topk_sql(db, qv) for qv in qs]
    db.execute("CHECKPOINT")
    assert list(db.wal.replay()) == []
    db.wal.close()
    db2 = tengine.open_database(str(tmp_path / "db"), device="cpu")
    assert db2.device == torch.device("cpu")
    assert db2.indexes["idx"].index.device == torch.device("cpu")
    assert db2.indexes["idx"].index._pending_load is not None  # lazy
    for qv, b in zip(qs, before):
        a = _topk_sql(db2, qv)
        for c in b:
            np.testing.assert_array_equal(a[c], b[c])
    assert "nullvec" in db2.table("items").scan()[0]["name"].tolist()
    nv = np.full(D, 7.0, np.float32)
    db2.table("items").insert([{"id": 900, "name": "new", "vec": nv}])
    db2.table("items").delete(rowids=[0])
    db2.wal.close()
    db3 = tengine.open_database(str(tmp_path / "db"), device="cpu")
    assert db3.table("items").row_count == N + 1 - 2 - 1 + 1
    assert len(db3.indexes["idx"].index) == N - 2 - 1 + 1
    assert _topk_sql(db3, nv)["id"][0] == 900


def test_wal_only_restore_and_ddl(tmp_path):
    db, t, _ = _make(tengine, tmp_path / "db", device="cpu")
    db.create_hnsw_index("idx", "items", "vec")
    t.delete(rowids=[1, 2])
    db.create_table("extra", {"id": "BIGINT"})
    db.drop_table("extra")
    db.drop_index("idx")
    db.wal.close()
    db2 = tengine.open_database(str(tmp_path / "db"), device="cpu")
    assert "extra" not in db2.tables and "idx" not in db2.indexes
    assert db2.table("items").row_count == N + 1 - 2


def test_persistence_gates():
    from duckdb_vss_tpu_torch.utils.config import BinderError

    db = tengine.Database(device="cpu")
    t = db.create_table("x", {"vec": ("FLOAT", 4)})
    t.insert([{"vec": np.ones(4, np.float32)}])
    with pytest.raises(BinderError):
        tengine.checkpoint_database(db)  # in memory, no directory
    db.create_hnsw_index("i", "x", "vec")
    with pytest.raises(BinderError, match="persistence"):
        tengine.checkpoint_database(db, "unused")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_open(writer, tmp_path):
    """A directory written by one package (checkpoint, then WAL records
    after it) opens in the other and answers the same queries."""
    wmod, wkw = ((jengine, {}) if writer == "jax"
                 else (tengine, {"device": "cpu"}))
    path = tmp_path / "db"
    db, t, vecs = _make(wmod, path, **wkw)
    db.create_hnsw_index("idx", "items", "vec")
    t.delete(rowids=[5, 6])
    db.execute("CHECKPOINT")
    t.insert([{"id": 900 + i, "name": f"w{i}", "vec": vecs[i] + 0.5}
              for i in range(3)])
    t.delete(rowids=[7])
    db.wal.close()
    jdb = jengine.open_database(str(path))
    tdb = tengine.open_database(str(path), device="cpu")
    assert tdb.table("items").row_count == N + 1 - 3 + 3
    qs = np.r_[vecs[[10, 20]] + 0.01, vecs[:3] + 0.5]
    assert_same_answers(tdb, jdb, qs)
    # both indexes hold the replayed rows
    for db_ in (tdb, jdb):
        assert _topk_sql(db_, vecs[1] + 0.5)["id"][0] == 901


def test_entry_points_default_to_the_card(tmp_path):
    """Database() and open_database() without device= ask for CUDA, and
    raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        tengine.Database()
    db = tengine.Database(path=str(tmp_path / "db"), device="cpu")
    db.create_table("x", {"id": "BIGINT"})
    db.wal.close()
    with pytest.raises(RuntimeError, match="cuda"):
        tengine.open_database(str(tmp_path / "db"))
