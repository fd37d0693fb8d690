"""Port parity: index persistence (duckdb_vss_tpu_torch.utils.persist)
against the JAX package's files, both ways.

- A JAX-saved file loads into the port and a port-saved file loads into
  the JAX package, for f32 and bf16 stores, on the native container and
  on the .npz fallback: every array arrives bit for bit (vectors, keys,
  validity, graph, free-list, next slot), and the loaded indexes search
  alike (95% of keys equal, as tests/test_torch_hnsw.py holds the
  bf16 step beam; their distances within the f32 bound of
  tests/test_torch_topk.py).
- The same state saved by both packages gives byte-identical native
  files (the .npz fallback is a zip whose entries carry the time of
  writing, so there the loaded arrays are compared instead).
- A lazy load reads no device section until the first search or
  mutation; the store's squared norms come back bit for bit.
- Corruption, a truncated file and a missing file raise PersistError.
- Where the committed library does not load, the source is compiled
  into build/native/ and used.
"""

import os

import numpy as np
import pytest
import torch

from duckdb_vss_tpu.models.hnsw import HNSWIndex as JHNSW
from duckdb_vss_tpu.utils import persist as jpersist
from duckdb_vss_tpu.utils.config import HNSWConfig as JConfig
from duckdb_vss_tpu.utils.config import MetricKind as JMetric
from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex
from duckdb_vss_tpu_torch.utils import persist as tpersist
from duckdb_vss_tpu_torch.utils.config import HNSWConfig
from duckdb_vss_tpu_torch.utils.convert import (GRAPH_FIELDS,
                                                index_from_arrays,
                                                index_to_arrays)
from test_torch_beam import _clustered
from test_torch_hnsw_api import jax_arrays
from test_torch_topk import assert_scores_within, score_bound

torch.set_num_threads(2)

N, D, NQ = 4500, 16, 24
CONFIG = dict(metric="cosine", m=8, m0=16)
COMPARED = ("_vectors", "_valid", "_keys", "_next_slot",
            "_free_slots") + GRAPH_FIELDS


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.fixture(scope="module", params=["f32", "bf16"])
def jax_saved(request, tmp_path_factory):
    """A JAX bulk-built cosine index with removals (tombstones and a
    free-list), its data, and its state as numpy."""
    v, q = _clustered(61, N, NQ, d=D)
    jidx = JHNSW(D, JConfig(metric=JMetric.COSINE, m=8, m0=16), capacity=N,
                 scalar_kind=request.param)
    jidx.add(v, np.arange(N, dtype=np.int64) + 5)
    jidx.remove(np.arange(5, N + 5, 9))
    return jidx, v, q, tmp_path_factory.mktemp(request.param)


def assert_same_arrays(got, want):
    for f in COMPARED:
        np.testing.assert_array_equal(_bits(got[f]), _bits(want[f]),
                                      err_msg=f)


def assert_close_search(a, b, q, v):
    sa, ka = a.search(q, 8, ef=32)
    sb, kb = b.search(q, 8, ef=32)
    same = ka == kb
    assert same.mean() >= 0.95, same.mean()
    bound = np.broadcast_to(score_bound(q, v, "cosine")[:, None], sa.shape)
    assert_scores_within(sa[same][:, None], sb[same][:, None],
                         bound[same], "cosine")


@pytest.mark.parametrize("container", ["native", "npz"])
def test_cross_load_both_ways(jax_saved, container, monkeypatch):
    jidx, v, q, tmp = jax_saved
    if container == "npz":
        monkeypatch.setattr(jpersist, "get_lib", lambda: None)
        monkeypatch.setattr(tpersist, "get_lib", lambda: None)
    want = jax_arrays(jidx)
    # JAX -> port
    path = str(tmp / f"jax-{container}.vss")
    jpersist.save_index(jidx, path)
    tidx = tpersist.load_index(path, lazy=False, device="cpu")
    assert tidx.store.scalar_kind == jidx.store.scalar_kind
    assert tidx.config == HNSWConfig.from_options(CONFIG)
    assert len(tidx) == len(jidx)
    assert_same_arrays(index_to_arrays(tidx), want)
    assert tidx.store._key_to_slot == jidx.store._key_to_slot
    assert not tidx.is_dirty
    # port -> JAX
    path2 = str(tmp / f"port-{container}.vss")
    tpersist.save_index(tidx, path2)
    back = jpersist.load_index(path2, lazy=False)
    assert_same_arrays(jax_arrays(back), want)
    assert back.store.scalar_kind == jidx.store.scalar_kind
    # the store holds the same rows, the indexes search alike
    tidx.layout = "flat"
    jidx.layout = "flat"
    assert_close_search(tidx, jidx, q, v)


def test_native_files_byte_identical(jax_saved):
    """One state, saved by each package on the native container."""
    jidx, _v, _q, tmp = jax_saved
    assert tpersist.get_lib() is not None
    tidx = index_from_arrays(jax_arrays(jidx), HNSWConfig.from_options(
        CONFIG), device="cpu")
    paths = [str(tmp / "same-jax.vss"), str(tmp / "same-port.vss")]
    jpersist.save_index(jidx, paths[0])
    tpersist.save_index(tidx, paths[1])
    a, b = (open(p, "rb").read() for p in paths)
    assert len(a) == len(b) and a == b
    assert a[:8] == (0x3031555054535356).to_bytes(8, "little")  # VSSTPU01


def test_lazy_load_materializes_and_keeps_norms(tmp_path):
    """A port-built index with scatter-inserted rows: a lazy load touches
    nothing until the first search (or add), then equals the eager one;
    the norms, summed again on load, equal the saved store's."""
    v, q = _clustered(62, N, NQ, d=D)
    idx = HNSWIndex(D, HNSWConfig.from_options(CONFIG), capacity=N,
                             device="cpu")
    idx.add(v[:4200], np.arange(4200))
    idx.remove(np.arange(0, 4200, 5))
    idx.add(v[4200:], np.arange(4200, N))  # reuses slots (scatter)
    assert idx.is_dirty
    path = str(tmp_path / "idx.vss")
    tpersist.save_index(idx, path)
    assert not idx.is_dirty
    want_s, want_k = idx.search(q, 5, ef=32)

    eager = tpersist.load_index(path, lazy=False, device="cpu")
    np.testing.assert_array_equal(eager.store._vec_sq.numpy(),
                                  idx.store._vec_sq.numpy())
    lz = tpersist.load_index(path, device="cpu")  # lazy by default
    assert lz._pending_load is not None
    assert lz.store._vectors is None and lz.graph is None
    assert len(lz) == len(idx) and lz.contains(1) and not lz.contains(5)
    assert lz._pending_load is not None
    got_s, got_k = lz.search(q, 5, ef=32)
    assert lz._pending_load is None and lz.store._vectors is not None
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_s, want_s)
    lz2 = tpersist.load_index(path, device="cpu")
    lz2.add(v[:2] + 0.5, [10**6, 10**6 + 1])  # a mutation materializes
    assert lz2._pending_load is None and len(lz2) == len(idx) + 2
    assert lz2.search(v[:2] + 0.5, 1)[1][:, 0].tolist() == [10**6, 10**6 + 1]

    img = open(path, "rb").read()
    calls = []

    def factory():
        calls.append(1)
        return img

    buf = tpersist.load_index_from_buffer(factory, device="cpu")
    assert len(calls) == 1  # header and host sections
    np.testing.assert_array_equal(buf.search(q, 5, ef=32)[1], want_k)
    assert len(calls) == 2  # read again at materialize time


def test_corruption_and_missing_file(tmp_path):
    v, _q = _clustered(63, 4096, 4, d=D)
    idx = HNSWIndex(D, device="cpu")
    idx.add(v, np.arange(4096))
    path = str(tmp_path / "idx.vss")
    tpersist.save_index(idx, path)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        f.write(b"\xde\xad\xbe\xef" * 4)
    with pytest.raises(tpersist.PersistError):
        tpersist.load_index(path, lazy=False, device="cpu")
    lz = tpersist.load_index(path, lazy=True, device="cpu")
    with pytest.raises(tpersist.PersistError):
        lz.search(v[:2], 3, ef=16)
    with open(path, "r+b") as f:
        f.truncate(40)  # shorter than the header
    with pytest.raises(tpersist.PersistError):
        tpersist.load_index(path, device="cpu")
    with pytest.raises(tpersist.PersistError):
        tpersist.load_index(str(tmp_path / "nope.vss"), device="cpu")
    with pytest.raises(tpersist.PersistError):
        tpersist.load_index_from_buffer(b"\x00" * 16, device="cpu")


def test_library_built_from_source_when_the_committed_one_fails(
        tmp_path, monkeypatch):
    """A committed library that does not load (here: one that is not
    there) is replaced by one compiled from native/vss_store.cpp; files
    it writes are the committed library's, byte for byte."""
    monkeypatch.setattr(tpersist, "LIB_COMMITTED", tmp_path / "absent.so")
    monkeypatch.setattr(tpersist, "LIB_BUILT",
                        tmp_path / "build" / "libvss_store.so")
    monkeypatch.setattr(tpersist, "_LIB", [])
    v, _q = _clustered(64, 4096, 4, d=D)
    idx = HNSWIndex(D, device="cpu")
    idx.add(v, np.arange(4096))
    tpersist.save_index(idx, str(tmp_path / "built.vss"))
    assert tpersist.LIB_BUILT.exists()
    monkeypatch.setattr(tpersist, "_LIB", [])
    monkeypatch.undo()
    tpersist.save_index(idx, str(tmp_path / "committed.vss"))
    a, b = (open(tmp_path / f, "rb").read()
            for f in ("built.vss", "committed.vss"))
    assert a == b
