"""HNSWIndex.search's transfers: queries staged chunk by chunk (through
page-locked buffers on a card), slots mapped to keys on the device, and
every chunk's scores and keys back in one copy after one wait.

Held, bit for bit, to the search as it was: ``search_device`` a chunk,
each chunk's results copied to the host, the slots mapped to keys by
numpy over the host key table. Checked at batch sizes around the chunk,
for every query transfer type, and after every writer of the key table
(the device copy must follow each). Results are the caller's own: a
later call leaves them as they were.

The tests marked ``gpu`` run the same on the card, at the batch cell's
chunks (8,192 + 1,808) and at one query, and count the waits. This file
imports no JAX, so on a card machine without it they run with
``python -m pytest -o addopts="" -m gpu --noconftest
tests/test_torch_search_transfer.py``.
"""

import numpy as np
import pytest
import torch

from duckdb_vss_tpu_torch.models.flat import FlatIndex
from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex
from duckdb_vss_tpu_torch.utils import convert, persist, tracing

D, K, CHUNK = 16, 5, 16
KEY_BASE, KEY_STEP = 10**10, 7919  # keys far from their slots


def _rows(n, seed, d=D):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _keys(lo, hi):
    return KEY_BASE + KEY_STEP * np.arange(lo, hi, dtype=np.int64)


def _index(n=300, device="cpu", d=D, bulk=False, capacity=1024):
    idx = HNSWIndex(d, capacity=capacity, device=device)
    if bulk:
        idx.bulk_threshold = 64
    idx.add(_rows(n, 1, d), _keys(0, n))
    return idx


def reference(idx, queries, k, chunk):
    """The search as it was: each chunk's results to the host, the key
    map by numpy over the host table."""
    st = idx.store
    outs = [idx.search_device(st.prepare_queries(
        queries[o:o + chunk], idx.query_transfer_dtype), k)
        for o in range(0, len(queries), chunk)]
    scores = torch.cat([o[0] for o in outs]).cpu().numpy()
    slots = torch.cat([o[1] for o in outs]).cpu().numpy()
    keys = np.where(slots >= 0, st._keys[np.maximum(slots, 0)],
                    np.int64(-1))
    return scores, keys


def assert_as_before(idx, queries, k=K, chunk=CHUNK):
    got = idx.search(queries, k, chunk=chunk)
    want = reference(idx, queries, k, chunk)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int64
    assert got[0].shape == got[1].shape == (len(queries), k)
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  want[0].view(np.int32))
    np.testing.assert_array_equal(got[1], want[1])
    return got


@pytest.fixture(scope="module")
def index():
    return _index()


@pytest.mark.parametrize("transfer", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b", [1, CHUNK - 1, CHUNK, 2 * CHUNK + 3])
def test_batch_sizes_and_transfers(index, b, transfer):
    index.query_transfer_dtype = transfer
    try:
        _, keys = assert_as_before(index, _rows(b, 100 + b))
    finally:
        index.query_transfer_dtype = "f32"
    assert (keys >= KEY_BASE).all()


def test_missing_results_are_minus_one():
    """k past the live rows: the slots past them are -1, and so are
    their keys (the table's end sentinel)."""
    idx = _index(n=6)
    _, keys = assert_as_before(idx, _rows(3, 7), k=10)
    assert (keys[:, 6:] == -1).all() and (keys[:, :6] >= KEY_BASE).all()


def test_empty_batch():
    scores, keys = _index(n=6).search(np.zeros((0, D), np.float32), K)
    assert scores.shape == keys.shape == (0, K)


def _save_load(idx, tmp_path, how, monkeypatch):
    if how == "npz":
        monkeypatch.setattr(persist, "get_lib", lambda: None)
    path = str(tmp_path / "ix.vss")
    persist.save_index(idx, path)
    return persist.load_index(path, lazy=how == "lazy", device="cpu")


@pytest.mark.parametrize("writer", [
    "bulk_add", "incremental_add", "remove", "hnsw_compact", "rename",
    "reserve", "persist", "persist_lazy", "persist_npz", "convert"])
def test_after_each_writer(writer, tmp_path, monkeypatch):
    """Each writer of the key table after a search has made its device
    copy: the next search answers as the host table says."""
    if writer == "bulk_add":
        idx = HNSWIndex(D, capacity=1024, device="cpu")
        idx.bulk_threshold = 64
        idx.search(_rows(4, 2), K)  # the copy of an empty table
        idx.add(_rows(300, 1), _keys(0, 300))
        assert idx.build_stats  # the bulk build ran
        assert_as_before(idx, _rows(40, 3))
        return
    idx = _index()
    q = _rows(300, 1)[::7]  # stored rows: their own slots come back
    assert_as_before(idx, q)
    if writer == "incremental_add":
        new = _rows(40, 4)
        idx.add(new, _keys(1000, 1040))
        _, keys = assert_as_before(idx, new)
        assert set(_keys(1000, 1040)) <= set(keys.ravel().tolist())
    elif writer == "remove":
        idx.remove(_keys(0, 300)[::7][:20])
        _, keys = assert_as_before(idx, q)
        assert not set(_keys(0, 300)[::7][:20]) & set(keys.ravel().tolist())
    elif writer == "hnsw_compact":
        idx.remove(_keys(0, 150))
        idx.compact()
        assert_as_before(idx, q)
    elif writer == "rename":
        assert idx.rename(int(_keys(0, 1)[0]), 42)
        _, keys = assert_as_before(idx, q)
        assert keys[0, 0] == 42
    elif writer == "reserve":
        cap = idx.store.capacity
        idx.reserve(cap + 1)
        assert idx.store.capacity > cap
        assert_as_before(idx, q)
        idx.add(_rows(cap, 5), _keys(2000, 2000 + cap))  # past the old end
        assert_as_before(idx, _rows(cap, 5)[::31])
    elif writer == "convert":
        back = convert.index_from_arrays(convert.index_to_arrays(idx),
                                         idx.config, device="cpu")
        np.testing.assert_array_equal(back.search(q, K)[1],
                                      idx.search(q, K)[1])
        assert_as_before(back, q)
    else:
        how = {"persist": "native", "persist_lazy": "lazy",
               "persist_npz": "npz"}[writer]
        back = _save_load(idx, tmp_path, how, monkeypatch)
        np.testing.assert_array_equal(back.search(q, K)[1],
                                      idx.search(q, K)[1])
        assert_as_before(back, q)


@pytest.mark.parametrize("writer", ["add", "remove", "compact", "reserve"])
def test_flat_key_copy_follows_writers(writer):
    """FlatIndex.keys_of after each of the store's own writers equals
    the host table's map."""
    fi = FlatIndex(D, capacity=1024, device="cpu")
    fi.add(_rows(300, 1), _keys(0, 300))
    slots = torch.tensor([[0, 5, -1], [299, 17, 3]])
    if writer in ("add", "compact"):
        fi.remove(_keys(0, 100))
    fi.keys_of(slots)  # the device copy, made before the write
    if writer == "add":
        fi.add(_rows(10, 2), _keys(500, 510))  # reuses slots of 0-99
    elif writer == "remove":
        fi.remove(_keys(0, 300)[[5, 17]])
    elif writer == "compact":
        fi.compact()
    else:
        fi.reserve(3000)
        slots = torch.tensor([[0, 1500, -1], [2299, 17, 1024]])
    s = slots.numpy()
    want = np.where(s >= 0, fi._keys[np.maximum(s, 0)], np.int64(-1))
    np.testing.assert_array_equal(fi.keys_of(slots).numpy(), want)


def test_results_are_the_callers_own(index):
    """A call's arrays stay as they were through later calls."""
    first = index.search(_rows(CHUNK + 3, 11), K, chunk=CHUNK)
    kept = [a.copy() for a in first]
    second = index.search(_rows(CHUNK + 3, 12), K, chunk=CHUNK)
    for a, b, c in zip(first, kept, second):
        np.testing.assert_array_equal(a, b)
        assert not np.shares_memory(a, c)
    assert not np.array_equal(first[1], second[1])


def test_no_waits_counted_on_the_cpu(index, tmp_path):
    tracing.reset_counters()
    with tracing.trace(str(tmp_path)):
        index.search(_rows(CHUNK + 3, 13), K, chunk=CHUNK)
    c = tracing.counters()
    tracing.reset_counters()
    assert c["search.queries"] == CHUNK + 3
    assert "index.host_waits" not in c


# -- on the card -----------------------------------------------------------

CARD_ROWS, CARD_D, CELL_B = 65_536, 128, 10_000


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -o "
                    "addopts='' -m gpu --noconftest "
                    "tests/test_torch_search_transfer.py` on the GPU machine")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_index():
    dev = _card()
    return _index(n=CARD_ROWS, device=dev, d=CARD_D, bulk=True,
                  capacity=CARD_ROWS)


@pytest.mark.gpu
@pytest.mark.parametrize("transfer", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b", [1, CELL_B])
def test_pinned_path_on_card(card_index, b, transfer):
    """The batch cell's chunks (8,192 + 1,808) and one query, through
    the pinned buffers, as the search was, bit for bit."""
    card_index.query_transfer_dtype = transfer
    try:
        _, keys = assert_as_before(card_index, _rows(b, 20 + b, CARD_D),
                                   chunk=8192)
    finally:
        card_index.query_transfer_dtype = "f32"
    assert (keys >= KEY_BASE).all()


@pytest.mark.gpu
def test_results_are_the_callers_own_on_card(card_index):
    q1, q2 = _rows(CELL_B, 31, CARD_D), _rows(CELL_B, 32, CARD_D)
    first = card_index.search(q1, K)
    kept = [a.copy() for a in first]
    second = card_index.search(q2, K)
    for a, b, c in zip(first, kept, second):
        np.testing.assert_array_equal(a, b)
        assert not np.shares_memory(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, CELL_B])
def test_one_wait_per_call_on_card(card_index, b, tmp_path):
    """After a warm call: ``index.host_waits`` counts one a call under
    the profiler, torch's sync debug mode sees no synchronizing call but
    the stream's synchronize, and the pinned buffers are not allocated
    again."""
    import chip_smoke

    q = _rows(b, 40 + b, CARD_D)
    card_index.search(q, K)
    bufs = [card_index._pinned_in._buf, card_index._pinned_out._buf]
    ptrs = [x.data_ptr() for x in bufs]
    syncs = chip_smoke.host_syncs(lambda: card_index.search(q, K))
    # the one: the explicit stream synchronize after the results' copy
    assert sum(syncs.values()) <= 1, syncs
    assert all(at.startswith("torch/cuda/streams.py") for at in syncs), syncs
    tracing.reset_counters()
    with tracing.trace(str(tmp_path)):
        for _ in range(3):
            card_index.search(q, K)
    c = tracing.counters()
    tracing.reset_counters()
    assert c["index.host_waits"] == 3
    assert [card_index._pinned_in._buf.data_ptr(),
            card_index._pinned_out._buf.data_ptr()] == ptrs
