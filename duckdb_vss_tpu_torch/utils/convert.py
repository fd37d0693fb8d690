"""Carry an index's state between the JAX package and the port.

Both packages keep the same arrays: the store (``_vectors`` [cap, d_pad]
f32 or bf16, ``_vec_sq`` [cap], ``_valid`` [cap] bool, ``_keys`` [cap]
int64, the free-list and the next fresh slot) and the GraphState
fields. ``index_from_arrays`` builds a port HNSWIndex from them, passed
as numpy, so the port can run on the exact graph the JAX package built;
``index_to_arrays`` does the reverse.

A bf16 store crosses as its bit patterns: numpy has no bfloat16 of its
own, so the port hands out uint16 (``host_array``) and takes any 2-byte
dtype, such as ml_dtypes.bfloat16 or uint16 (``device_tensor``).

``database_from_arrays`` does the same for a whole SQL database: its
settings, its tables (the column declarations, the columns as numpy as
a checkpoint writes them, sql/engine.table_arrays, and the live flags)
and its indexes (each through index_from_arrays); ``database_to_arrays``
is its inverse.

``sharded_from_arrays`` and ``sharded_to_arrays`` do the same for a
ShardedHNSWIndex: the stacked [S, ...] store and graph, the key,
free-list and next-slot state, and the placement. The arrays are the
same whatever the index's grid of devices, so a state carried in or out
fits any mesh of as many shards.
"""

from __future__ import annotations

import numpy as np
import torch

from duckdb_vss_tpu_torch.models.graph import GraphState
from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex
from duckdb_vss_tpu_torch.utils.config import HNSWConfig

GRAPH_FIELDS = GraphState._fields


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bf16 as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def device_tensor(arr: np.ndarray, dtype: torch.dtype,
                  device: torch.device | str) -> torch.Tensor:
    """A numpy array as a ``dtype`` tensor on ``device`` (a copy). For
    bf16, ``arr`` holds the bit patterns in any 2-byte dtype."""
    if dtype == torch.bfloat16:
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)


def index_from_arrays(arrays: dict[str, np.ndarray], config: HNSWConfig,
                      device: str | torch.device = "cuda",
                      **index_settings) -> HNSWIndex:
    """A port HNSWIndex holding ``arrays``: the four store fields, every
    GraphState field, and ``dims``. A 2-byte ``_vectors`` is a bf16
    store (scalar_kind="bf16"). Optional ``_next_slot`` and
    ``_free_slots`` restore the store's slot allocator; by default the
    next slot follows the highest live slot and the free-list is empty.
    The key map is rebuilt from ``_keys``. ``index_settings`` go to the
    HNSWIndex constructor (seed, layout, build_batch, ...)."""
    vectors = np.asarray(arrays["_vectors"])
    cap = vectors.shape[0]
    scalar_kind = "bf16" if vectors.dtype.itemsize == 2 else "f32"
    idx = HNSWIndex(int(arrays["dims"]), config, capacity=cap, device=device,
                    scalar_kind=scalar_kind, **index_settings)
    st = idx.store
    if st.capacity != cap or st.d_pad != vectors.shape[1]:
        raise ValueError(f"store shape {vectors.shape} is not a capacity "
                         f"bucket of width {st.d_pad}")
    dev = idx.device
    st._vectors = device_tensor(vectors, st._dtype, dev)
    st._vec_sq = device_tensor(arrays["_vec_sq"], torch.float32, dev)
    st._valid = device_tensor(arrays["_valid"], torch.bool, dev)
    keys = np.asarray(arrays["_keys"], np.int64).copy()
    st._keys = keys
    live = np.nonzero(keys >= 0)[0]
    st._key_to_slot = {int(keys[s]): int(s) for s in live}
    st.size = len(live)
    st._next_slot = int(arrays.get("_next_slot",
                                   live.max() + 1 if len(live) else 0))
    st._free_slots = [int(s) for s in arrays.get("_free_slots", [])]
    idx.graph = GraphState(**{
        f: device_tensor(arrays[f], torch.int32, dev) for f in GRAPH_FIELDS})
    return idx


def index_to_arrays(index: HNSWIndex) -> dict[str, np.ndarray]:
    """The arrays index_from_arrays takes, as numpy (a bf16 store as
    uint16 bits), and ``scalar_kind``."""
    index._ensure_loaded()
    st = index.store
    out = {
        "dims": np.int64(index.dims),
        "scalar_kind": st.scalar_kind,
        "_vectors": host_array(st._vectors),
        "_vec_sq": st._vec_sq.cpu().numpy(),
        "_valid": st._valid.cpu().numpy(),
        "_keys": st._keys.copy(),
        "_next_slot": np.int64(st._next_slot),
        "_free_slots": np.asarray(st._free_slots, np.int64),
    }
    for f in GRAPH_FIELDS:
        out[f] = getattr(index.graph, f).cpu().numpy()
    return out


def sharded_from_arrays(arrays: dict, config: HNSWConfig, mesh,
                        **index_settings):
    """A port ShardedHNSWIndex on ``mesh`` holding ``arrays``: the stacked
    store (``_vectors`` [S, cap, d_pad], a 2-byte dtype for a bf16
    store, ``_vec_sq``, ``_valid``, ``_keys`` [S, cap]), every
    ShardedGraph field [S, ...], ``_next_slot`` [S], ``_free_slots`` (S
    lists), the placement's ``pl_assign`` and ``pl_load``, and ``dims``.
    ``_vec_sq`` is taken as given, so a JAX graph searches on the same
    numbers; without it the norms are summed by numpy from the rows as
    stored (ShardedHNSWIndex.load). Under a process group each rank
    keeps its own shards. ``index_settings`` go to the constructor
    (seed, layout, ...)."""
    from duckdb_vss_tpu_torch.parallel.sharded import (ShardedGraph,
                                                       ShardedHNSWIndex)

    vectors = np.asarray(arrays["_vectors"])
    s, cap, d_pad = vectors.shape
    assign = np.asarray(arrays["pl_assign"], np.int32)
    idx = ShardedHNSWIndex(
        int(arrays["dims"]), config, mesh, capacity_per_shard=cap,
        placement_alpha=max(1, len(assign) // s),
        scalar_kind="bf16" if vectors.dtype.itemsize == 2 else "f32",
        **index_settings)
    if idx.cap != cap or idx.d_pad != d_pad or idx.n_shards != s:
        raise ValueError(f"store shape {vectors.shape} is not {idx.n_shards} "
                         f"shards of a capacity bucket of width {idx.d_pad}")
    idx._set_shard_arrays(vectors, np.asarray(arrays["_valid"]),
                          {f: arrays[f] for f in ShardedGraph._fields},
                          vec_sq=(np.asarray(arrays["_vec_sq"], np.float32)
                                  if "_vec_sq" in arrays else None))
    keys = np.asarray(arrays["_keys"], np.int64).copy()
    idx._keys = keys
    idx._key_to_slot = [{int(k): j for j, k in enumerate(keys[i].tolist())
                         if k >= 0} for i in range(s)]
    idx._free_slots = [[int(x) for x in f] for f in arrays["_free_slots"]]
    idx._next_slot = np.asarray(arrays["_next_slot"], np.int64).copy()
    idx.placement.assign = assign.copy()
    idx.placement.load = np.asarray(arrays["pl_load"], np.int64).copy()
    return idx


def sharded_to_arrays(index) -> dict:
    """The arrays sharded_from_arrays takes, as numpy over all S shards
    (a bf16 store as uint16 bits), whatever the index's grid; a
    collective under a process group."""
    def fetch(name):
        return host_array(index._gather(name))

    out = {
        "dims": np.int64(index.dims),
        "_vectors": fetch("vectors"),
        "_vec_sq": fetch("vec_sq"),
        "_valid": fetch("valid"),
        "_keys": index._keys.copy(),
        "_next_slot": index._next_slot.copy(),
        "_free_slots": [np.asarray(f, np.int64) for f in index._free_slots],
        "pl_assign": index.placement.assign.copy(),
        "pl_load": index.placement.load.copy(),
    }
    for f in GRAPH_FIELDS:
        out[f] = fetch(f)
    return out


def database_from_arrays(arrays: dict, device: str | torch.device = "cuda"):
    """An in-memory port Database on ``device`` holding ``arrays``:

    {"settings": {...},
     "tables": {name: {"columns": {col: "BIGINT" | ["FLOAT", dims] | ...},
                       "arrays": {col: numpy column, "__live__": bool}}},
     "indexes": {name: {"table": ..., "column": ..., "config": {"metric":
                 "l2sq", "m": .., "m0": .., "ef_construction": ..,
                 "ef_search": ..}, "arrays": index_from_arrays' arrays}}}

    A vector column is [rows, dims] float32 with all-NaN rows for NULL,
    as sql/engine.table_arrays gives it. Rowids stay positions, so the
    carried indexes' keys still name their rows."""
    from duckdb_vss_tpu_torch.sql import engine

    db = engine.Database(device=device)
    db.settings.update(arrays.get("settings", {}))
    for name, tab in arrays["tables"].items():
        t = engine.Table(db, name, {c: tuple(ty) if isinstance(ty, list)
                                    else ty
                                    for c, ty in tab["columns"].items()})
        engine.restore_table(t, tab["arrays"], tab["arrays"]["__live__"])
        db.tables[name] = t
    for name, ent in arrays["indexes"].items():
        idx = index_from_arrays(ent["arrays"],
                                HNSWConfig.from_options(ent["config"]),
                                device=db.device)
        db.indexes[name] = engine.IndexEntry(name, db.tables[ent["table"]],
                                             ent["column"], idx)
    return db


def database_to_arrays(db) -> dict:
    """A port Database as database_from_arrays takes it."""
    from duckdb_vss_tpu_torch.sql import engine

    tables = {}
    for name, t in db.tables.items():
        cols, arrs = engine.table_arrays(t)
        tables[name] = {"columns": cols, "arrays": arrs}
    indexes = {}
    for name, e in db.indexes.items():
        cfg = e.index.config
        indexes[name] = {
            "table": e.table.name, "column": e.column,
            "config": {"metric": cfg.metric.value, "m": cfg.m,
                       "m0": cfg.m0, "ef_construction": cfg.ef_construction,
                       "ef_search": cfg.ef_search},
            "arrays": index_to_arrays(e.index)}
    return {"settings": dict(db.settings), "tables": tables,
            "indexes": indexes}
