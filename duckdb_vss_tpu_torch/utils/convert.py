"""Carry an index's state between the JAX package and the port.

Both packages keep the same arrays: the store (``_vectors`` [cap, d_pad]
f32, ``_vec_sq`` [cap], ``_valid`` [cap] bool, ``_keys`` [cap] int64)
and the GraphState fields. ``index_from_arrays`` builds a port
HNSWIndex from them, passed as numpy, so the port can run on the exact
graph the JAX package built; ``index_to_arrays`` does the reverse.
"""

from __future__ import annotations

import numpy as np
import torch

from duckdb_vss_tpu_torch.models.graph import GraphState
from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex
from duckdb_vss_tpu_torch.utils.config import HNSWConfig

GRAPH_FIELDS = GraphState._fields


def index_from_arrays(arrays: dict[str, np.ndarray], config: HNSWConfig,
                      device: str | torch.device = "cuda",
                      **index_settings) -> HNSWIndex:
    """A port HNSWIndex holding ``arrays``: the four store fields, every
    GraphState field, and ``dims``. Optional ``_next_slot`` and
    ``_free_slots`` restore the store's slot allocator; by default the
    next slot follows the highest live slot and the free-list is empty.
    ``index_settings`` go to the HNSWIndex constructor (seed, layout,
    build_batch, ...)."""
    vectors = np.asarray(arrays["_vectors"], np.float32)
    cap = vectors.shape[0]
    idx = HNSWIndex(int(arrays["dims"]), config, capacity=cap, device=device,
                    **index_settings)
    st = idx.store
    if st.capacity != cap or st.d_pad != vectors.shape[1]:
        raise ValueError(f"store shape {vectors.shape} is not a capacity "
                         f"bucket of width {st.d_pad}")
    dev = idx.device
    st._vectors = torch.from_numpy(vectors.copy()).to(dev)
    st._vec_sq = torch.from_numpy(
        np.asarray(arrays["_vec_sq"], np.float32).copy()).to(dev)
    st._valid = torch.from_numpy(
        np.asarray(arrays["_valid"], np.bool_).copy()).to(dev)
    keys = np.asarray(arrays["_keys"], np.int64).copy()
    st._keys = keys
    live = np.nonzero(keys >= 0)[0]
    st._key_to_slot = {int(keys[s]): int(s) for s in live}
    st.size = len(live)
    st._next_slot = int(arrays.get("_next_slot",
                                   live.max() + 1 if len(live) else 0))
    st._free_slots = [int(s) for s in arrays.get("_free_slots", [])]
    idx.graph = GraphState(**{
        f: torch.from_numpy(np.asarray(arrays[f], np.int32).copy()).to(dev)
        for f in GRAPH_FIELDS})
    return idx


def index_to_arrays(index: HNSWIndex) -> dict[str, np.ndarray]:
    """The arrays index_from_arrays takes, as numpy."""
    st = index.store
    out = {
        "dims": np.int64(index.dims),
        "_vectors": st._vectors.cpu().numpy(),
        "_vec_sq": st._vec_sq.cpu().numpy(),
        "_valid": st._valid.cpu().numpy(),
        "_keys": st._keys.copy(),
        "_next_slot": np.int64(st._next_slot),
        "_free_slots": np.asarray(st._free_slots, np.int64),
    }
    for f in GRAPH_FIELDS:
        out[f] = getattr(index.graph, f).cpu().numpy()
    return out
