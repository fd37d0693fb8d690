"""HNSWIndex — the user-facing HNSW index (port of
duckdb_vss_tpu/models/hnsw.py, the part on the main path).

Owns the vector store (FlatIndex), the graph (GraphState), the config,
the level sampler, tombstone bookkeeping and the distance counters.

This slice covers the path of ``CREATE INDEX ... USING HNSW`` followed by
``ORDER BY array_distance(...) LIMIT k``: ``add`` into an empty index
with at least 4096 rows (the bulk build), then ``search`` through the
fused beam kernel over the int8 neighborhood layout. Calls off that
path raise NotImplementedError naming the slice that brings them; none
of them quietly runs something else.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from duckdb_vss_tpu_torch.models.bulk import bulk_build
from duckdb_vss_tpu_torch.models.flat import FlatIndex
from duckdb_vss_tpu_torch.models.graph import (L_MAX, check_fused_gate,
                                               grow_graph, make_graph,
                                               make_neighborhood_tables,
                                               search_graph)
from duckdb_vss_tpu_torch.ops.fused_beam import pack_meta
from duckdb_vss_tpu_torch.utils.config import HNSWConfig, MetricKind
from duckdb_vss_tpu_torch.utils.padding import round_up

# the JAX package's default budget for the int8 neighborhood table
# (DVT_NBR_BUDGET_GB=6); above it the JAX package runs the non-fused beam
NBR_BUDGET_BYTES = 6 << 30


class HNSWIndex:
    """HNSW index over row-keyed float vectors, on one device."""

    def __init__(
        self,
        dims: int,
        config: HNSWConfig | None = None,
        capacity: int = 1024,
        seed: int = 0x5EED,
        device: str | torch.device = "cuda",
    ):
        self.config = config or HNSWConfig()
        self.store = FlatIndex(dims, self.config.metric, capacity,
                               device=device)
        self.device = self.store.device
        self.graph = make_graph(self.store.capacity, self.config.m,
                                self.config.m0, self.device)
        # bulk loads into an empty graph at/above this size take bulk_build
        self.bulk_threshold = 4096
        self.nbr_budget_bytes = NBR_BUDGET_BYTES
        self._upper_cache = None
        self._nbr_cache = None
        self._level_rng = np.random.default_rng(seed)
        # distance counters (usearch computed_distances)
        self.build_distance_count = 0
        self.search_distance_count = 0
        self.build_stats: dict = {}  # the last bulk build's stats_out

    # ------------------------------------------------------------------
    @property
    def dims(self) -> int:
        return self.store.dims

    @property
    def metric(self) -> MetricKind:
        return self.config.metric

    def __len__(self) -> int:
        return self.store.size

    def _sample_levels(self, n: int) -> np.ndarray:
        """Exponential level sampling -ln(U)/ln(M), the JAX package's
        sampler on the same numpy generator, so both draw the same
        levels from the same seed."""
        u = self._level_rng.random(n)
        inv_log_m = 1.0 / math.log(max(self.config.m, 2))
        lv = np.floor(-np.log(np.maximum(u, 1e-12)) * inv_log_m)
        return np.minimum(lv, L_MAX).astype(np.int32)

    def reserve(self, n: int) -> None:
        self.store.reserve(n)
        if self.store.capacity > self.graph.capacity:
            self.graph = grow_graph(self.graph, self.store.capacity)
            self._upper_cache = None
            self._nbr_cache = None

    def _upper_vectors(self):
        """(rows [u_lim, D] bf16, sq [u_lim] f32, nodes [u_lim] int32): the
        vectors of upper-level nodes for mxu_descent, compacted to a
        power-of-two bucket of upper_count (upper slots are allocated
        sequentially, so rows past upper_count are never live)."""
        if self._upper_cache is None:
            cap_u = self.graph.upper_node.shape[0]
            n_up = int(self.graph.upper_count)
            u_lim = min(cap_u, max(256, 1 << max(0, n_up - 1).bit_length()))
            node = self.graph.upper_node[:u_lim]
            safe = node.clamp_min(0).long()
            live = (node >= 0)
            rows = torch.where(live[:, None], self.store._vectors[safe], 0.0)
            self._upper_cache = (rows.to(torch.bfloat16),
                                 self.store._vec_sq[safe] * live, node)
        return self._upper_cache

    def _neighborhood_tables(self):
        """(nbr_vecs [cap, M0, d_pad] int8, nbr_scale [cap, M0], nbr_sq
        [cap, M0], nbr_meta [cap, W] int32): the int8 neighborhood layout
        the fused kernel reads, built at the first search after a build."""
        m0 = self.graph.neighbors0.shape[1]
        table_bytes = self.store.capacity * m0 * self.store.d_pad
        if table_bytes > self.nbr_budget_bytes:
            raise NotImplementedError(
                f"the int8 neighborhood table needs {table_bytes} bytes, over "
                f"the {self.nbr_budget_bytes}-byte budget; the non-fused beam "
                "search for such indexes arrives with the insert-path slice")
        if self._nbr_cache is None:
            vecs_i8, scale, sq = make_neighborhood_tables(
                self.store._vectors, self.store._vec_sq,
                self.graph.neighbors0)
            meta = pack_meta(self.graph.neighbors0, scale, sq)
            self._nbr_cache = (vecs_i8, scale, sq, meta)
        return self._nbr_cache

    # ------------------------------------------------------------------
    def add(self, vectors: np.ndarray, keys) -> np.ndarray:
        """Bulk load into an empty index (the CREATE INDEX path: models/
        bulk.bulk_build). Returns the assigned slot ids."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        keys = np.asarray(keys, np.int64).reshape(-1)
        n = vectors.shape[0]
        if int(self.graph.entry_node) >= 0 or n < self.bulk_threshold:
            raise NotImplementedError(
                "incremental insert (into a non-empty graph, or fewer than "
                f"{self.bulk_threshold} rows) arrives with the insert-path "
                "slice (models/build.insert_batch)")
        self.reserve(self.store.size + n)
        slots = self.store.add(vectors, keys)
        self._upper_cache = None
        self._nbr_cache = None
        levels = self._sample_levels(n)
        stats: dict = {}
        self.graph = bulk_build(
            self.store._vectors, self.store._vec_sq,
            np.asarray(slots, np.int32), levels, self.config, self.metric,
            host_vectors=vectors, stats_out=stats)
        self.build_distance_count += stats["n_distances"]
        self.build_stats = stats
        return slots

    def remove(self, keys) -> int:
        """Tombstone delete: edges remain, search filters the results."""
        return self.store.remove(keys)

    # ------------------------------------------------------------------
    def search(
        self,
        queries: np.ndarray,
        k: int,
        ef: int | None = None,
        expand: int = 4,
        n_seeds: int = 8,
        chunk: int = 8192,
        max_steps: int | None = None,
        hop_rerank: int = 0,
    ) -> tuple[np.ndarray, np.ndarray]:
        """ANN top-k. ef defaults to config.ef_search and is rounded up
        to a multiple of 16. Queries run in chunks of ``chunk`` rows;
        every chunk's results come back in one host transfer. Returns
        (scores, keys [B, k])."""
        qarr = np.asarray(queries, np.float32)
        if qarr.ndim == 1:
            qarr = qarr[None, :]
        outs = [self.search_device(self.store.prepare_queries(
            qarr[off:off + chunk]), k, ef, expand, max_steps, n_seeds,
            hop_rerank) for off in range(0, qarr.shape[0], chunk)]
        if not outs:
            return (np.zeros((0, k), np.float32), np.zeros((0, k), np.int64))
        scores = torch.cat([o[0] for o in outs]).cpu().numpy()
        slots = torch.cat([o[1] for o in outs]).cpu().numpy()
        self.search_distance_count += int(sum(o[2] for o in outs))
        keys = np.where(slots >= 0, self.store._keys[np.maximum(slots, 0)],
                        np.int64(-1))
        return scores, keys

    def _ef(self, ef, k):
        return round_up(max(int(ef or self.config.ef_search), k), 16)

    def search_device(self, queries_padded: torch.Tensor, k: int,
                      ef: int | None = None, expand: int = 4,
                      max_steps: int | None = None, n_seeds: int = 8,
                      hop_rerank: int = 0):
        """Device-resident search: returns (scores, slots, n_dist) tensors."""
        ef_eff = self._ef(ef, k)
        check_fused_gate(ef_eff, expand, hop_rerank)
        uv, uvsq, unode = self._upper_vectors()
        nv, _scale, _sq, nmeta = self._neighborhood_tables()
        return search_graph(
            self.graph, self.store._vectors, self.store._vec_sq,
            self.store._valid, queries_padded, int(k), ef_eff, self.metric,
            uv, uvsq, unode, nv, nmeta, expand=expand, max_steps=max_steps,
            n_seeds=n_seeds)
