"""HNSWIndex — the user-facing HNSW index (port of
duckdb_vss_tpu/models/hnsw.py).

Owns the vector store (FlatIndex), the graph (GraphState), the config,
the level sampler, tombstone bookkeeping and the distance counters.

``add`` into an empty index with at least 4096 rows is the bulk build
(``CREATE INDEX``); any other batch is inserted incrementally, in
batches of ``build_batch`` rows (models/build.insert_batch). ``search``
(``ORDER BY ... LIMIT k``) runs the fused beam kernel K1 over the int8
neighborhood layout while that layout is active and ef <= 128, expand
<= 8, and the step-by-step beam otherwise (layout="flat", a table over
the memory budget, wider beams); with ``use_pallas`` that beam scores
through kernel K2.

Where the JAX package reads ``DVT_*`` environment variables, the
constructor takes keyword arguments with the same defaults. Not here
yet: the augmented traversal table, the bf16 store, isolate, compact
and the other maintenance calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from duckdb_vss_tpu_torch.models.build import insert_batch
from duckdb_vss_tpu_torch.models.bulk import bulk_build
from duckdb_vss_tpu_torch.models.flat import FlatIndex
from duckdb_vss_tpu_torch.models.graph import (L_MAX, grow_graph, make_graph,
                                               make_neighborhood_tables,
                                               search_graph,
                                               update_neighborhood_rows)
from duckdb_vss_tpu_torch.ops.fused_beam import pack_meta
from duckdb_vss_tpu_torch.utils.config import HNSWConfig, MetricKind
from duckdb_vss_tpu_torch.utils.padding import round_up

DEFAULT_BUILD_BATCH = 256
# cap on the upper-level construction beams' steps: those beams only wire
# upper edges (mxu_descent seeds the base layer), so it can sit low
BUILD_MAX_STEPS_UPPER = 16
# the JAX package's default budget for the int8 neighborhood table
# (DVT_NBR_BUDGET_GB=6); above it the step-by-step beam runs
NBR_BUDGET_BYTES = 6 << 30


def _default_build_steps(ef_c: int, expand: int) -> int:
    """Cap on the construction base beam's steps: ef_c // (2 expand),
    floor 12 (16 at the ef_c=128 / expand=4 defaults). The batched beam
    steps until EVERY row converges, so uncapped one straggler bills
    the whole batch; mxu_descent's exact seeding is why so few suffice."""
    return max(12, ef_c // (2 * max(expand, 1)))


class HNSWIndex:
    """HNSW index over row-keyed float vectors, on one device."""

    def __init__(
        self,
        dims: int,
        config: HNSWConfig | None = None,
        capacity: int = 1024,
        seed: int = 0x5EED,
        device: str | torch.device = "cuda",
        build_batch: int = DEFAULT_BUILD_BATCH,
        build_expand: int = 4,  # beam entries expanded per insert step
        build_prune: str = "diversity",
        build_backlink_cols: int | None = 4,  # back-edges are requested
        # from the closest forward targets only; far targets reject the
        # new node under diversity pruning anyway
        build_max_steps: int | None = None,  # cap on the insert base
        # beam's steps; None = _default_build_steps, 0 = no cap
        build_r_rounds: int = 2,  # back-link conflict-resolution rounds
        traversal_dtype: str = "bf16",  # table the step-by-step beam and
        # the beam descent score against: "bf16" (a half-size copy of the
        # store) or "f32" (the store itself); results are reranked in f32
        layout: str = "auto",  # "auto" (int8 neighborhood tiles when they
        # fit the budget) | "neighborhood" (force) | "flat" (per-candidate
        # gathers)
        descent: str = "mxu",  # "mxu" (score every upper node) | "beam"
        use_pallas: bool = False,  # the step-by-step beam scores through
        # the gather+score kernel K2 (needs traversal_dtype="f32")
        use_pallas_beam: bool = True,  # the fused beam kernel K1, when
        # the neighborhood layout is active
        hop_rerank: int = 0,  # one-hop exact rerank expansion at the finish
    ):
        if traversal_dtype not in ("f32", "bf16"):
            raise ValueError("traversal_dtype must be f32 or bf16, got "
                             f"{traversal_dtype!r}")
        if layout not in ("auto", "neighborhood", "flat"):
            raise ValueError("layout must be auto, neighborhood or flat, "
                             f"got {layout!r}")
        if descent not in ("mxu", "beam"):
            raise ValueError(f"descent must be mxu or beam, got {descent!r}")
        self.config = config or HNSWConfig()
        self.store = FlatIndex(dims, self.config.metric, capacity,
                               device=device)
        self.device = self.store.device
        self.graph = make_graph(self.store.capacity, self.config.m,
                                self.config.m0, self.device)
        self.build_batch = int(build_batch)
        self.build_expand = int(build_expand)
        self.build_prune = str(build_prune)
        self.build_backlink_cols = (None if build_backlink_cols is None
                                    else int(build_backlink_cols))
        self.build_max_steps = build_max_steps
        self.build_r_rounds = int(build_r_rounds)
        self.traversal_dtype = traversal_dtype
        self.layout = layout
        self.descent = descent
        self.use_pallas = bool(use_pallas)
        self.use_pallas_beam = bool(use_pallas_beam)
        self.hop_rerank = int(hop_rerank)
        # bulk loads into an empty graph at/above this size take bulk_build
        self.bulk_threshold = 4096
        self.nbr_budget_bytes = NBR_BUDGET_BYTES
        self._trav_cache = None
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
            self._nbr_cache = None  # the tables' shape follows the capacity

    def _traversal_vectors(self):
        """The bf16 traversal copy of the store for the step-by-step
        beam and the beam descent, made at the first search after an
        add; None for traversal_dtype="f32" (the store itself)."""
        if self.traversal_dtype == "f32":
            return None
        if self._trav_cache is None:
            self._trav_cache = self.store._vectors.to(torch.bfloat16)
        return self._trav_cache

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
        [cap, M0], nbr_meta [cap, W] int32): the int8 neighborhood
        layout, built at the first use after a bulk build or a capacity
        growth and kept current by the incremental insert. Four Nones
        when the layout is off: layout="flat", or "auto" with a table
        over the memory budget."""
        if self.layout == "flat":
            return None, None, None, None
        m0 = self.graph.neighbors0.shape[1]
        table_bytes = self.store.capacity * m0 * self.store.d_pad
        if self.layout != "neighborhood" \
                and table_bytes > self.nbr_budget_bytes:
            return None, None, None, None
        if self._nbr_cache is None:
            vecs_i8, scale, sq = make_neighborhood_tables(
                self.store._vectors, self.store._vec_sq,
                self.graph.neighbors0)
            meta = pack_meta(self.graph.neighbors0, scale, sq)
            self._nbr_cache = (vecs_i8, scale, sq, meta)
        return self._nbr_cache

    # ------------------------------------------------------------------
    def add(self, vectors: np.ndarray, keys, on_progress=None) -> np.ndarray:
        """Bulk or incremental insert. Returns the assigned slot ids.

        on_progress, if given, is called as on_progress(fraction) with
        the build fraction in [0, 1]."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        keys = np.asarray(keys, np.int64).reshape(-1)
        n = vectors.shape[0]
        graph_empty = int(self.graph.entry_node) < 0
        self.reserve(self.store.size + n)
        slots = self.store.add(vectors, keys)
        self._trav_cache = None
        self._upper_cache = None
        # the neighborhood layout stays valid across adds: storing new
        # vectors touches no existing row's neighbor list, and the
        # incremental path below refreshes the rows each batch changes.
        # Only a capacity growth (reserve) or the bulk path drops it.
        levels = self._sample_levels(n)

        if graph_empty and n >= self.bulk_threshold:
            if on_progress is not None:
                on_progress(0.0)
            stats: dict = {}
            self.graph = bulk_build(
                self.store._vectors, self.store._vec_sq,
                np.asarray(slots, np.int32), levels, self.config, self.metric,
                host_vectors=vectors, stats_out=stats)
            self.build_distance_count += stats["n_distances"]
            self.build_stats = stats
            self._nbr_cache = None  # whole graph replaced
            if on_progress is not None:
                on_progress(1.0)
            return slots

        bb, cfg = self.build_batch, self.config
        # when the int8 layout is active each batch's base-layer beam
        # reads it, and the batch then refreshes only its changed rows
        nv, nsc, nsq, nmeta = self._neighborhood_tables()
        msb = self.build_max_steps
        if msb is None:
            msb = _default_build_steps(cfg.ef_construction, self.build_expand)
        msb = int(msb) or None
        msu = BUILD_MAX_STEPS_UPPER if msb else None
        # one transfer for every batch's slots and levels
        n_steps = (n + bb - 1) // bb
        all_slots = np.full((n_steps * bb,), -1, np.int32)
        all_levels = np.zeros((n_steps * bb,), np.int32)
        all_slots[:n], all_levels[:n] = slots, levels
        all_slots_t = torch.from_numpy(all_slots).to(self.device)
        all_levels_t = torch.from_numpy(all_levels).to(self.device)
        nd_total = torch.zeros((), dtype=torch.int64, device=self.device)
        for i in range(n_steps):
            slots_t = all_slots_t[i * bb:(i + 1) * bb]
            self.graph, nd = insert_batch(
                self.graph, self.store._vectors, self.store._vec_sq, slots_t,
                all_levels_t[i * bb:(i + 1) * bb], cfg.metric, cfg.m, cfg.m0,
                cfg.ef_construction, expand=self.build_expand,
                prune=self.build_prune,
                backlink_cols=self.build_backlink_cols,
                r_rounds=self.build_r_rounds, max_steps_base=msb,
                max_steps_upper=msu, nbr_vecs=nv, nbr_scale=nsc, nbr_sq=nsq)
            if nv is not None:
                update_neighborhood_rows(
                    nv, nsc, nsq, nmeta, self.store._vectors,
                    self.store._vec_sq, self.graph.neighbors0, slots_t)
            nd_total += nd
            if on_progress is not None:
                on_progress(min(1.0, (i + 1) * bb / max(n, 1)))
        self.build_distance_count += int(nd_total)
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
        descent_ef: int = 48,
        n_seeds: int = 8,
        chunk: int = 8192,
        max_steps: int | None = None,
        hop_rerank: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """ANN top-k. ef defaults to config.ef_search and is rounded up
        to a multiple of 16; hop_rerank defaults to the index's setting.
        Queries run in chunks of ``chunk`` rows; every chunk's results
        come back in one host transfer. Returns (scores, keys [B, k])."""
        qarr = np.asarray(queries, np.float32)
        if qarr.ndim == 1:
            qarr = qarr[None, :]
        outs = [self.search_device(
            self.store.prepare_queries(qarr[off:off + chunk]), k, ef, expand,
            max_steps, n_seeds, hop_rerank, descent_ef)
            for off in range(0, qarr.shape[0], chunk)]
        if not outs:
            return (np.zeros((0, k), np.float32), np.zeros((0, k), np.int64))
        scores = torch.cat([o[0] for o in outs]).cpu().numpy()
        slots = torch.cat([o[1] for o in outs]).cpu().numpy()
        self.search_distance_count += int(sum(o[2] for o in outs))
        keys = np.where(slots >= 0, self.store._keys[np.maximum(slots, 0)],
                        np.int64(-1))
        return scores, keys

    def search_device(self, queries_padded: torch.Tensor, k: int,
                      ef: int | None = None, expand: int = 4,
                      max_steps: int | None = None, n_seeds: int = 8,
                      hop_rerank: int | None = None, descent_ef: int = 48):
        """Device-resident search: returns (scores, slots, n_dist) tensors."""
        hop = min(self.hop_rerank if hop_rerank is None else int(hop_rerank),
                  k)
        ef_eff = round_up(max(int(ef or self.config.ef_search), k), 16)
        uv, uvsq, unode = (self._upper_vectors() if self.descent == "mxu"
                           else (None, None, None))
        nv, nscale, nsq, nmeta = self._neighborhood_tables()
        # with the neighborhood layout the base beam reads the tiles; the
        # traversal copy is then only the beam descent's
        want_trav = self.descent == "beam" or nv is None
        return search_graph(
            self.graph, self.store._vectors, self.store._vec_sq,
            self.store._valid, queries_padded, int(k), ef_eff, self.metric,
            expand=expand, max_steps=max_steps, use_pallas=self.use_pallas,
            descent_ef=descent_ef, n_seeds=n_seeds, descent_steps=16,
            traversal_vectors=(self._traversal_vectors() if want_trav
                               else None),
            descent=self.descent, upper_vecs=uv, upper_vec_sq=uvsq,
            upper_nodes=unode, nbr_vecs=nv, nbr_scale=nscale, nbr_sq=nsq,
            nbr_meta=nmeta,
            pallas_beam=self.use_pallas_beam and nv is not None,
            hop_rerank=hop)
