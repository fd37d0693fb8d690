"""HNSWIndex — the user-facing HNSW index (port of
duckdb_vss_tpu/models/hnsw.py).

Owns the vector store (FlatIndex), the graph (GraphState), the search's
derived tables (graph.SearchTables, ``tables``), the config, the level
generator, tombstone bookkeeping and the distance counters.

``add`` into an empty index with at least ``bulk_threshold`` rows
(4096) is the bulk build
(``CREATE INDEX``); any other batch is inserted incrementally, in
batches of ``build_batch`` rows (models/build.insert_batch). ``search``
(``ORDER BY ... LIMIT k``) runs the fused beam kernel K1 over the int8
neighborhood layout while that layout is active and ef <= 128, expand
<= 8, and the step-by-step beam otherwise (layout="flat", a table over
the memory budget, wider beams); with ``use_pallas`` that beam scores
through kernel K2.

Maintenance and the rest of the index surface: ``remove`` (tombstones),
``isolate`` (drop edges into tombstones), ``compact`` (renumber the live
nodes, remap every edge), ``stats`` (pragma_hnsw_index_info), the usearch
helpers (contains, count, rename, get_vector, distance_between,
export_keys), ``cluster`` (nearest node at an upper level) and ``join``
(a stable matching against another index). utils/persist.py saves and
loads the index; a lazy load parks a loader in ``_pending_load`` that
the first data-touching call runs (``_ensure_loaded``).

Where the JAX package reads ``DVT_*`` environment variables, the
constructor takes keyword arguments with the same defaults.
"""

from __future__ import annotations

import numpy as np
import torch

from duckdb_vss_tpu_torch.models.build import insert_batch
from duckdb_vss_tpu_torch.models.bulk import BULK_THRESHOLD, bulk_build
from duckdb_vss_tpu_torch.models.flat import (TRANSFER_DTYPES, FlatIndex,
                                              PinnedBuffer)
from duckdb_vss_tpu_torch.models.graph import (L_MAX, GraphState,
                                               SearchTables, compact_graph,
                                               compaction_plan, gather_scores,
                                               greedy_descent,
                                               grow_graph, make_graph,
                                               sample_levels, search_graph,
                                               update_neighborhood_rows)
from duckdb_vss_tpu_torch.ops.distance import pair_scores
from duckdb_vss_tpu_torch.utils.config import HNSWConfig, MetricKind
from duckdb_vss_tpu_torch.utils.padding import round_up
from duckdb_vss_tpu_torch.utils.tracing import annotate, count, span

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


def _isolate(neighbors0: torch.Tensor, upper_neighbors: torch.Tensor,
             valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mask edges into tombstoned slots; base lists also pack their live
    entries first (a stable sort), upper lists are mask-only (traversal
    skips -1 anywhere in a list), as in the JAX package."""

    def mask(tbl):
        ok = (tbl >= 0) & valid[tbl.clamp_min(0).long()]
        return torch.where(ok, tbl, -1)

    nb0 = mask(neighbors0)
    order = torch.sort((nb0 < 0).to(torch.uint8), dim=1, stable=True).indices
    return torch.gather(nb0, 1, order), mask(upper_neighbors)


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
        scalar_kind: str = "f32",  # the store's precision, "f32" | "bf16"
        # (the traversal copy then aliases the store)
        use_aug: bool = False,  # the augmented traversal table for the
        # step-by-step base beam when there is no neighborhood layout
        query_transfer_dtype: str = "f32",  # "f32" | "bf16" | "int8": how
        # search sends queries to the device (FlatIndex.prepare_queries)
        _defer_alloc: bool = False,  # persist.load_index's lazy path
    ):
        if query_transfer_dtype not in TRANSFER_DTYPES:
            raise ValueError(f"query_transfer_dtype must be one of "
                             f"{TRANSFER_DTYPES}, got {query_transfer_dtype!r}")
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
                               device=device, scalar_kind=scalar_kind,
                               defer_alloc=_defer_alloc)
        self.device = self.store.device
        self.graph = None if _defer_alloc else make_graph(
            self.store.capacity, self.config.m, self.config.m0, self.device)
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
        self.use_aug = bool(use_aug)
        self.query_transfer_dtype = query_transfer_dtype
        # bulk loads into an empty graph at/above this size take bulk_build
        self.bulk_threshold = BULK_THRESHOLD
        self.nbr_budget_bytes = NBR_BUDGET_BYTES
        self.tables = SearchTables(self, lambda ix: (
            ix.graph, ix.store._vectors, ix.store._vec_sq), self.config.metric)
        # search's page-locked staging on a card: the queries on their
        # way up and the results on their way down
        self._pinned_in = PinnedBuffer()
        self._pinned_out = PinnedBuffer()
        self._level_rng = np.random.default_rng(seed)
        # distance counters (usearch computed_distances); the search
        # count's newest part stays on the device until it is read
        self.build_distance_count = 0
        self.search_distance_count = 0
        self.build_stats: dict = {}  # the last bulk build's stats_out
        self.is_dirty = False  # changed since the last save
        # a lazy load parks its loader here; the first data-touching call
        # runs it (the reference defers an index's load to first access)
        self._pending_load = None

    def _ensure_loaded(self) -> None:
        if self._pending_load is not None:
            fn, self._pending_load = self._pending_load, None
            fn(self)

    # ------------------------------------------------------------------
    @property
    def search_distance_count(self) -> int:
        """Distances computed by searches (and ``cluster``): an int,
        read back from the device here and not on every search."""
        if self._search_nd_dev is not None:
            self._search_nd += int(self._search_nd_dev)
            self._search_nd_dev = None
        return self._search_nd

    @search_distance_count.setter
    def search_distance_count(self, value: int) -> None:
        self._search_nd, self._search_nd_dev = int(value), None

    def _add_search_distances(self, n_dist: torch.Tensor) -> None:
        """Add a device count to search_distance_count, on the device."""
        self._search_nd_dev = (n_dist if self._search_nd_dev is None
                               else self._search_nd_dev + n_dist)

    @property
    def dims(self) -> int:
        return self.store.dims

    @property
    def metric(self) -> MetricKind:
        return self.config.metric

    def __len__(self) -> int:
        return self.store.size

    def reserve(self, n: int) -> None:
        self.store.reserve(n)
        if self.store.capacity > self.graph.capacity:
            self.graph = grow_graph(self.graph, self.store.capacity)
            # the tables' shape follows the capacity
            self.tables.drop("upper", "nbr")

    # ------------------------------------------------------------------
    @span("index.add")
    def add(self, vectors: np.ndarray, keys, on_progress=None) -> np.ndarray:
        """Bulk or incremental insert. Returns the assigned slot ids.

        on_progress, if given, is called as on_progress(fraction) with
        the build fraction in [0, 1]."""
        self._ensure_loaded()
        self.is_dirty = True
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        keys = np.asarray(keys, np.int64).reshape(-1)
        n = vectors.shape[0]
        graph_empty = int(self.graph.entry_node) < 0
        self.reserve(self.store.size + n)
        slots = self.store.add(vectors, keys)
        # the neighborhood layout stays valid across adds: storing new
        # vectors touches no existing row's neighbor list, and the
        # incremental path below refreshes the rows each batch changes.
        # Only a capacity growth (reserve) or the bulk path drops it.
        self.tables.drop("upper", "trav", "aug")
        levels = sample_levels(self._level_rng, n, self.config.m)

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
            self.tables.drop("nbr")  # whole graph replaced
            if on_progress is not None:
                on_progress(1.0)
            return slots

        bb, cfg = self.build_batch, self.config
        # when the int8 layout is active each batch's base-layer beam
        # reads it, and the batch then refreshes only its changed rows
        nv, nsc, nsq, nmeta = (self.tables.neighborhood(
            self.layout, self.nbr_budget_bytes) or (None,) * 4)
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
            count("insert.rows", min(bb, n - i * bb))
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
        self._ensure_loaded()
        n = self.store.remove(keys)
        if n:
            self.is_dirty = True
        return n

    def isolate(self) -> None:
        """Drop every edge pointing INTO a tombstoned node; tombstoned
        nodes keep their outgoing edges (usearch isolate()). One masked
        gather and a stable repack over the whole adjacency."""
        self._ensure_loaded()
        nb0, un = _isolate(self.graph.neighbors0, self.graph.upper_neighbors,
                           self.store._valid)
        self.graph = self.graph._replace(neighbors0=nb0, upper_neighbors=un)
        self.tables.drop("nbr")
        self.is_dirty = True

    # ------------------------------------------------------------------
    @span("index.search")
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
        Queries go to the device as ``query_transfer_dtype``, in chunks of
        ``chunk`` rows; on a card each chunk is staged in page-locked
        memory and copied up without waiting, so the host prepares and
        issues the next chunk while the card runs this one. The slots
        become keys on the device, and every chunk's scores and keys come
        back in one copy after the call's one wait. Returns (scores, keys
        [B, k]), arrays of the caller's own."""
        self._ensure_loaded()
        qarr = np.asarray(queries, np.float32)
        if qarr.ndim == 1:
            qarr = qarr[None, :]
        if qarr.shape[0] == 0:
            return (np.zeros((0, k), np.float32), np.zeros((0, k), np.int64))
        stage = None
        if self.device.type == "cuda":
            self._pinned_in.start()
            stage = self._pinned_in.take
        outs = []
        for off in range(0, qarr.shape[0], chunk):
            with annotate("index.upload"):
                q = self.store.prepare_queries(qarr[off:off + chunk],
                                               self.query_transfer_dtype,
                                               stage)
            outs.append(self.search_device(q, k, ef, expand, max_steps,
                                           n_seeds, hop_rerank, descent_ef))
        self._add_search_distances(sum(o[2] for o in outs))
        with annotate("index.download"):
            keys = self.store.keys_of(torch.cat([o[1] for o in outs]))
            return self._fetch(torch.cat([o[0] for o in outs]), keys)

    def _fetch(self, scores: torch.Tensor, keys: torch.Tensor
               ) -> tuple[np.ndarray, np.ndarray]:
        """Device scores [B, k] f32 and keys [B, k] int64 as fresh host
        arrays, in one copy: packed as int32 words [B, 3k] (the scores'
        bits, then the keys' halves). On a card the copy goes into the
        pinned output buffer without waiting, then the host waits once,
        counted as ``index.host_waits``; the arrays are copies, since the
        buffer is written again by the next call."""
        k = scores.shape[1]
        words = torch.cat([scores.view(torch.int32), keys.view(torch.int32)],
                          1)
        if self.device.type == "cuda":
            self._pinned_out.start()
            host = self._pinned_out.take(words.shape, words.dtype)
            host.copy_(words, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            count("index.host_waits", 1)
            words = host
        words = words.numpy()
        return (words[:, :k].copy().view(np.float32),
                words[:, k:].copy().view(np.int64))

    def search_device(self, queries_padded: torch.Tensor, k: int,
                      ef: int | None = None, expand: int = 4,
                      max_steps: int | None = None, n_seeds: int = 8,
                      hop_rerank: int | None = None, descent_ef: int = 48):
        """Device-resident search: returns (scores, slots, n_dist) tensors.
        The index's settings pick the tables it asks for
        (SearchTables.for_search); search_graph takes its path from
        them."""
        self._ensure_loaded()
        hop = min(self.hop_rerank if hop_rerank is None else int(hop_rerank),
                  k)
        ef_eff = round_up(max(int(ef or self.config.ef_search), k), 16)
        tables = self.tables.for_search(
            self.layout, self.nbr_budget_bytes, descent=self.descent,
            traversal=self.traversal_dtype, use_aug=self.use_aug,
            fused=self.use_pallas_beam)
        return search_graph(
            self.graph, self.store._vectors, self.store._vec_sq,
            self.store._valid, queries_padded, int(k), ef_eff, self.metric,
            tables, expand=expand, max_steps=max_steps,
            use_pallas=self.use_pallas, descent_ef=descent_ef,
            n_seeds=n_seeds, descent_steps=16, hop_rerank=hop)

    # ------------------------------------------------------------------
    def compact(self) -> None:
        """Slot permutation compaction (usearch compact(); PRAGMA
        hnsw_compact_index). Capacity is kept. Live nodes move to the
        front ordered by level descending, then by old slot
        (graph.compaction_plan); every edge is remapped through the
        permutation, and edges into tombstoned nodes are dropped
        (isolate()). Dead rows are written as +0.0. Every table is
        dropped."""
        self._ensure_loaded()
        dev, cap, g = self.device, self.store.capacity, self.graph
        plan = compaction_plan(
            self.store._valid.cpu().numpy(), g.levels.cpu().numpy(),
            g.upper_slot.cpu().numpy(), g.upper_neighbors.shape[0])
        self.graph = compact_graph(g, plan)
        n_live = len(plan.order)

        def padded(rows, fill):
            out = torch.full((cap,) + tuple(rows.shape[1:]), fill,
                             dtype=rows.dtype, device=dev)
            out[:n_live] = rows
            return out

        # the store moves by the same permutation (FlatIndex.compact packs
        # by slot order and shrinks, which the graph cannot follow)
        st = self.store
        perm = torch.from_numpy(plan.order).to(dev)
        st._vectors = padded(st._vectors[perm], 0)
        st._vec_sq = padded(st._vec_sq[perm], 0)
        st._valid = padded(torch.ones((n_live,), dtype=torch.bool,
                                      device=dev), False)
        keys_np = st._keys[plan.order]
        st._keys = np.full((cap,), -1, np.int64)
        st._keys[:n_live] = keys_np
        st._key_to_slot = {int(k): i for i, k in enumerate(keys_np.tolist())}
        st._free_slots = []
        st._next_slot = n_live
        self.tables.drop()
        self.is_dirty = True

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Per-level statistics (pragma_hnsw_index_info): the JAX
        package's keys and values."""
        self._ensure_loaded()
        levels = self.graph.levels.cpu().numpy()
        valid = self.store._valid.cpu().numpy()
        nb0 = self.graph.neighbors0.cpu().numpy()
        live = valid & (levels >= 0)
        n0 = int(live.sum())
        out_levels = [{
            "level": 0, "nodes": n0, "edges": int((nb0[live] >= 0).sum()),
            "max_edges": n0 * self.config.m0,
            "allocated_bytes": int(nb0.nbytes),
        }]
        max_level = int(self.graph.max_level)
        if max_level >= 1:
            un2 = self.graph.upper_neighbors.cpu().numpy()
            un = un2.reshape(un2.shape[0], L_MAX, -1)
            uslot = self.graph.upper_slot.cpu().numpy()
            for lvl in range(1, max_level + 1):
                nodes_l = live & (levels >= lvl)
                n_l = int(nodes_l.sum())
                e_l = (int((un[uslot[nodes_l], lvl - 1] >= 0).sum())
                       if n_l else 0)
                out_levels.append({
                    "level": lvl, "nodes": n_l, "edges": e_l,
                    "max_edges": n_l * self.config.m,
                    "allocated_bytes": int(un[:, lvl - 1].nbytes),
                })
        vec = self.store._vectors
        return {
            "metric": self.metric.value,
            "dimensions": self.dims,
            "count": self.store.size,
            "capacity": self.store.capacity,
            "approx_size": int(vec.numel() * vec.element_size() + nb0.nbytes
                               + self.graph.upper_neighbors.numel() * 4),
            "max_level": max_level,
            "entry_node": int(self.graph.entry_node),
            "levels": out_levels,
            "build_distance_count": self.build_distance_count,
            "search_distance_count": self.search_distance_count,
        }

    # ------------------------------------------------------------------
    # usearch index_dense parity helpers (rename, get, distance_between,
    # export_keys, contains, count): the reference extension does not
    # call them, but they complete the index surface
    def contains(self, key: int) -> bool:
        return int(key) in self.store._key_to_slot

    def count(self, key: int) -> int:
        return 1 if self.contains(key) else 0

    def rename(self, old_key: int, new_key: int) -> bool:
        """Reassign a member's key (index_dense rename())."""
        st = self.store
        if int(new_key) in st._key_to_slot:
            return False
        slot = st._key_to_slot.pop(int(old_key), None)
        if slot is None:
            return False
        st._key_to_slot[int(new_key)] = slot
        st._keys[slot] = int(new_key)
        st.keys_changed()
        self.is_dirty = True
        return True

    def get_vector(self, key: int) -> np.ndarray:
        self._ensure_loaded()
        return self.store.get_vector(key)

    def distance_between(self, key_a: int, key_b: int) -> float:
        """Index-metric distance between two members."""
        self._ensure_loaded()
        a, b = (torch.from_numpy(self.store.get_vector(kk)[None, :]).to(
            self.device) for kk in (key_a, key_b))
        return float(pair_scores(a, b, self.metric)[0])

    def export_keys(self) -> np.ndarray:
        """All live member keys, in slot order."""
        keys = self.store._keys
        return keys[keys >= 0].copy()

    # ------------------------------------------------------------------
    def cluster(self, queries: np.ndarray, level: int = 1,
                chunk: int = 1024) -> tuple[np.ndarray, np.ndarray]:
        """Nearest cluster head per query at an upper graph level
        (usearch cluster()): the greedy descent from the entry node down
        to ``level``, whose nodes act as cluster heads. level is clamped
        to [1, max_level]; an index with no upper level clusters
        everything to the entry node. Returns (keys [B], exact scores
        [B])."""
        self._ensure_loaded()
        qarr = np.asarray(queries, np.float32)
        if qarr.ndim == 1:
            qarr = qarr[None, :]
        b = qarr.shape[0]
        lvl = int(np.clip(level, 1, max(int(self.graph.max_level), 1)))
        st = self.store
        nodes, scores = [], []
        for off in range(0, b, chunk):
            q = st.prepare_queries(qarr[off:off + chunk])
            q_sq = (q * q).sum(-1)
            stop = torch.full((q.shape[0],), lvl - 1, dtype=torch.int32,
                              device=self.device)
            cur, _, nd = greedy_descent(self.graph, st._vectors, st._vec_sq,
                                        q, q_sq, stop, self.metric)
            nodes.append(cur)
            scores.append(gather_scores(st._vectors, st._vec_sq, cur[:, None],
                                        q, q_sq, self.metric)[:, 0])
            self._add_search_distances(nd)
        if not nodes:
            return np.zeros((0,), np.int64), np.zeros((0,), np.float32)
        nodes_np = torch.cat(nodes).cpu().numpy()
        keys = np.where(nodes_np >= 0, st._keys[np.maximum(nodes_np, 0)],
                        np.int64(-1))
        return keys, torch.cat(scores).cpu().numpy()

    def join(self, other: "HNSWIndex", k: int = 16,
             ef: int | None = None) -> dict[int, int]:
        """Stable-marriage semantic join against another index (usearch
        join()). Members of ``self`` propose to their nearest neighbors
        in ``other`` (its ANN top-k); Gale-Shapley over those preference
        lists gives a stable matching. A member whose list runs out
        stays unmatched (absent from the result). Returns {self_key:
        other_key}."""
        self._ensure_loaded()
        if self.metric != other.metric or self.dims != other.dims:
            raise ValueError("join requires matching metric and dims")
        men_keys = self.export_keys()
        if len(men_keys) == 0 or len(other) == 0:
            return {}
        k_eff = min(int(k), len(other))
        st = self.store
        slots = torch.tensor([st._key_to_slot[int(kk)] for kk in men_keys],
                             device=self.device)
        vecs = st._vectors[slots, :st.dims].float().cpu().numpy()
        pref_scores, pref_keys = other.search(vecs, k_eff, ef=ef)
        # Gale-Shapley on the host. All three metrics are symmetric, so a
        # member of ``other`` ranks a proposal by the proposer's score.
        next_choice = np.zeros(len(men_keys), np.int64)
        engaged_to: dict[int, int] = {}  # other_key -> proposer index
        engaged_score: dict[int, float] = {}
        free = list(range(len(men_keys)))
        while free:
            m = free.pop()
            while next_choice[m] < k_eff:
                c = int(next_choice[m])
                next_choice[m] += 1
                w = int(pref_keys[m, c])
                s = float(pref_scores[m, c])
                if w < 0:
                    continue
                if w not in engaged_to:
                    engaged_to[w] = m
                    engaged_score[w] = s
                    break
                if s < engaged_score[w]:
                    free.append(engaged_to[w])
                    engaged_to[w] = m
                    engaged_score[w] = s
                    break
        return {int(men_keys[m]): w for w, m in engaged_to.items()}
