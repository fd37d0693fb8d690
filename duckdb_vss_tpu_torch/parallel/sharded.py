"""Sharded search (port of duckdb_vss_tpu/parallel/sharded.py): keys are
hash-partitioned into S shards, every shard is searched on its own with
the single-index kernels, and the per-shard top-k sets are merged once
per query batch.

In the JAX package each shard lives on its own device and an all-gather
over the mesh merges the per-shard results. Here every shard this
process owns lives on one device, in stacked tensors with a leading
shard axis ([S, cap, ...]); a shard's GraphState is a view of row i.

Under an initialized ``torch.distributed`` process group (gloo), P
processes share the S shards: rank r owns the contiguous block
``[r*S/P, (r+1)*S/P)``, as the JAX package's mesh orders devices over
processes. Every rank calls every method with the same arguments, as the
JAX package's SPMD workers do. Host state (keys, placement, free-lists,
the level rng, compaction permutations) stays identical on every rank;
device tensors hold only the rank's own shards. The few host values that
span shards (the empty-graph test, compaction's inputs, stats, the
search merge, save) are all-gathered on the CPU, since gloo takes no
CUDA tensors. So a P-rank search returns the same keys and scores as a
one-process search of the same graphs.

Of the JAX package's ``DVT_*`` settings, only the layout is a
constructor keyword: K1 always runs on the int8 layout, there is no
one-hop rerank, and the memory budget is the ``nbr_budget_bytes``
attribute, as in HNSWIndex.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from duckdb_vss_tpu_torch.models.build import insert_batch
from duckdb_vss_tpu_torch.models.bulk import bulk_build
from duckdb_vss_tpu_torch.models.flat import SCALAR_DTYPES, row_sq_norms
from duckdb_vss_tpu_torch.models.graph import (L_MAX, UPPER_DIV, GraphState,
                                               make_neighborhood_tables,
                                               search_graph, upper_table)
from duckdb_vss_tpu_torch.models.hnsw import NBR_BUDGET_BYTES, _isolate
from duckdb_vss_tpu_torch.ops.fused_beam import pack_meta
from duckdb_vss_tpu_torch.ops.topk import flat_topk, smallest_k
from duckdb_vss_tpu_torch.utils import persist as PS
from duckdb_vss_tpu_torch.utils.config import HNSWConfig, MetricKind
from duckdb_vss_tpu_torch.utils.convert import (device_tensor, host_array,
                                                sharded_from_arrays,
                                                sharded_to_arrays)
from duckdb_vss_tpu_torch.utils.device import resolve_device
from duckdb_vss_tpu_torch.utils.padding import pad_2d_np, pad_dim, round_up

SCATTER_ROWS = 4096  # rows per host-to-device step of an add
BULK_MIN_ROWS = 4096  # an add into empty graphs of this many rows bulk-builds
# the sharded file's sections, in the JAX package's order, and the
# sharded_to_arrays name each holds (the file has no norms: load sums them)
SECTIONS = (
    ("keys", "_keys"), ("valid", "_valid"), ("vectors", "_vectors"),
    ("neighbors0", "neighbors0"), ("upper_nbrs", "upper_neighbors"),
    ("upper_slot", "upper_slot"), ("upper_node", "upper_node"),
    ("levels", "levels"), ("entry_node", "entry_node"),
    ("smax_level", "max_level"), ("supper_count", "upper_count"),
    ("next_slot", "_next_slot"), ("free_slots", "_free_slots"),
    ("free_off", "_free_off"), ("pl_assign", "pl_assign"),
    ("pl_load", "pl_load"))


class Mesh:
    """S shards (``shape["shard"]``) on one device. ``shape["q"]`` only
    sets the query padding multiple, max(8, q). Under a process group,
    ``shards`` is the block of shards this rank owns; else all of them."""

    def __init__(self, n_shards: int, n_q: int, device: torch.device,
                 world_size: int = 1, rank: int = 0):
        self.shape = {"q": int(n_q), "shard": int(n_shards)}
        self.device = device
        self.world_size = int(world_size)
        self.rank = int(rank)
        per = self.shape["shard"] // self.world_size
        self.shards = range(self.rank * per, (self.rank + 1) * per)

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, device={self.device}, rank "
                f"{self.rank} of {self.world_size}, shards {self.shards})")


def make_mesh(n_shards: int | None = None, n_q: int = 1,
              device: str | torch.device = "cuda") -> Mesh:
    """S shards on ``device`` (one per process when n_shards is None).
    With an initialized torch.distributed group, the world size must
    divide S."""
    dev = resolve_device(device)
    world, rank = 1, 0
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    n_shards = int(n_shards or world)
    if n_shards % world:
        raise ValueError(f"{world} processes cannot split {n_shards} shards "
                         "evenly")
    return Mesh(n_shards, n_q, dev, world, rank)


def shard_keys(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Hash partition: shard = key mod n_shards (BASELINE north star)."""
    return (np.asarray(keys, np.int64) % n_shards).astype(np.int32)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer — uniform virtual-shard hashing even for
    pathological key patterns (sequential, strided, clustered)."""
    z = x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


class VirtualPlacement:
    """Over-partitioned key placement: keys hash into V = alpha * S
    virtual shards; each virtual shard is assigned to a physical shard
    the first time it is seen, greedily to the least-loaded one.

    A hot key range concentrates into a few virtual shards, and the
    load-aware assignment spreads those across physical shards instead
    of letting `key mod S` pile them onto one. Placement is
    deterministic given the insert order and persists with the index.
    """

    def __init__(self, n_shards: int, alpha: int = 16):
        self.n_shards = int(n_shards)
        self.v = int(alpha) * self.n_shards
        self.assign = np.full((self.v,), -1, np.int32)
        self.load = np.zeros((self.n_shards,), np.int64)

    def place(self, keys: np.ndarray) -> np.ndarray:
        """Physical shard per key; assigns unseen virtual shards."""
        keys = np.asarray(keys, np.int64)
        vs = (_splitmix64(keys) % np.uint64(self.v)).astype(np.int64)
        counts = np.bincount(vs, minlength=self.v)
        new = np.nonzero((self.assign < 0) & (counts > 0))[0]
        # heaviest new virtual shards first -> best balance
        for vshard in new[np.argsort(-counts[new], kind="stable")]:
            tgt = int(np.argmin(self.load))
            self.assign[vshard] = tgt
            self.load[tgt] += int(counts[vshard])
        seen = np.nonzero((self.assign >= 0) & (counts > 0))[0]
        for vshard in seen:
            if vshard not in new:
                self.load[self.assign[vshard]] += int(counts[vshard])
        return self.assign[vs]

    def unplace_counts(self, phys_counts: np.ndarray) -> None:
        """Subtract per-physical-shard removal counts from the load."""
        self.load -= np.asarray(phys_counts, np.int64)


# ---------------------------------------------------------------------------
# helpers shared by both indexes
# ---------------------------------------------------------------------------


def gather_shards(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """The [S, ...] value of a tensor whose [S_local, ...] slices this
    rank holds, on the CPU, on every rank (an all-gather under a process
    group; gloo carries neither CUDA tensors, bool nor bf16, so those
    cross as uint8 and int16 bits)."""
    t = local.detach().cpu()
    if mesh.world_size == 1:
        return t
    dtype = t.dtype
    wire = (t.to(torch.uint8) if dtype == torch.bool
            else t.view(torch.int16) if dtype == torch.bfloat16 else t)
    parts = [torch.empty_like(wire) for _ in range(mesh.world_size)]
    dist.all_gather(parts, wire.contiguous())
    out = torch.cat(parts)
    return (out.to(torch.bool) if dtype == torch.bool
            else out.view(torch.bfloat16) if dtype == torch.bfloat16 else out)


def _pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _pad_axis1(t: torch.Tensor, new_len: int, fill) -> torch.Tensor:
    """Pad dim 1 of a stacked tensor to new_len with ``fill``."""
    extra = t.new_full((t.shape[0], new_len - t.shape[1]) + tuple(t.shape[2:]),
                       fill)
    return torch.cat([t, extra], dim=1)


def _empty_store(n_local: int, cap: int, d_pad: int, dtype: torch.dtype,
                 device: torch.device):
    """(vectors [n, cap, d_pad], vec_sq [n, cap], valid [n, cap]) of
    n_local empty shards."""
    return (torch.zeros((n_local, cap, d_pad), dtype=dtype, device=device),
            torch.zeros((n_local, cap), dtype=torch.float32, device=device),
            torch.zeros((n_local, cap), dtype=torch.bool, device=device))


def _grow_store(index, new_cap: int) -> None:
    """Pad an index's stacked store and host key table to new_cap rows a
    shard."""
    index._vectors = _pad_axis1(index._vectors, new_cap, 0)
    index._vec_sq = _pad_axis1(index._vec_sq, new_cap, 0)
    index._valid = _pad_axis1(index._valid, new_cap, False)
    index._keys = np.concatenate([index._keys, np.full(
        (index.n_shards, new_cap - index.cap), -1, np.int64)], axis=1)


def _store_rows(vectors, vec_sq, valid, slots: np.ndarray,
                rows: np.ndarray) -> None:
    """Write f32 ``rows`` [n, dims] into one shard's store slices at
    ``slots``, SCATTER_ROWS at a time: the rows rounded to the store's
    dtype, their norms summed by numpy from the rows as stored."""
    dev, d_pad = vectors.device, vectors.shape[1]
    for off in range(0, len(slots), SCATTER_ROWS):
        part = rows[off:off + SCATTER_ROWS]
        stored = torch.from_numpy(pad_2d_np(part, len(part), d_pad)).to(
            vectors.dtype)
        sq = torch.from_numpy(row_sq_norms(stored.float().numpy()))
        idx = torch.from_numpy(
            np.asarray(slots[off:off + SCATTER_ROWS], np.int64)).to(dev)
        vectors[idx] = stored.to(dev)
        vec_sq[idx] = sq.to(dev)
        valid[idx] = True


def _merge(mesh: Mesh, scores: torch.Tensor, gids: torch.Tensor, k: int
           ) -> tuple[np.ndarray, np.ndarray]:
    """The distributed top-k merge: this rank's per-shard [S_local, B, k]
    results, gathered to [S, B, k], concatenated shard-major to [B, S*k]
    and cut to the best k. Ties fall to the lowest position, i.e. the
    lowest shard, as lax.top_k on the JAX package's concatenation. The
    cut runs on the mesh's device for any number of processes."""
    if mesh.world_size > 1:
        scores = gather_shards(mesh, scores).to(mesh.device)
        gids = gather_shards(mesh, gids).to(mesh.device)
    s, b, kk = scores.shape
    cat_s = scores.permute(1, 0, 2).reshape(b, s * kk)
    cat_g = gids.permute(1, 0, 2).reshape(b, s * kk)
    out_s, pos = smallest_k(cat_s, k)
    return (out_s.cpu().numpy(),
            torch.gather(cat_g, 1, pos).cpu().numpy())


def _keys_of(keys: np.ndarray, gids: np.ndarray) -> np.ndarray:
    """Map global ids (shard * cap + slot, -1 for none) to keys."""
    out = np.full(gids.shape, -1, np.int64)
    ok = gids >= 0
    out[ok] = keys.reshape(-1)[gids[ok]]
    return out


def _query_chunks(queries: np.ndarray, chunk: int, mult: int, d_pad: int,
                  device: torch.device):
    """Host-side chunks of the batch, each padded to a multiple of
    ``mult`` rows and d_pad columns, on the device: (tensor, rows)."""
    for off in range(0, queries.shape[0], chunk):
        qc = queries[off:off + chunk]
        b_pad = round_up(max(len(qc), 1), mult)
        yield (torch.from_numpy(pad_2d_np(qc, b_pad, d_pad)).to(device),
               len(qc))


# ---------------------------------------------------------------------------
# sharded flat (brute force) index
# ---------------------------------------------------------------------------


class ShardedFlatIndex:
    """Hash-partitioned brute-force index: keys placed by ``key mod S``,
    each shard scanned exactly, one merge per batch."""

    def __init__(self, dims: int, metric: MetricKind, mesh: Mesh,
                 capacity_per_shard: int = 1024):
        self.dims = int(dims)
        self.d_pad = pad_dim(self.dims)
        self.metric = metric
        self.mesh = mesh
        self.n_shards = mesh.shape["shard"]
        self.cap = _pow2(max(1024, int(capacity_per_shard)))
        self._vectors, self._vec_sq, self._valid = _empty_store(
            len(mesh.shards), self.cap, self.d_pad, torch.float32,
            mesh.device)
        self._keys = np.full((self.n_shards, self.cap), -1, np.int64)
        self._counts = np.zeros((self.n_shards,), np.int64)

    def reserve(self, capacity_per_shard: int) -> None:
        """Grow every shard's capacity to the next power of two."""
        new_cap = _pow2(capacity_per_shard)
        if new_cap <= self.cap:
            return
        _grow_store(self, new_cap)
        self.cap = new_cap

    def add(self, vectors: np.ndarray, keys: np.ndarray) -> None:
        vectors = np.asarray(vectors, np.float32)
        keys = np.asarray(keys, np.int64).reshape(-1)
        shards = shard_keys(keys, self.n_shards)
        per_shard = [np.nonzero(shards == i)[0] for i in range(self.n_shards)]
        max_n = max(len(p) + self._counts[i] for i, p in enumerate(per_shard))
        if max_n > self.cap:
            self.reserve(int(max_n))
        for i, idx in enumerate(per_shard):
            off = int(self._counts[i])
            slots = np.arange(off, off + len(idx))
            self._keys[i, slots] = keys[idx]
            self._counts[i] += len(idx)
            if i in self.mesh.shards:
                j = i - self.mesh.shards.start
                _store_rows(self._vectors[j], self._vec_sq[j], self._valid[j],
                            slots, vectors[idx])

    def search(self, queries: np.ndarray, k: int):
        """Exact top-k over every shard. Returns (scores [B, k], keys
        [B, k])."""
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        b = queries.shape[0]
        b_pad = round_up(max(b, 1), max(8, self.mesh.shape["q"]))
        q = torch.from_numpy(pad_2d_np(queries, b_pad, self.d_pad)).to(
            self.mesh.device)
        outs_s, outs_g = [], []
        for j, i in enumerate(self.mesh.shards):
            scores, slots = flat_topk(
                q, self._vectors[j], int(k), self.metric,
                vec_sq=self._vec_sq[j], valid=self._valid[j],
                block_n=min(16384, self.cap))
            outs_s.append(scores)
            outs_g.append(torch.where(slots >= 0, i * self.cap + slots.long(),
                                      -1))
        scores, gids = _merge(self.mesh, torch.stack(outs_s),
                              torch.stack(outs_g), int(k))
        return scores[:b], _keys_of(self._keys, gids[:b])


# ---------------------------------------------------------------------------
# sharded HNSW index
# ---------------------------------------------------------------------------


class ShardedGraph(NamedTuple):
    """Per-shard HNSW graphs stacked on a leading shard axis (this
    process's shards only)."""

    neighbors0: torch.Tensor  # [S, cap, M0]
    upper_neighbors: torch.Tensor  # [S, cap_u, L_MAX*M]
    upper_slot: torch.Tensor  # [S, cap]
    upper_node: torch.Tensor  # [S, cap_u]
    levels: torch.Tensor  # [S, cap]
    entry_node: torch.Tensor  # [S]
    max_level: torch.Tensor  # [S]
    upper_count: torch.Tensor  # [S]


def ef_local_policy(ef: int, k: int, n_shards: int,
                    ef_local: int | None = None) -> int:
    """The beam width each shard searches at. By default it scales down
    with the shard count: min(ef, max(k+6, ceil(ef/S)+6)); an explicit
    ef_local replaces it (at least k). Rounded up to a multiple of 16.
    The default overrides an explicit ef, as the JAX package's does."""
    ef_req = max(int(ef), k)
    if ef_local is None:
        ef_req = min(ef_req, max(k + 6, -(-ef_req // n_shards) + 6))
    else:
        ef_req = max(int(ef_local), k)
    return round_up(ef_req, 16)


class ShardedHNSWIndex:
    """Hash-partitioned HNSW: independent per-shard subgraphs built and
    searched with the single-index kernels (the mxu descent, the int8
    neighborhood layout and kernel K1 on the card), one top-k merge per
    batch, and virtual-shard placement for hot-key skew. Deletes,
    compaction, growth and persistence follow the single index."""

    def __init__(self, dims: int, config: HNSWConfig, mesh: Mesh,
                 capacity_per_shard: int = 4096, seed: int = 0x5EED,
                 build_batch: int = 128, placement_alpha: int = 16,
                 scalar_kind: str = "f32",
                 layout: str = "auto"):  # "auto" (int8 neighborhood tiles,
        # searched by K1, on a CUDA device within nbr_budget_bytes) |
        # "neighborhood" | "flat"
        if scalar_kind not in SCALAR_DTYPES:
            raise ValueError(
                f"scalar_kind must be f32 or bf16, got {scalar_kind!r}")
        if layout not in ("auto", "neighborhood", "flat"):
            raise ValueError("layout must be auto, neighborhood or flat, "
                             f"got {layout!r}")
        self.dims = int(dims)
        self.d_pad = pad_dim(self.dims)
        self.config = config
        self.mesh = mesh
        self.device = mesh.device
        self.n_shards = mesh.shape["shard"]
        self.build_batch = build_batch
        self.scalar_kind = scalar_kind
        self._dtype = SCALAR_DTYPES[scalar_kind]
        self.cap = _pow2(max(1024, int(capacity_per_shard)))
        s = self.n_shards
        self._rng = np.random.default_rng(seed)
        self.placement = VirtualPlacement(s, alpha=placement_alpha)
        self._vectors, self._vec_sq, self._valid = _empty_store(
            len(mesh.shards), self.cap, self.d_pad, self._dtype, self.device)
        self._keys = np.full((s, self.cap), -1, np.int64)
        self._key_to_slot = [dict() for _ in range(s)]
        self._free_slots = [[] for _ in range(s)]
        self._next_slot = np.zeros((s,), np.int64)
        self.graph = self._empty_graph()
        self._upper_cache = None
        self._nbr_cache = None
        self._trav_cache = None
        self.layout = layout
        self.nbr_budget_bytes = NBR_BUDGET_BYTES
        self.build_stats: list[dict] = []  # the last bulk build's, per shard
        self.is_dirty = False

    # -- storage helpers --------------------------------------------------
    def _empty_graph(self) -> ShardedGraph:
        n, cap, cfg = len(self.mesh.shards), self.cap, self.config
        cap_u = max(cap // UPPER_DIV, 64)

        def full(shape, fill):
            return torch.full(shape, fill, dtype=torch.int32,
                              device=self.device)

        return ShardedGraph(
            neighbors0=full((n, cap, cfg.m0), -1),
            upper_neighbors=full((n, cap_u, L_MAX * cfg.m), -1),
            upper_slot=full((n, cap), -1),
            upper_node=full((n, cap_u), -1),
            levels=full((n, cap), -1),
            entry_node=full((n,), -1),
            max_level=full((n,), -1),
            upper_count=full((n,), 0),
        )

    def _state(self, j: int) -> GraphState:
        """The GraphState of local shard j: views of row j."""
        return GraphState(*(t[j] for t in self.graph))

    def _put_state(self, j: int, st: GraphState) -> None:
        """Write a shard's new GraphState into row j of the stack."""
        for dst, src in zip(self.graph, st):
            if dst[j].data_ptr() != src.data_ptr():
                dst[j].copy_(src)

    def _local(self):
        """(local position, global shard) of every shard this rank owns."""
        return enumerate(self.mesh.shards)

    def _invalidate(self):
        self._upper_cache = None
        self._nbr_cache = None
        self._trav_cache = None
        self.is_dirty = True

    def __len__(self) -> int:
        return sum(len(m) for m in self._key_to_slot)

    @property
    def counts(self) -> np.ndarray:
        """Live members per physical shard."""
        return np.array([len(m) for m in self._key_to_slot], np.int64)

    # -- grow -------------------------------------------------------------
    def reserve(self, capacity_per_shard: int) -> None:
        """Grow every shard's capacity to the next power of two (the
        reference's exclusive-lock resize, hnsw_index.cpp:410-431)."""
        new_cap = _pow2(capacity_per_shard)
        if new_cap <= self.cap:
            return
        _grow_store(self, new_cap)
        g = self.graph
        cap_u = max(new_cap // UPPER_DIV, 64)
        self.graph = g._replace(
            neighbors0=_pad_axis1(g.neighbors0, new_cap, -1),
            upper_neighbors=_pad_axis1(g.upper_neighbors, cap_u, -1),
            upper_slot=_pad_axis1(g.upper_slot, new_cap, -1),
            upper_node=_pad_axis1(g.upper_node, cap_u, -1),
            levels=_pad_axis1(g.levels, new_cap, -1))
        self.cap = new_cap
        self._invalidate()

    # -- build ------------------------------------------------------------
    def _sample_levels(self, n: int) -> np.ndarray:
        """-ln(U)/ln(M) on the shared generator, as the JAX package."""
        u = self._rng.random(n)
        inv = 1.0 / math.log(max(self.config.m, 2))
        return np.minimum(np.floor(-np.log(np.maximum(u, 1e-12)) * inv),
                          L_MAX).astype(np.int32)

    def add(self, vectors: np.ndarray, keys: np.ndarray) -> None:
        """Place keys onto shards (virtual-shard, load-aware), store the
        rows, then bulk-build empty graphs (every graph empty and at
        least 4096 rows in all) or insert in ``build_batch`` steps."""
        vectors = np.asarray(vectors, np.float32)
        keys = np.asarray(keys, np.int64).reshape(-1)
        shards = self.placement.place(keys)
        s = self.n_shards
        per_shard = [np.nonzero(shards == i)[0] for i in range(s)]
        need = max((len(p) + int(self._next_slot[i])
                    - len(self._free_slots[i]))
                   for i, p in enumerate(per_shard))
        if need > self.cap:
            self.reserve(need)

        slot_lists = []
        for i in range(s):
            idx = per_shard[i]
            n_i = len(idx)
            sl = np.empty((n_i,), np.int64)
            reuse = min(len(self._free_slots[i]), n_i)
            for j in range(reuse):
                sl[j] = self._free_slots[i].pop()
            fresh = n_i - reuse
            if fresh:
                off = int(self._next_slot[i])
                sl[reuse:] = np.arange(off, off + fresh)
                self._next_slot[i] += fresh
            for k_, s_ in zip(keys[idx].tolist(), sl.tolist()):
                if k_ in self._key_to_slot[i]:
                    raise ValueError(f"duplicate key {k_}")
                self._key_to_slot[i][k_] = int(s_)
            self._keys[i, sl] = keys[idx]
            slot_lists.append(sl.astype(np.int32))
        for j, i in self._local():
            _store_rows(self._vectors[j], self._vec_sq[j], self._valid[j],
                        slot_lists[i], vectors[per_shard[i]])

        cfg = self.config
        graphs_empty = int(gather_shards(self.mesh, self.graph.max_level)
                           .max()) < 0
        if graphs_empty and len(keys) >= BULK_MIN_ROWS:
            # every rank draws every shard's levels, in shard order, so the
            # shared generator advances alike everywhere; each rank then
            # builds its own shards from its own store slices
            lv_lists = [self._sample_levels(len(sl)) for sl in slot_lists]
            self.build_stats = []
            for j, i in self._local():
                stats: dict = {}
                self._put_state(j, bulk_build(
                    self._vectors[j], self._vec_sq[j], slot_lists[i],
                    lv_lists[i], cfg, cfg.metric,
                    host_vectors=vectors[per_shard[i]], stats_out=stats))
                self.build_stats.append(stats)
            self._invalidate()
            return

        bb = self.build_batch
        n_steps = max(((len(sl) + bb - 1) // bb for sl in slot_lists),
                      default=0)
        for step in range(n_steps):
            batch_slots = np.full((s, bb), -1, np.int32)
            batch_levels = np.zeros((s, bb), np.int32)
            for i in range(s):
                chunk = slot_lists[i][step * bb:(step + 1) * bb]
                batch_slots[i, :len(chunk)] = chunk
                batch_levels[i, :len(chunk)] = self._sample_levels(len(chunk))
            for j, i in self._local():
                if (batch_slots[i] < 0).all():
                    continue  # a batch of pad rows changes nothing
                st, _ = insert_batch(
                    self._state(j), self._vectors[j], self._vec_sq[j],
                    torch.from_numpy(batch_slots[i]).to(self.device),
                    torch.from_numpy(batch_levels[i]).to(self.device),
                    cfg.metric, cfg.m, cfg.m0, cfg.ef_construction)
                self._put_state(j, st)
        self._invalidate()

    # -- delete / compact ---------------------------------------------------
    def remove(self, keys) -> int:
        """Tombstone delete across shards (hnsw_index.cpp:466-482 ->
        free-list push + search-time filtering)."""
        keys = np.asarray(keys, np.int64).reshape(-1)
        s = self.n_shards
        rows = [[] for _ in range(s)]
        removed = np.zeros((s,), np.int64)
        for k_ in keys.tolist():
            for i in range(s):
                slot = self._key_to_slot[i].pop(int(k_), None)
                if slot is not None:
                    rows[i].append(slot)
                    self._keys[i, slot] = -1
                    self._free_slots[i].append(slot)
                    removed[i] += 1
                    break
        n = int(removed.sum())
        if n == 0:
            return 0
        for j, i in self._local():
            if rows[i]:
                self._valid[j][torch.tensor(rows[i], dtype=torch.int64,
                                            device=self.device)] = False
        self.placement.unplace_counts(removed)
        self.is_dirty = True  # tombstones only; caches stay valid
        return n

    def isolate(self) -> None:
        """Drop edges into tombstoned nodes on every shard."""
        for j, _ in self._local():
            nb0, un = _isolate(self.graph.neighbors0[j],
                               self.graph.upper_neighbors[j], self._valid[j])
            self.graph.neighbors0[j] = nb0
            self.graph.upper_neighbors[j] = un
        self._invalidate()

    def compact(self) -> None:
        """Per-shard slot-permutation compaction (usearch compact(),
        index.hpp:3002-3096): the permutations are computed on the host
        from valid, levels and upper_slot, identically on every rank,
        then applied to each shard's tensors on its device."""
        s, cap = self.n_shards, self.cap
        valid = gather_shards(self.mesh, self._valid).numpy()
        levels = gather_shards(self.mesh, self.graph.levels).numpy()
        uslot = gather_shards(self.mesh, self.graph.upper_slot).numpy()
        cap_u = self.graph.upper_neighbors.shape[1]

        perm = np.zeros((s, cap), np.int32)
        remap = np.full((s, cap + 1), -1, np.int32)
        old_uslot = np.zeros((s, cap_u), np.int32)
        row_live = np.zeros((s, cap), bool)
        urow_live = np.zeros((s, cap_u), bool)
        upper_slot_new = np.full((s, cap), -1, np.int32)
        upper_node_new = np.full((s, cap_u), -1, np.int32)
        levels_new = np.full((s, cap), -1, np.int32)
        entry_new = np.full((s,), -1, np.int32)
        maxlv_new = np.full((s,), -1, np.int32)
        ucount_new = np.zeros((s,), np.int32)
        keys_new = np.full((s, cap), -1, np.int64)

        for i in range(s):
            live = np.nonzero(valid[i])[0]
            n_live = len(live)
            order = np.lexsort((live, -levels[i][live]))
            old_of_new = live[order]
            perm[i, :n_live] = old_of_new
            remap[i, old_of_new] = np.arange(n_live)
            row_live[i, :n_live] = True
            lv_new = levels[i][old_of_new]
            levels_new[i, :n_live] = lv_new
            has_upper = lv_new >= 1
            n_up = int(has_upper.sum())
            upper_slot_new[i, np.nonzero(has_upper)[0]] = np.arange(n_up)
            old_uslot[i, :n_up] = uslot[i][old_of_new[has_upper]]
            urow_live[i, :n_up] = True
            upper_node_new[i, :n_up] = np.nonzero(has_upper)[0]
            ucount_new[i] = n_up
            if n_live:
                maxlv_new[i] = int(lv_new.max())
                entry_new[i] = 0  # highest level sorts first
            keys_new[i, :n_live] = self._keys[i][old_of_new]
            self._key_to_slot[i] = {
                int(k): j for j, k in enumerate(keys_new[i, :n_live])}
            self._free_slots[i] = []
            self._next_slot[i] = n_live

        g, dev = self.graph, self.device

        def on_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        for j, i in self._local():
            p = on_dev(perm[i]).long()
            rm = on_dev(remap[i])
            live = on_dev(row_live[i])
            ulive = on_dev(urow_live[i])

            def remap_ids(tbl):
                return rm[torch.where(tbl >= 0, tbl, cap).long()]

            nb0 = torch.where(live[:, None], remap_ids(g.neighbors0[j][p]), -1)
            un = torch.where(ulive[:, None], remap_ids(
                g.upper_neighbors[j][on_dev(old_uslot[i]).long()]), -1)
            # dead rows multiply to (signed) zeros, as in the JAX package
            self._vectors[j] = self._vectors[j][p] * live[:, None]
            self._vec_sq[j] = self._vec_sq[j][p] * live
            self._valid[j] = live
            g.neighbors0[j] = nb0
            g.upper_neighbors[j] = un
            g.upper_slot[j] = on_dev(upper_slot_new[i])
            g.upper_node[j] = on_dev(upper_node_new[i])
            g.levels[j] = on_dev(levels_new[i])
            g.entry_node[j] = int(entry_new[i])
            g.max_level[j] = int(maxlv_new[i])
            g.upper_count[j] = int(ucount_new[i])
        self._keys = keys_new
        self._invalidate()

    # -- search -------------------------------------------------------------
    def _nbr_budget_ok(self) -> bool:
        """Every shard of this process shares one device, so the int8
        tables are summed over them against the budget (the JAX
        package's accounting for shards that share one memory)."""
        m0 = self.graph.neighbors0.shape[2]
        per_shard = self.cap * m0 * self.d_pad  # int8
        return per_shard * len(self.mesh.shards) <= self.nbr_budget_bytes

    def _use_nbr(self) -> bool:
        """The int8 neighborhood layout: forced, or by default on a CUDA
        device within the budget (the JAX package's non-CPU gate)."""
        return self.layout == "neighborhood" or (
            self.layout == "auto" and self.device.type == "cuda"
            and self._nbr_budget_ok())

    def _nbr_tables(self, j: int):
        """(nbr_vecs, nbr_scale, nbr_sq, nbr_meta) of local shard j."""
        nb0 = self.graph.neighbors0[j]
        nv, sc, sq = make_neighborhood_tables(self._vectors[j],
                                              self._vec_sq[j], nb0)
        return nv, sc, sq, pack_meta(nb0, sc, sq)

    def _tables(self):
        """Per-shard search tables, built once per mutation and cached:
        (upper tables, neighborhood tables or None, traversal copy or
        None)."""
        n_loc = len(self.mesh.shards)
        if self._upper_cache is None:
            g = self.graph
            self._upper_cache = [
                upper_table(g.upper_node[j], g.upper_count[j],
                            self._vectors[j], self._vec_sq[j])
                for j in range(n_loc)]
        use_nbr = self._use_nbr()
        if use_nbr and self._nbr_cache is None:
            self._nbr_cache = [self._nbr_tables(j) for j in range(n_loc)]
        if not use_nbr and self._trav_cache is None:
            self._trav_cache = (self._vectors if self._dtype == torch.bfloat16
                                else self._vectors.to(torch.bfloat16))
        return (self._upper_cache, self._nbr_cache if use_nbr else None,
                None if use_nbr else self._trav_cache)

    def search(self, queries: np.ndarray, k: int, ef: int | None = None,
               expand: int = 4, chunk: int = 8192,
               ef_local: int | None = None):
        """Top-k over every shard, one merge per batch. Queries are cut
        into chunks of ``chunk`` rows on the host; each shard searches
        each chunk (search_graph with the mxu descent; kernel K1 on the
        int8 layout), and every chunk's results are merged at once.

        Each shard searches at ``ef_local_policy(ef, k, S, ef_local)``:
        by default min(ef, max(k+6, ceil(ef/S)+6)), rounded up to 16,
        which trades recall in high-recall regimes for a per-shard cost
        that falls with S; pass ef_local=ef for the full beam on every
        shard. Returns (scores [B, k], keys [B, k])."""
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        b = queries.shape[0]
        q_mult = max(8, self.mesh.shape["q"])
        chunk = round_up(max(int(chunk), q_mult), q_mult)
        ef_eff = ef_local_policy(ef or self.config.ef_search, int(k),
                                 self.n_shards, ef_local)
        upper, nbr, trav = self._tables()
        outs_s, outs_g = [], []
        for q, n_rows in _query_chunks(queries, chunk, q_mult, self.d_pad,
                                       self.device):
            chunk_s, chunk_g = [], []
            for j, i in self._local():
                uv, uvsq, unode = upper[j]
                kw = dict(descent="mxu", upper_vecs=uv, upper_vec_sq=uvsq,
                          upper_nodes=unode, expand=expand)
                if nbr is not None:
                    nv, nsc, nsq, nmeta = nbr[j]
                    kw.update(nbr_vecs=nv, nbr_scale=nsc, nbr_sq=nsq,
                              nbr_meta=nmeta, pallas_beam=True)
                else:
                    kw.update(traversal_vectors=trav[j])
                scores, slots, _ = search_graph(
                    self._state(j), self._vectors[j], self._vec_sq[j],
                    self._valid[j], q, int(k), ef_eff, self.config.metric,
                    **kw)
                chunk_s.append(scores[:n_rows])
                chunk_g.append(torch.where(
                    slots[:n_rows] >= 0, i * self.cap + slots[:n_rows].long(),
                    -1))
            outs_s.append(torch.stack(chunk_s))
            outs_g.append(torch.stack(chunk_g))
        if not outs_s:
            return (np.zeros((0, k), np.float32), np.zeros((0, k), np.int64))
        scores, gids = _merge(self.mesh, torch.cat(outs_s, 1),
                              torch.cat(outs_g, 1), int(k))
        return scores, _keys_of(self._keys, gids)

    # -- introspection / persistence ----------------------------------------
    def stats(self) -> dict:
        levels = gather_shards(self.mesh, self.graph.levels).numpy()
        valid = gather_shards(self.mesh, self._valid).numpy()
        per = [{"count": int(valid[i].sum()),
                "max_level": int(levels[i].max()),
                "capacity": self.cap} for i in range(self.n_shards)]
        return {"n_shards": self.n_shards, "count": len(self),
                "placement_load": self.placement.load.tolist(),
                "shards": per}

    def save(self, path: str) -> None:
        """Whole-index serialization of the stacked shard arrays through
        the native container, byte for byte the JAX package's file.
        Under a process group every rank gathers the arrays
        (sharded_to_arrays), rank 0 alone writes, and a barrier follows."""
        lib = PS.get_lib()
        if lib is None:
            raise PS.PersistError("native vss_store library unavailable")
        s = self.n_shards
        hdr = PS._FileHeader()
        hdr.metric = PS._METRIC_CODE[self.config.metric]
        hdr.dims = self.dims
        hdr.d_pad = self.d_pad
        hdr.m = self.config.m
        hdr.m0 = self.config.m0
        hdr.ef_construction = self.config.ef_construction
        hdr.ef_search = self.config.ef_search
        hdr.max_level = 0
        hdr.entry_node = 0
        hdr.count = len(self)
        hdr.capacity = self.cap
        hdr.cap_upper = self.graph.upper_neighbors.shape[1]
        hdr.upper_count = 0
        hdr.reserved[0] = s
        hdr.reserved[1] = self.placement.v
        hdr.reserved[2] = PS._SCALAR_CODE[self.scalar_kind]
        arrays = sharded_to_arrays(self)
        arrays["_valid"] = arrays["_valid"].astype(np.uint8)
        free = arrays["_free_slots"]
        arrays["_free_slots"] = np.concatenate(free)
        arrays["_free_off"] = np.concatenate(
            [[0], np.cumsum([len(f) for f in free])]).astype(np.int64)
        if self.mesh.rank == 0:
            w = lib.vss_writer_open(str(path).encode(), ctypes.byref(hdr))
            if not w:
                raise PS.PersistError(f"cannot open {path} for writing")
            try:
                for section, name in SECTIONS:
                    arr = np.ascontiguousarray(arrays[name])
                    rc = lib.vss_writer_section(
                        w, section.encode(), 0,
                        arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes)
                    if rc != 0:
                        raise PS.PersistError(
                            f"write section {section} failed rc={rc}")
            finally:
                lib.vss_writer_close(w)
        self.is_dirty = False
        if self.mesh.world_size > 1:
            dist.barrier()  # no rank runs ahead of the file

    @classmethod
    def load(cls, path: str, mesh: Mesh) -> "ShardedHNSWIndex":
        """Every rank reads the file and keeps its own shards
        (sharded_from_arrays). Norms are summed by numpy from the stored
        rows, as ``add`` sums them, so a reloaded index searches bit for
        bit as the saved one."""
        lib = PS.get_lib()
        if lib is None:
            raise PS.PersistError("native vss_store library unavailable")
        r = lib.vss_reader_open(str(path).encode())
        if not r:
            raise PS.PersistError(f"cannot open {path}")
        try:
            h = lib.vss_reader_header(r).contents
            s = int(h.reserved[0])
            scalar_kind = PS._CODE_SCALAR[int(h.reserved[2])]
            cap, cap_u, m = int(h.capacity), int(h.cap_upper), int(h.m)
            cfg = HNSWConfig(
                metric=PS._CODE_METRIC[int(h.metric)],
                ef_construction=int(h.ef_construction),
                ef_search=int(h.ef_search), m=m, m0=int(h.m0))
            if s != mesh.shape["shard"]:
                raise ValueError(f"{path} holds {s} shards, the mesh "
                                 f"{mesh.shape['shard']}")
            n_free = lib.vss_reader_section(r, b"free_slots", None, 0) // 8
            layout = {
                "_keys": (np.int64, (s, cap)), "_valid": (np.uint8, (s, cap)),
                "_vectors": (PS._SECTION_DTYPE[scalar_kind],
                             (s, cap, int(h.d_pad))),
                "neighbors0": (np.int32, (s, cap, int(h.m0))),
                "upper_neighbors": (np.int32, (s, cap_u, L_MAX * m)),
                "upper_slot": (np.int32, (s, cap)),
                "upper_node": (np.int32, (s, cap_u)),
                "levels": (np.int32, (s, cap)),
                "entry_node": (np.int32, (s,)),
                "max_level": (np.int32, (s,)),
                "upper_count": (np.int32, (s,)),
                "_next_slot": (np.int64, (s,)),
                "_free_slots": (np.int64, (max(int(n_free), 0),)),
                "_free_off": (np.int64, (s + 1,)),
                "pl_assign": (np.int32, (int(h.reserved[1]),)),
                "pl_load": (np.int64, (s,))}
            arrays = {"dims": int(h.dims)}
            for section, name in SECTIONS:
                dtype, shape = layout[name]
                arr = np.empty(shape, dtype)
                if arr.nbytes:
                    got = lib.vss_reader_section(
                        r, section.encode(),
                        arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes)
                    if got != arr.nbytes:
                        raise PS.PersistError(f"section {section}: rc={got}")
                arrays[name] = arr
        finally:
            lib.vss_reader_close(r)
        arrays["_valid"] = arrays["_valid"].astype(bool)
        off = arrays.pop("_free_off")
        arrays["_free_slots"] = [arrays["_free_slots"][off[i]:off[i + 1]]
                                 for i in range(s)]
        return sharded_from_arrays(arrays, cfg, mesh)

    def _set_shard_arrays(self, vectors: np.ndarray, valid: np.ndarray,
                          graph: dict, vec_sq: np.ndarray | None = None):
        """Fill this rank's shards from [S, ...] host arrays: the store
        (a bf16 store as any 2-byte bits), the valid flags and the
        ShardedGraph fields. Without ``vec_sq`` the norms are summed by
        numpy from the rows as stored."""
        sl = slice(self.mesh.shards.start, self.mesh.shards.stop)
        dev = self.device
        vectors = np.ascontiguousarray(vectors[sl])
        self._vectors = device_tensor(vectors, self._dtype, dev)
        if vec_sq is None:
            stored = ((vectors.view(np.uint16).astype(np.uint32) << 16)
                      .view(np.float32) if self._dtype == torch.bfloat16
                      else vectors)
            vec_sq = np.stack([row_sq_norms(r) for r in stored])
        else:
            vec_sq = vec_sq[sl]
        self._vec_sq = device_tensor(vec_sq, torch.float32, dev)
        self._valid = device_tensor(valid[sl], torch.bool, dev)
        self.graph = ShardedGraph(**{
            f: device_tensor(graph[f][sl], torch.int32, dev)
            for f in ShardedGraph._fields})
        self._invalidate()
        self.is_dirty = False
