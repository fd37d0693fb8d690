"""Sharded search (port of duckdb_vss_tpu/parallel/sharded.py): keys are
hash-partitioned into S shards, every shard is searched on its own with
the single-index kernels, and the per-shard top-k sets are merged once
per query batch.

The mesh is a ("q", "shard") grid of device slots, as the JAX package's
make_mesh lays one over jax.devices(). ``make_mesh(..., devices=[...])``
names a device for each slot, row-major as (q, shard): slot (r, j) holds
shard j of replica r, and a name may repeat (several slots of one
card). Without ``devices`` the grid is one slot that holds every shard
on one device. The tensors of the shards that one replica row keeps on
one device are stacked on a leading shard axis ([S_d, cap, ...]); a
shard's GraphState is a view of its row there. Every mutation runs on
replica row 0, each shard on its own device, and is then copied to the
other rows, so the replicas stay equal bit for bit.

A search splits each padded chunk of queries into one contiguous block
per replica row (the JAX package's P("q", None)). Every shard of a row
searches the row's block on its slot's CUDA stream; the host issues
every slot of every row and chunk before it waits on any. Each row's
per-shard results then meet on the row's first device, ordered after
the streams that made them (copies between cards run on the producing
stream), where one shard-major concatenation is cut to the best k: the
all-gather and top-k of the JAX package's shard_map.

Under an initialized ``torch.distributed`` process group, P processes
share the S shards: rank r owns the contiguous block
``[r*S/P, (r+1)*S/P)``, as the JAX package's mesh orders devices over
processes, and lays its own grid over it. Every rank calls every method
with the same arguments, as the JAX package's SPMD workers do. Host
state (keys, placement, free-lists, the level rng, compaction
permutations) stays identical on every rank; device tensors hold only
the rank's own shards. The values that span shards (the empty-graph
test, compaction's inputs, stats, the search merge, save) are
all-gathered. A group whose backend carries CUDA tensors
(``init_process_group("cpu:gloo,cuda:nccl", device_id=...)``, one card
a rank) gathers CUDA tensors on the card, as the JAX package's
``lax.all_gather`` and ``process_allgather`` do, and a host value is
downloaded once after its gather; a group of the CPU alone (gloo)
gathers on the host. So a P-rank search returns the same keys and
scores as a one-process search of the same graphs.

Of the JAX package's ``DVT_*`` settings, only the layout is a
constructor keyword: K1 always runs on the int8 layout, there is no
one-hop rerank, and the memory budget is the ``nbr_budget_bytes``
attribute, as in HNSWIndex. Each shard of each replica row keeps its
search tables in its own graph.SearchTables, the single index's owner.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from duckdb_vss_tpu_torch.models.build import insert_batch
from duckdb_vss_tpu_torch.models.bulk import BULK_THRESHOLD, bulk_build
from duckdb_vss_tpu_torch.models.flat import SCALAR_DTYPES, row_sq_norms
from duckdb_vss_tpu_torch.models.graph import (L_MAX, UPPER_DIV, GraphState,
                                               SearchTables, compact_graph,
                                               compaction_plan, sample_levels,
                                               search_graph)
from duckdb_vss_tpu_torch.models.hnsw import NBR_BUDGET_BYTES, _isolate
from duckdb_vss_tpu_torch.ops.topk import flat_topk, smallest_k
from duckdb_vss_tpu_torch.utils import persist as PS
from duckdb_vss_tpu_torch.utils.config import HNSWConfig, MetricKind
from duckdb_vss_tpu_torch.utils.convert import (device_tensor,
                                                sharded_from_arrays,
                                                sharded_to_arrays)
from duckdb_vss_tpu_torch.utils.device import resolve_device
from duckdb_vss_tpu_torch.utils.padding import pad_2d_np, pad_dim, round_up
from duckdb_vss_tpu_torch.utils.tracing import annotate, span

SCATTER_ROWS = 4096  # rows per host-to-device step of an add
STORE_FIELDS = ("vectors", "vec_sq", "valid")
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


class Slot(NamedTuple):
    """One place of the mesh's grid: its device and the local shards
    (positions in ``Mesh.shards``) it holds and searches."""

    device: torch.device
    shards: tuple[int, ...]


class Mesh:
    """The ("q", "shard") grid of one process. ``shards`` is the block of
    shards this rank owns under a process group, else all of them.
    ``grid`` holds one row of slots per replica: with ``devices`` (n_q x
    S_local devices, row-major), slot (r, j) holds local shard j of
    replica r on ``devices[r * S_local + j]``; without it the grid is one
    slot that holds every local shard on ``device``, and ``shape["q"]``
    only sets the query padding multiple, max(8, q). ``collectives`` is
    None without a process group, "card" when the group's backend
    carries CUDA tensors (they are then gathered on the card), else
    "host"."""

    def __init__(self, n_shards: int, n_q: int,
                 device: torch.device | None = None, world_size: int = 1,
                 rank: int = 0, devices: list | None = None,
                 collectives: str | None = None):
        self.shape = {"q": int(n_q), "shard": int(n_shards)}
        self.world_size = int(world_size)
        self.rank = int(rank)
        self.collectives = collectives
        per = self.shape["shard"] // self.world_size
        self.shards = range(self.rank * per, (self.rank + 1) * per)
        if devices is None:
            self.grid = ((Slot(device, tuple(range(per))),),)
        else:
            if len(devices) != self.shape["q"] * per:
                raise ValueError(
                    f"{len(devices)} devices for a grid of {self.shape['q']}"
                    f" x {per} slots")
            self.grid = tuple(
                tuple(Slot(devices[r * per + j], (j,)) for j in range(per))
                for r in range(self.shape["q"]))
        self.device = self.grid[0][0].device
        self._streams: dict = {}

    def stream(self, row: int, slot: int):
        """The CUDA stream of slot ``slot`` of row ``row``, made at first
        use; None for a CPU slot."""
        dev = self.grid[row][slot].device
        if dev.type != "cuda":
            return None
        if (row, slot) not in self._streams:
            self._streams[(row, slot)] = torch.cuda.Stream(device=dev)
        return self._streams[(row, slot)]

    def __repr__(self) -> str:
        slots = [[str(s.device) for s in row] for row in self.grid]
        return (f"Mesh(shape={self.shape}, slots={slots}, rank "
                f"{self.rank} of {self.world_size}, shards {self.shards}, "
                f"collectives {self.collectives})")


def _slot_device(name) -> torch.device:
    """A slot's device as given (resolve_device raises for a missing
    card); a CUDA name without an index means the current card."""
    dev = resolve_device(name)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_shards: int | None = None, n_q: int = 1,
              device: str | torch.device = "cuda",
              devices: list | None = None) -> Mesh:
    """A ("q", "shard") mesh. Without ``devices``: S shards on ``device``
    (one per process when n_shards is None). ``devices`` lays a grid
    over named devices, as the JAX package's make_mesh reshapes
    jax.devices(): n_q * S_local names read row-major as (q, shard),
    S_local being S over the processes of an initialized
    torch.distributed group (each rank passes the list for its own block
    of shards). A name may repeat: ``["cuda:0"] * 4`` is four slots of
    one card. With a process group, the world size must divide S; under
    a group whose backend carries CUDA tensors (``"cpu:gloo,cuda:nccl"``)
    a rank's slots name one card at most (its own: ``device=f"cuda:{r}"``
    or ``devices=[f"cuda:{r}"] * n``)."""
    world, rank, collectives = 1, 0, None
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        collectives = ("card" if _carries_cuda(str(dist.get_backend()))
                       else "host")
    if devices is None:
        device = resolve_device(device)
        n_shards = int(n_shards or world)
    else:
        devices = [_slot_device(d) for d in devices]
        n_shards = int(n_shards or len(devices) // int(n_q) * world)
    if n_shards < 1 or n_shards % world:
        raise ValueError(f"{world} processes cannot split {n_shards} shards "
                         "evenly")
    mesh = Mesh(n_shards, n_q, device, world, rank, devices=devices,
                collectives=collectives)
    cards = sorted({str(s.device) for row in mesh.grid for s in row
                    if s.device.type == "cuda"})
    if collectives == "card" and len(cards) > 1:
        raise ValueError(
            f"rank {rank}'s slots name {len(cards)} cards ({cards}); under "
            "a process group that carries CUDA tensors each rank lays its "
            "grid over one card")
    return mesh


def _carries_cuda(backend: str) -> bool:
    """Whether a process group's backend string sends CUDA tensors to a
    device backend: "nccl", or a device map such as
    "cpu:gloo,cuda:nccl"."""
    return backend == "nccl" or any(
        part.strip().startswith("cuda:") for part in backend.split(","))


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


def all_gather_on_device(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """The [S, ...] value of a tensor whose [S_local, ...] slices this
    rank holds, on every rank, on ``local``'s device: one all-gather of
    the group, in rank order (the JAX package's lax.all_gather over the
    shard axis). Under a group that carries CUDA tensors, a CUDA tensor
    is gathered on the card, in any dtype; the current stream waits for
    the gather, the host does not."""
    out = local.new_empty((mesh.world_size * local.shape[0],)
                          + tuple(local.shape[1:]))
    dist.all_gather_into_tensor(out, local.detach().contiguous())
    return out


def _gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """all_gather_on_device of ``t`` on its card under a group that
    carries CUDA tensors, else of its host copy (gloo carries no CUDA
    tensor)."""
    on_card = mesh.collectives == "card" and t.is_cuda
    return all_gather_on_device(mesh, t if on_card else t.detach().cpu())


def gather_shards(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """The [S, ...] value of a tensor whose [S_local, ...] slices this
    rank holds, on the CPU, on every rank: without a process group the
    tensor itself, else gathered (_gather) and downloaded once (the JAX
    package's process_allgather)."""
    if mesh.collectives is None:
        return local.detach().cpu()
    return _gather(mesh, local).cpu()


def _pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _pad_axis1(t: torch.Tensor, new_len: int, fill) -> torch.Tensor:
    """Pad dim 1 of a stacked tensor to new_len with ``fill``."""
    extra = t.new_full((t.shape[0], new_len - t.shape[1]) + tuple(t.shape[2:]),
                       fill)
    return torch.cat([t, extra], dim=1)


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
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The distributed top-k merge: this rank's per-shard [S_local, B, k]
    results, gathered to [S, B, k] (on the card under a group that
    carries CUDA tensors, else through the host), concatenated
    shard-major to [B, S*k] and cut to the best k on the device that
    holds them. Ties fall to the lowest position, i.e. the lowest shard,
    as lax.top_k on the JAX package's concatenation."""
    if mesh.collectives:
        with annotate("sharded.gather"):
            dev = scores.device
            scores, gids = (_gather(mesh, x).to(dev) for x in (scores, gids))
    with annotate("sharded.merge"):
        s, b, kk = scores.shape
        cat_s = scores.permute(1, 0, 2).reshape(b, s * kk)
        cat_g = gids.permute(1, 0, 2).reshape(b, s * kk)
        out_s, pos = smallest_k(cat_s, k)
        return out_s, torch.gather(cat_g, 1, pos)


def _keys_of(keys: np.ndarray, gids: np.ndarray) -> np.ndarray:
    """Map global ids (shard * cap + slot, -1 for none) to keys."""
    out = np.full(gids.shape, -1, np.int64)
    ok = gids >= 0
    out[ok] = keys.reshape(-1)[gids[ok]]
    return out


@contextlib.contextmanager
def _on_stream(stream, *inputs: torch.Tensor):
    """Run the body on ``stream`` (None: where it is), after the work
    already queued on the current stream of its device (the inputs, the
    tables), with ``inputs`` kept alive until the stream is done."""
    if stream is None:
        yield
        return
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    for t in inputs:
        t.record_stream(stream)
    with torch.cuda.device(stream.device), torch.cuda.stream(stream):
        yield


def _to_row_device(mesh: Mesh, row: int, res: dict):
    """Row ``row``'s per-shard results ({j: (scores, gids)}) on the row's
    first device, in shard order: [S_local, B_q, k] each, ordered after
    the streams that made them. A result on another device is copied on
    its own stream; PyTorch orders the copy after that stream and the
    row device's current stream after the copy."""
    slots = mesh.grid[row]
    dev = slots[0].device
    cur = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    moved = {}
    for i, slot in enumerate(slots):
        stream = mesh.stream(row, i)
        local = slot.device == dev
        if local and stream is not None:
            cur.wait_stream(stream)
        for j in slot.shards:
            s, g = res[j]
            if not local:
                with _on_stream(stream):
                    s = s.to(dev, non_blocking=True)
                    g = g.to(dev, non_blocking=True)
            elif stream is not None:
                s.record_stream(cur)
                g.record_stream(cur)
            moved[j] = (s, g)
    order = range(len(moved))
    return (torch.stack([moved[j][0] for j in order]),
            torch.stack([moved[j][1] for j in order]))


def _grid_search(index, queries: np.ndarray, chunk: int, k: int, run):
    """Top-k of ``queries`` [B, D] over every shard of the grid. Each
    chunk of ``chunk`` rows, padded, is split into one contiguous block
    per replica row; every shard j of row r searches the row's block on
    its slot's stream (``run(r, j, block)`` -> scores [B_q, k], global
    ids [B_q, k]), every block of every chunk uploaded first (a copy
    from pageable memory waits for its stream) and every search issued
    before the host waits on any. Each row's results are merged on its
    first device (_merge). Returns (scores [B, k], keys [B, k]) on the
    host, in query order."""
    if not len(queries):
        return np.zeros((0, k), np.float32), np.zeros((0, k), np.int64)
    mesh = index.mesh
    rows = mesh.grid
    mult = math.lcm(max(8, mesh.shape["q"]), len(rows))
    chunk = round_up(max(int(chunk), mult), mult)
    blocks = []  # per chunk: (rows kept, per row {device: query block})
    with annotate("sharded.upload"):
        for off in range(0, len(queries), chunk):
            qc = queries[off:off + chunk]
            qp = pad_2d_np(qc, round_up(len(qc), mult), index.d_pad)
            bq = len(qp) // len(rows)
            blocks.append((len(qc), [
                {dev: torch.from_numpy(qp[r * bq:(r + 1) * bq]).to(dev)
                 for dev in dict.fromkeys(s.device for s in row)}
                for r, row in enumerate(rows)]))
    issued = []  # per chunk, per row: {local shard: (scores, gids)}
    with annotate("sharded.issue"):
        for _, per_row in blocks:
            issued.append([{} for _ in rows])
            for r, row in enumerate(rows):
                for i, slot in enumerate(row):
                    q = per_row[r][slot.device]
                    with _on_stream(mesh.stream(r, i), q):
                        for j in slot.shards:
                            issued[-1][r][j] = run(r, j, q)
    merged = []
    for per_chunk in issued:
        merged.append([])
        for r, res in enumerate(per_chunk):
            with annotate("sharded.gather"):
                stacked = _to_row_device(mesh, r, res)
            merged[-1].append(_merge(mesh, *stacked, k))
    with annotate("sharded.download"):
        for r, row in enumerate(rows):  # later work on a card waits for
            for i, slot in enumerate(row):  # its slots
                stream = mesh.stream(r, i)
                if stream is not None:
                    torch.cuda.current_stream(slot.device).wait_stream(
                        stream)
        scores, gids = [], []
        for (n_keep, _), out in zip(blocks, merged):
            s_host = np.concatenate([s.cpu().numpy() for s, _ in out])
            g_host = np.concatenate([g.cpu().numpy() for _, g in out])
            scores.append(s_host[:n_keep])
            gids.append(g_host[:n_keep])
        return np.concatenate(scores), _keys_of(index._keys,
                                                np.concatenate(gids))


class _Group:
    """The local shards that one replica row keeps on one device: in
    ``t``, each field's tensor with those shards stacked on a leading
    axis in shard order ([S_d, ...])."""

    def __init__(self, row: int, device: torch.device,
                 shards: tuple[int, ...]):
        self.row, self.device, self.shards = row, device, shards
        self.t: dict[str, torch.Tensor] = {}


class _ShardStore:
    """The tensors of a sharded index on its mesh's grid, one _Group per
    device of each replica row. Every change is made to row 0, through
    the views ``_view`` gives, and copied to the other rows by
    ``_sync_replicas`` (tombstones are written into every row)."""

    def _make_groups(self, fields: dict) -> None:
        """The groups of the mesh's grid, with ``fields`` (name -> (shape
        after the shard axis, dtype, fill)) allocated on their devices."""
        self.groups = []
        for r, row in enumerate(self.mesh.grid):
            on: dict = {}
            for slot in row:
                on.setdefault(slot.device, []).extend(slot.shards)
            self.groups += [_Group(r, dev, tuple(sorted(sh)))
                            for dev, sh in on.items()]
        self._where = {(g.row, j): (g, p) for g in self.groups
                       for p, j in enumerate(g.shards)}
        for g in self.groups:
            g.t = {name: torch.full((len(g.shards),) + shape, fill,
                                    dtype=dtype, device=g.device)
                   for name, (shape, dtype, fill) in fields.items()}

    def _view(self, name: str, j: int, row: int = 0) -> torch.Tensor:
        """Field ``name`` of local shard j in replica ``row``: a view."""
        g, p = self._where[(row, j)]
        return g.t[name][p]

    def _store(self, j: int, row: int = 0):
        """(vectors, vec_sq, valid) of local shard j: views."""
        return tuple(self._view(n, j, row) for n in STORE_FIELDS)

    def _stack(self, name: str) -> torch.Tensor:
        """Field ``name`` of row 0's shards, [S_local, ...]: the group's
        own tensor where row 0 is one group, else a copy on the mesh's
        device."""
        row0 = [g for g in self.groups if g.row == 0]
        if len(row0) == 1:
            return row0[0].t[name]
        return torch.stack([self._view(name, j).to(self.mesh.device)
                            for j in range(len(self.mesh.shards))])

    def _gather(self, name: str) -> torch.Tensor:
        """Field ``name`` of all S shards, on the CPU (gather_shards)."""
        return gather_shards(self.mesh, self._stack(name))

    @property
    def _vectors(self) -> torch.Tensor:
        """Row 0's store rows, [S_local, cap, d_pad] (see ``_stack``)."""
        return self._stack("vectors")

    def _grow(self, new_cap: int, widths: dict) -> None:
        """Pad the store and the fields in ``widths`` (name -> (new
        length of axis 1, fill)) of row 0, and the host key table, to
        new_cap rows a shard."""
        widths = {"vectors": (new_cap, 0), "vec_sq": (new_cap, 0),
                  "valid": (new_cap, False), **widths}
        for g in self.groups:
            if g.row == 0:
                for name, (n, fill) in widths.items():
                    g.t[name] = _pad_axis1(g.t[name], n, fill)
        self._keys = np.concatenate([self._keys, np.full(
            (self.n_shards, new_cap - self.cap), -1, np.int64)], axis=1)
        self.cap = new_cap

    def _sync_replicas(self, names=None) -> None:
        """Copy the fields ``names`` (default: every field) of row 0 into
        the other replica rows, shard by shard onto each replica's
        device."""
        for g in self.groups:
            if g.row:
                g.t.update({name: torch.stack(
                    [self._view(name, j).to(g.device) for j in g.shards])
                    for name in (names or list(g.t))})


# ---------------------------------------------------------------------------
# sharded flat (brute force) index
# ---------------------------------------------------------------------------


class ShardedFlatIndex(_ShardStore):
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
        self._make_groups({
            "vectors": ((self.cap, self.d_pad), torch.float32, 0),
            "vec_sq": ((self.cap,), torch.float32, 0),
            "valid": ((self.cap,), torch.bool, False)})
        self._keys = np.full((self.n_shards, self.cap), -1, np.int64)
        self._counts = np.zeros((self.n_shards,), np.int64)

    def reserve(self, capacity_per_shard: int) -> None:
        """Grow every shard's capacity to the next power of two."""
        new_cap = _pow2(capacity_per_shard)
        if new_cap <= self.cap:
            return
        self._grow(new_cap, {})
        self._sync_replicas()

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
                _store_rows(*self._store(i - self.mesh.shards.start), slots,
                            vectors[idx])
        self._sync_replicas()

    @span("sharded.search")
    def search(self, queries: np.ndarray, k: int):
        """Exact top-k over every shard. Returns (scores [B, k], keys
        [B, k])."""
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        start = self.mesh.shards.start

        def run(row, j, q):
            vectors, vec_sq, valid = self._store(j, row)
            scores, slots = flat_topk(q, vectors, int(k), self.metric,
                                      vec_sq=vec_sq, valid=valid,
                                      block_n=min(16384, self.cap))
            return scores, torch.where(
                slots >= 0, (start + j) * self.cap + slots.long(), -1)

        return _grid_search(self, queries, len(queries), int(k), run)


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


GRAPH_FIELDS = ShardedGraph._fields


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


class ShardedHNSWIndex(_ShardStore):
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
        # searched by K1, on CUDA devices within nbr_budget_bytes) |
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
        self.n_shards = mesh.shape["shard"]
        self.build_batch = build_batch
        self.scalar_kind = scalar_kind
        self._dtype = SCALAR_DTYPES[scalar_kind]
        self.cap = _pow2(max(1024, int(capacity_per_shard)))
        s = self.n_shards
        self._rng = np.random.default_rng(seed)
        self.placement = VirtualPlacement(s, alpha=placement_alpha)
        self._make_groups(self._fields())
        self._keys = np.full((s, self.cap), -1, np.int64)
        self._key_to_slot = [dict() for _ in range(s)]
        self._free_slots = [[] for _ in range(s)]
        self._next_slot = np.zeros((s,), np.int64)
        self.layout = layout
        self.nbr_budget_bytes = NBR_BUDGET_BYTES
        # one table owner per shard of each replica row; the layout's
        # budget counts every shard and replica a device holds, and
        # "auto" takes the layout on CUDA only (the JAX package's gate)
        on = collections.Counter()
        for g in self.groups:
            on[g.device] += len(g.shards)
        self.tables = {
            (r, j): SearchTables(
                self, lambda ix, j=j, r=r: ix._source(j, r), config.metric,
                share=max(on.values()), auto_on_cpu=False)
            for r in range(len(mesh.grid)) for j in range(len(mesh.shards))}
        self.build_stats: list[dict] = []  # the last bulk build's, per shard
        self.is_dirty = False

    # -- storage helpers --------------------------------------------------
    def _fields(self) -> dict:
        """Every per-shard field of empty shards: (shape, dtype, fill)."""
        cap, cfg, i32 = self.cap, self.config, torch.int32
        cap_u = max(cap // UPPER_DIV, 64)
        return {"vectors": ((cap, self.d_pad), self._dtype, 0),
                "vec_sq": ((cap,), torch.float32, 0),
                "valid": ((cap,), torch.bool, False),
                "neighbors0": ((cap, cfg.m0), i32, -1),
                "upper_neighbors": ((cap_u, L_MAX * cfg.m), i32, -1),
                "upper_slot": ((cap,), i32, -1),
                "upper_node": ((cap_u,), i32, -1),
                "levels": ((cap,), i32, -1),
                "entry_node": ((), i32, -1),
                "max_level": ((), i32, -1),
                "upper_count": ((), i32, 0)}

    @property
    def graph(self) -> ShardedGraph:
        """Row 0's graphs, [S_local, ...] (see ``_stack``)."""
        return ShardedGraph(*(self._stack(f) for f in GRAPH_FIELDS))

    def _state(self, j: int, row: int = 0) -> GraphState:
        """The GraphState of local shard j: views."""
        return GraphState(*(self._view(f, j, row) for f in GRAPH_FIELDS))

    def _source(self, j: int, row: int = 0):
        """(GraphState, vectors, vec_sq) of local shard j in replica
        ``row``: what its search tables derive from."""
        return (self._state(j, row), self._view("vectors", j, row),
                self._view("vec_sq", j, row))

    def _put_state(self, j: int, st: GraphState) -> None:
        """Write a shard's new GraphState into its views in row 0."""
        for f, src in zip(GRAPH_FIELDS, st):
            dst = self._view(f, j)
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)

    def _cap_u(self) -> int:
        return self.groups[0].t["upper_neighbors"].shape[1]

    def _local(self):
        """(local position, global shard) of every shard this rank owns."""
        return enumerate(self.mesh.shards)

    def _invalidate(self, names=None):
        """After a mutation of row 0: copy the fields ``names`` (default:
        every field) to the replicas, drop every table."""
        self._sync_replicas(names)
        for t in self.tables.values():
            t.drop()
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
        cap_u = max(new_cap // UPPER_DIV, 64)
        self._grow(new_cap, {
            "neighbors0": (new_cap, -1), "upper_neighbors": (cap_u, -1),
            "upper_slot": (new_cap, -1), "upper_node": (cap_u, -1),
            "levels": (new_cap, -1)})
        self._invalidate()

    # -- build ------------------------------------------------------------
    def add(self, vectors: np.ndarray, keys: np.ndarray) -> None:
        """Place keys onto shards (virtual-shard, load-aware), store the
        rows, then bulk-build empty graphs (every graph empty and at
        least BULK_THRESHOLD rows in all) or insert in ``build_batch``
        steps, each shard on its own device."""
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
            _store_rows(*self._store(j), slot_lists[i], vectors[per_shard[i]])

        cfg = self.config
        graphs_empty = int(self._gather("max_level").max()) < 0
        if graphs_empty and len(keys) >= BULK_THRESHOLD:
            # every rank draws every shard's levels, in shard order, so the
            # shared generator advances alike everywhere; each rank then
            # builds its own shards from its own store slices
            lv_lists = [sample_levels(self._rng, len(sl), cfg.m)
                        for sl in slot_lists]
            self.build_stats = []
            for j, i in self._local():
                stats: dict = {}
                vecs, vec_sq, _ = self._store(j)
                self._put_state(j, bulk_build(
                    vecs, vec_sq, slot_lists[i], lv_lists[i], cfg,
                    cfg.metric, host_vectors=vectors[per_shard[i]],
                    stats_out=stats))
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
                batch_levels[i, :len(chunk)] = sample_levels(
                    self._rng, len(chunk), cfg.m)
            for j, i in self._local():
                if (batch_slots[i] < 0).all():
                    continue  # a batch of pad rows changes nothing
                vecs, vec_sq, _ = self._store(j)
                st, _ = insert_batch(
                    self._state(j), vecs, vec_sq,
                    torch.from_numpy(batch_slots[i]).to(vecs.device),
                    torch.from_numpy(batch_levels[i]).to(vecs.device),
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
        # tombstones only, written into every replica row: no table
        # depends on valid, so every row keeps its tables
        for r in range(len(self.mesh.grid)):
            for j, i in self._local():
                if rows[i]:
                    valid = self._view("valid", j, r)
                    valid[torch.tensor(rows[i], dtype=torch.int64,
                                       device=valid.device)] = False
        self.placement.unplace_counts(removed)
        self.is_dirty = True
        return n

    def isolate(self) -> None:
        """Drop edges into tombstoned nodes on every shard."""
        for j, _ in self._local():
            nb0, un = self._view("neighbors0", j), self._view(
                "upper_neighbors", j)
            new_nb0, new_un = _isolate(nb0, un, self._view("valid", j))
            nb0.copy_(new_nb0)
            un.copy_(new_un)
        self._invalidate(("neighbors0", "upper_neighbors"))

    def compact(self) -> None:
        """Per-shard slot-permutation compaction (usearch compact(),
        index.hpp:3002-3096): each shard's plan (graph.compaction_plan)
        is computed on the host from valid, levels and upper_slot,
        identically on every rank, then applied to the shard's tensors
        on its device. Dead rows are multiplied by zero, as in the JAX
        package (signed zeros)."""
        cap, cap_u = self.cap, self._cap_u()
        valid = self._gather("valid").numpy()
        levels = self._gather("levels").numpy()
        uslot = self._gather("upper_slot").numpy()
        plans = [compaction_plan(valid[i], levels[i], uslot[i], cap_u)
                 for i in range(self.n_shards)]
        keys_new = np.full((self.n_shards, cap), -1, np.int64)
        for i, plan in enumerate(plans):
            n_live = len(plan.order)
            keys_new[i, :n_live] = self._keys[i][plan.order]
            self._key_to_slot[i] = {
                int(k): j for j, k in enumerate(keys_new[i, :n_live])}
            self._free_slots[i] = []
            self._next_slot[i] = n_live

        for j, i in self._local():
            plan = plans[i]
            self._put_state(j, compact_graph(self._state(j), plan))
            vectors, vec_sq, valid = self._store(j)
            n_live = len(plan.order)
            rows = torch.zeros((cap,), dtype=torch.int64, device=valid.device)
            rows[:n_live] = torch.from_numpy(plan.order).to(valid.device)
            live = torch.arange(cap, device=valid.device) < n_live
            # dead rows: row 0 multiplied to (signed) zeros, as in the JAX
            # package
            vectors.copy_(vectors[rows] * live[:, None])
            vec_sq.copy_(vec_sq[rows] * live)
            valid.copy_(live)
        self._keys = keys_new
        self._invalidate()

    # -- search -------------------------------------------------------------
    def search_tables(self) -> dict:
        """(row, local shard) -> the graph.Tables that shard searches
        with, built on its device: the upper table for the mxu descent,
        and the int8 layout with K1 where its gate passes, else the
        bf16 traversal copy."""
        return {key: t.for_search(self.layout, self.nbr_budget_bytes)
                for key, t in self.tables.items()}

    @span("sharded.search")
    def search(self, queries: np.ndarray, k: int, ef: int | None = None,
               expand: int = 4, chunk: int = 8192,
               ef_local: int | None = None):
        """Top-k over every shard. Queries are cut into chunks of
        ``chunk`` rows on the host, each split over the replica rows;
        each shard searches its row's block on its slot's stream
        (search_graph with the mxu descent; kernel K1 on the int8
        layout), and each row's results are merged on the row's first
        device (_grid_search).

        Each shard searches at ``ef_local_policy(ef, k, S, ef_local)``:
        by default min(ef, max(k+6, ceil(ef/S)+6)), rounded up to 16,
        which trades recall in high-recall regimes for a per-shard cost
        that falls with S; pass ef_local=ef for the full beam on every
        shard. Returns (scores [B, k], keys [B, k])."""
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        ef_eff = ef_local_policy(ef or self.config.ef_search, int(k),
                                 self.n_shards, ef_local)
        # every table is built before the first search is issued
        tables = self.search_tables()
        start, cap, metric = self.mesh.shards.start, self.cap, \
            self.config.metric

        def run(row, j, q):
            scores, slots, _ = search_graph(
                self._state(j, row), *self._store(j, row), q, int(k), ef_eff,
                metric, tables[(row, j)], expand=expand)
            return scores, torch.where(slots >= 0,
                                       (start + j) * cap + slots.long(), -1)

        return _grid_search(self, queries, chunk, int(k), run)

    # -- introspection / persistence ----------------------------------------
    def stats(self) -> dict:
        levels = self._gather("levels").numpy()
        valid = self._gather("valid").numpy()
        per = [{"count": int(valid[i].sum()),
                "max_level": int(levels[i].max()),
                "capacity": self.cap} for i in range(self.n_shards)]
        return {"n_shards": self.n_shards, "count": len(self),
                "placement_load": self.placement.load.tolist(),
                "shards": per}

    def save(self, path: str) -> None:
        """Whole-index serialization of the stacked shard arrays through
        the native container, byte for byte the JAX package's file,
        whatever the grid. Under a process group every rank gathers the
        arrays (sharded_to_arrays), rank 0 alone writes, and a barrier
        follows."""
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
        hdr.cap_upper = self._cap_u()
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
        if self.mesh.collectives == "card" and self.mesh.device.type == "cuda":
            # on this rank's card, named: NCCL would otherwise guess one
            dist.barrier(device_ids=[_slot_device(self.mesh.device).index])
        elif self.mesh.collectives:
            dist.barrier()  # no rank runs ahead of the file

    @classmethod
    def load(cls, path: str, mesh: Mesh) -> "ShardedHNSWIndex":
        """Every rank reads the file and keeps its own shards, laid over
        its grid (sharded_from_arrays). Norms are summed by numpy from the
        stored rows, as ``add`` sums them, so a reloaded index searches
        bit for bit as the saved one."""
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
        """Fill this rank's shards in row 0 from [S, ...] host arrays,
        then copy them to the replicas: the store (a bf16 store as any
        2-byte bits), the valid flags and the ShardedGraph fields.
        Without ``vec_sq`` the norms are summed by numpy from the rows as
        stored."""
        sl = slice(self.mesh.shards.start, self.mesh.shards.stop)
        vectors = vectors[sl]
        if vec_sq is None:
            stored = ((vectors.view(np.uint16).astype(np.uint32) << 16)
                      .view(np.float32) if self._dtype == torch.bfloat16
                      else vectors)
            vec_sq = np.stack([row_sq_norms(r) for r in stored])
        else:
            vec_sq = vec_sq[sl]
        host = {"vectors": (vectors, self._dtype),
                "vec_sq": (vec_sq, torch.float32),
                "valid": (valid[sl], torch.bool),
                **{f: (graph[f][sl], torch.int32) for f in GRAPH_FIELDS}}
        for g in self.groups:
            if g.row == 0:
                pick = list(g.shards)
                g.t = {name: device_tensor(np.ascontiguousarray(arr[pick]),
                                           dtype, g.device)
                       for name, (arr, dtype) in host.items()}
        self._invalidate()
        self.is_dirty = False
