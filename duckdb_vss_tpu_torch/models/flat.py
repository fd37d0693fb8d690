"""Flat (brute-force) vector index (port of duckdb_vss_tpu/models/flat.py).

One dense [capacity, D_pad] block on the device plus per-slot squared
norms, a validity mask (deletes are tombstones) and a host-side slot ->
key table with a LIFO free-list of tombstoned slots. Capacity grows by
the JAX package's buckets (utils/padding.round_up_capacity).

The HNSW index uses it as its vector store, and the chip run uses its
exact f32 scan as the ground truth.

scalar_kind selects the storage precision: "f32" (default) or "bf16"
(half the device memory and half the host-to-device bytes). Rows are
rounded to nearest even, as ml_dtypes (and so the JAX package) rounds
them. Squared norms are f32 always, taken from the rounded rows so the
product-expansion identity stays consistent; distances from a bf16
store carry ~2^-8 relative rounding.

Every squared norm is summed on the host by numpy, from the rows as
stored: for the bulk load (the JAX package sums there too), for scatter
inserts, and when persist.load_index rebuilds them. So a saved and
reloaded store holds the same norms, bit for bit, as the one saved.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from duckdb_vss_tpu_torch.ops.topk import flat_topk
from duckdb_vss_tpu_torch.utils.config import MetricKind
from duckdb_vss_tpu_torch.utils.device import resolve_device
from duckdb_vss_tpu_torch.utils.padding import (INF_SCORE, pad_2d_np, pad_dim,
                                                 round_up, round_up_capacity)
from duckdb_vss_tpu_torch.utils.tracing import count

MIN_CAPACITY = 1024
DEFAULT_BLOCK_N = 16384
SCALAR_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
TRANSFER_DTYPES = ("f32", "bf16", "int8")


def row_sq_norms(stored: np.ndarray) -> np.ndarray:
    """Squared norms of stored rows, given as f32 [N, d_pad]: the one
    place the store's norms are summed (by numpy, on the host)."""
    return (stored * stored).sum(-1)


class PinnedBuffer:
    """Page-locked host memory for copies to and from a card that do not
    wait. Allocated at the first ``take``, then reused, and grown by
    doubling: cudaHostAlloc takes milliseconds, so never once a call.

    ``start()`` opens a call; each ``take(shape, dtype)`` hands out the
    next region, so the regions of one call never overlap. The owner
    writes a region again only in a later call, after that call's own
    wait on the card. A growth mid-call leaves the regions already
    handed out in the old buffer, which PyTorch's pinned allocator keeps
    until the copies recorded on it have ended."""

    ALIGN = 64  # bytes: a region's start, for any dtype

    def __init__(self):
        self._buf = None
        self._off = 0

    def start(self) -> None:
        self._off = 0

    def take(self, shape, dtype: torch.dtype) -> torch.Tensor:
        n = math.prod(shape) * dtype.itemsize
        off = round_up(self._off, self.ALIGN)
        have = 0 if self._buf is None else self._buf.numel()
        if off + n > have:
            self._buf = torch.empty((max(n, 2 * have),), dtype=torch.uint8,
                                    pin_memory=True)
            off = 0
        self._off = off + n
        return self._buf[off:off + n].view(dtype).view(shape)


class FlatIndex:
    """Mutable flat index over row-keyed float vectors."""

    def __init__(self, dims: int, metric: MetricKind = MetricKind.L2SQ,
                 capacity: int = MIN_CAPACITY,
                 device: str | torch.device = "cuda",
                 scalar_kind: str = "f32", defer_alloc: bool = False):
        if scalar_kind not in SCALAR_DTYPES:
            raise ValueError(
                f"scalar_kind must be f32 or bf16, got {scalar_kind!r}")
        self.device = resolve_device(device)
        self.dims = int(dims)
        self.d_pad = pad_dim(self.dims)
        self.metric = metric
        self.scalar_kind = scalar_kind
        self._dtype = SCALAR_DTYPES[scalar_kind]
        self.capacity = round_up_capacity(capacity)
        if defer_alloc:
            # persist.load_index's lazy path fills the device arrays at
            # the first data-touching call; until then none exist
            self._vectors = self._vec_sq = self._valid = None
        else:
            self._vectors = torch.zeros((self.capacity, self.d_pad),
                                        dtype=self._dtype, device=self.device)
            self._vec_sq = torch.zeros((self.capacity,), dtype=torch.float32,
                                       device=self.device)
            self._valid = torch.zeros((self.capacity,), dtype=torch.bool,
                                      device=self.device)
        # slot -> key map lives host-side (64-bit row ids), with a device
        # copy that search maps its slots through (keys_of)
        self._keys = np.full((self.capacity,), -1, np.int64)
        self._key_to_slot: dict[int, int] = {}
        self._free_slots: list[int] = []
        self._next_slot = 0
        self.size = 0

    @property
    def _keys(self) -> np.ndarray:
        """The slot -> key table, int64 [capacity], -1 at a free slot.
        Assigning it drops the device copy; a write into it calls
        ``keys_changed``."""
        return self._host_keys

    @_keys.setter
    def _keys(self, keys: np.ndarray) -> None:
        self._host_keys = keys
        self._dev_keys = None

    def keys_changed(self) -> None:
        """Drop the device copy of the key table after a write into it;
        the next ``keys_of`` copies the table again, whole."""
        self._dev_keys = None

    def keys_of(self, slots: torch.Tensor) -> torch.Tensor:
        """The keys of device ``slots`` (-1 for slot -1), by one gather
        on the device. The device copy of the key table is made at the
        first call after a write: one blocking copy on a card, counted
        as ``index.host_waits``."""
        if self._dev_keys is None:
            # a -1 past the table's end: slot -1 wraps round to it
            self._dev_keys = torch.from_numpy(
                np.append(self._keys, np.int64(-1))).to(self.device)
            if self.device.type == "cuda":
                count("index.host_waits", 1)
        return self._dev_keys[slots]

    # -- capacity ---------------------------------------------------------

    def reserve(self, n: int) -> None:
        """Grow capacity to at least n (next capacity bucket)."""
        if n <= self.capacity:
            return
        new_cap = round_up_capacity(n)
        pad = new_cap - self.capacity
        dev = self.device
        self._vectors = torch.cat([self._vectors, torch.zeros(
            (pad, self.d_pad), dtype=self._dtype, device=dev)])
        self._vec_sq = torch.cat([self._vec_sq, torch.zeros(
            (pad,), dtype=torch.float32, device=dev)])
        self._valid = torch.cat([self._valid, torch.zeros(
            (pad,), dtype=torch.bool, device=dev)])
        self._keys = np.concatenate([self._keys, np.full((pad,), -1, np.int64)])
        self.capacity = new_cap

    # -- mutation ---------------------------------------------------------

    def add(self, vectors: np.ndarray, keys: np.ndarray) -> np.ndarray:
        """Bulk insert; reuses tombstoned slots first (LIFO free-list pop).
        Returns the slot ids assigned."""
        vectors = np.asarray(vectors, np.float32)
        keys = np.asarray(keys, np.int64).reshape(-1)
        n = vectors.shape[0]
        if vectors.shape != (n, self.dims) or keys.shape != (n,):
            raise ValueError(
                f"expected vectors [{n}, {self.dims}] and {n} keys, got "
                f"{vectors.shape} and {keys.shape}")
        slots = np.empty((n,), np.int64)
        n_reuse = min(len(self._free_slots), n)
        for i in range(n_reuse):
            slots[i] = self._free_slots.pop()
        fresh = n - n_reuse
        if fresh:
            self.reserve(self._next_slot + fresh)
            slots[n_reuse:] = np.arange(self._next_slot,
                                        self._next_slot + fresh)
            self._next_slot += fresh
        for k_, s_ in zip(keys.tolist(), slots.tolist()):
            if k_ in self._key_to_slot:
                raise ValueError(f"duplicate key {k_}")
            self._key_to_slot[k_] = s_

        # the rows as stored (bf16 rounds to nearest even) and their norms
        rows = torch.from_numpy(pad_2d_np(vectors, n, self.d_pad)).to(
            self._dtype)
        sq = torch.from_numpy(row_sq_norms(rows.float().numpy()))
        rows, sq = rows.to(self.device), sq.to(self.device)
        if self.size == 0 and n_reuse == 0 and slots[0] == 0:
            # bulk load into an empty index: contiguous rows, no scatter
            self._vectors[:n] = rows
            self._vec_sq[:n] = sq
            self._valid[:n] = True
        else:
            idx = torch.from_numpy(slots).to(self.device)
            self._vectors[idx] = rows
            self._vec_sq[idx] = sq
            self._valid[idx] = True
        self._keys[slots] = keys
        self.keys_changed()
        self.size += n
        return slots

    def remove(self, keys: np.ndarray) -> int:
        """Tombstone deletes: slot to free-list, mask from search."""
        keys = np.asarray(keys, np.int64).reshape(-1)
        slots = []
        for k_ in keys.tolist():
            s_ = self._key_to_slot.pop(k_, None)
            if s_ is not None:
                slots.append(s_)
                self._free_slots.append(s_)
        if slots:
            slots_np = np.asarray(slots, np.int64)
            self._valid[torch.from_numpy(slots_np).to(self.device)] = False
            self._keys[slots_np] = -1
            self.keys_changed()
            self.size -= len(slots)
        return len(slots)

    def compact(self) -> None:
        """Pack the live slots to the front, in slot order, and shrink the
        capacity to the bucket of the live count."""
        live = np.nonzero(self._valid.cpu().numpy())[0]
        n_live = len(live)
        new_cap = round_up_capacity(max(n_live, 1))
        perm = torch.from_numpy(live).to(self.device)
        vecs = torch.zeros((new_cap, self.d_pad), dtype=self._dtype,
                           device=self.device)
        vecs[:n_live] = self._vectors[perm]
        sq = torch.zeros((new_cap,), dtype=torch.float32, device=self.device)
        sq[:n_live] = self._vec_sq[perm]
        self._vectors, self._vec_sq = vecs, sq
        self._valid = torch.zeros((new_cap,), dtype=torch.bool,
                                  device=self.device)
        self._valid[:n_live] = True
        keys_np = self._keys[live]
        self._keys = np.full((new_cap,), -1, np.int64)
        self._keys[:n_live] = keys_np
        self._key_to_slot = {int(k): i for i, k in enumerate(keys_np.tolist())}
        self._free_slots = []
        self._next_slot = n_live
        self.capacity = new_cap

    # -- search -----------------------------------------------------------

    def prepare_queries(self, queries: np.ndarray,
                        transfer_dtype: str = "f32",
                        stage=None) -> torch.Tensor:
        """Pad a query batch to [B, d_pad] and move it to the device as
        f32.

        transfer_dtype="bf16" sends the rows as bf16 (rounded to nearest
        even) and widens them on the device: half the host-to-device
        bytes. "int8" sends per-query symmetric int8 rows and one f32
        scale each (absmax / 127, round half to even, as the JAX package
        computes them on the host) and dequantizes on the device: about a
        quarter of the bytes. For ANN search only: the rounding moves
        distances by ~2^-9 relative for bf16, ~2^-7 for int8, and costs
        recall on clustered data (PERF.md); exact paths keep f32.

        ``stage``, given only for a card, is a ``PinnedBuffer``'s
        ``take``: what is sent is written into its regions and copied to
        the card without waiting, and the caller waits before it writes
        those regions again. Without it each copy waits."""
        if transfer_dtype not in TRANSFER_DTYPES:
            raise ValueError(f"transfer_dtype must be one of "
                             f"{TRANSFER_DTYPES}, got {transfer_dtype!r}")
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        b, d = queries.shape
        if d != self.dims:
            raise ValueError(f"query width {d} != index width {self.dims}")
        padded = np.ascontiguousarray(pad_2d_np(queries, b, self.d_pad))
        if transfer_dtype == "int8":
            absmax = np.abs(padded).max(axis=1)
            scale = np.where(absmax > 0, absmax / 127.0, 1.0
                             ).astype(np.float32)
            q8 = np.clip(np.round(padded / scale[:, None]), -127, 127
                         ).astype(np.int8)
            q8, scale = (self._upload(torch.from_numpy(a), stage)
                         for a in (q8, scale))
            return q8.float() * scale[:, None]
        dtype = torch.bfloat16 if transfer_dtype == "bf16" else torch.float32
        return self._upload(torch.from_numpy(padded), stage, dtype).float()

    def _upload(self, host: torch.Tensor, stage, dtype=None) -> torch.Tensor:
        """``host`` on the device as ``dtype`` (its own by default),
        converted on the host; through a region of ``stage`` without
        waiting, or else by a copy that waits."""
        dtype = host.dtype if dtype is None else dtype
        if stage is None:
            return host.to(dtype).to(self.device)
        staged = stage(host.shape, dtype)
        if dtype == host.dtype:
            # numpy copies on this thread; torch's copy would wake its CPU
            # thread pool, whose spinning workers then delay this thread's
            # launches (on an H100's 8-core host: a batch call's p99 15-19
            # ms, against 5.3 ms with numpy's copy)
            np.copyto(staged.numpy(), host.numpy())
        else:
            staged.copy_(host)
        return staged.to(self.device, non_blocking=True)

    def search_device(self, queries_padded: torch.Tensor, k: int,
                      block_n: int = DEFAULT_BLOCK_N
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Device-resident search (no host transfer): (scores, slots)."""
        eff_block = block_n if self.capacity % block_n == 0 else self.capacity
        scores, slots = flat_topk(
            queries_padded, self._vectors, int(k), self.metric,
            vec_sq=self._vec_sq, valid=self._valid, block_n=eff_block)
        return scores, torch.where(scores >= INF_SCORE, -1, slots)

    def search(self, queries: np.ndarray, k: int,
               block_n: int = DEFAULT_BLOCK_N
               ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k by index metric. Returns (scores [B, k], keys [B, k]);
        missing results (k > live size) have key -1 and score INF_SCORE."""
        scores, slots = self.search_device(self.prepare_queries(queries), k,
                                           block_n)
        scores_np = scores.cpu().numpy()
        slots_np = slots.cpu().numpy()
        keys = np.where(slots_np >= 0, self._keys[np.maximum(slots_np, 0)],
                        np.int64(-1))
        return scores_np, keys

    # -- introspection ----------------------------------------------------

    def get_vector(self, key: int) -> np.ndarray:
        """The stored row of ``key`` (f32, unpadded; raises KeyError)."""
        slot = self._key_to_slot[int(key)]
        return self._vectors[slot, :self.dims].float().cpu().numpy()

    def __len__(self) -> int:
        return self.size
