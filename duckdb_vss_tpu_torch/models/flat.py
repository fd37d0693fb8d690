"""Flat (brute-force) vector index (port of duckdb_vss_tpu/models/flat.py).

One dense [capacity, D_pad] f32 block on the device plus per-slot
squared norms, a validity mask (deletes are tombstones) and a host-side
slot -> key table with a LIFO free-list of tombstoned slots. Capacity
grows by the JAX package's buckets (utils/padding.round_up_capacity).

The HNSW index uses it as its vector store, and the chip run uses its
exact f32 scan as the ground truth. ``compact`` and the bf16 store
(``scalar_kind="bf16"``) come with a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from duckdb_vss_tpu_torch.ops.topk import flat_topk
from duckdb_vss_tpu_torch.utils.config import MetricKind
from duckdb_vss_tpu_torch.utils.device import resolve_device
from duckdb_vss_tpu_torch.utils.padding import (INF_SCORE, pad_2d_np, pad_dim,
                                                 round_up_capacity)

MIN_CAPACITY = 1024
DEFAULT_BLOCK_N = 16384


class FlatIndex:
    """Mutable flat index over row-keyed float vectors."""

    def __init__(self, dims: int, metric: MetricKind = MetricKind.L2SQ,
                 capacity: int = MIN_CAPACITY,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.dims = int(dims)
        self.d_pad = pad_dim(self.dims)
        self.metric = metric
        self.capacity = round_up_capacity(capacity)
        self._vectors = torch.zeros((self.capacity, self.d_pad),
                                    dtype=torch.float32, device=self.device)
        self._vec_sq = torch.zeros((self.capacity,), dtype=torch.float32,
                                   device=self.device)
        self._valid = torch.zeros((self.capacity,), dtype=torch.bool,
                                  device=self.device)
        # slot -> key map lives host-side (64-bit row ids; outside the hot
        # compute path: the device returns slots, the host maps them)
        self._keys = np.full((self.capacity,), -1, np.int64)
        self._key_to_slot: dict[int, int] = {}
        self._free_slots: list[int] = []
        self._next_slot = 0
        self.size = 0

    # -- capacity ---------------------------------------------------------

    def reserve(self, n: int) -> None:
        """Grow capacity to at least n (next capacity bucket)."""
        if n <= self.capacity:
            return
        new_cap = round_up_capacity(n)
        pad = new_cap - self.capacity
        dev = self.device
        self._vectors = torch.cat([self._vectors, torch.zeros(
            (pad, self.d_pad), dtype=torch.float32, device=dev)])
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

        vec_np = pad_2d_np(vectors, n, self.d_pad)
        vec = torch.from_numpy(vec_np).to(self.device)
        if self.size == 0 and n_reuse == 0 and slots[0] == 0:
            # bulk load into an empty index: contiguous rows, no scatter;
            # norms summed on the host as the JAX package sums them, so
            # both stores hold the same bits
            self._vectors[:n] = vec
            self._vec_sq[:n] = torch.from_numpy(
                (vec_np * vec_np).sum(-1)).to(self.device)
            self._valid[:n] = True
        else:
            idx = torch.from_numpy(slots).to(self.device)
            self._vectors[idx] = vec
            self._vec_sq[idx] = (vec * vec).sum(-1)
            self._valid[idx] = True
        self._keys[slots] = keys
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
            self.size -= len(slots)
        return len(slots)

    # -- search -----------------------------------------------------------

    def prepare_queries(self, queries: np.ndarray) -> torch.Tensor:
        """Pad a query batch to [B, d_pad] f32 and move it to the device."""
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        b, d = queries.shape
        if d != self.dims:
            raise ValueError(f"query width {d} != index width {self.dims}")
        padded = pad_2d_np(queries, b, self.d_pad)
        return torch.from_numpy(np.ascontiguousarray(padded)).to(self.device)

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

    def __len__(self) -> int:
        return self.size
