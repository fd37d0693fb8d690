"""Database block store — fixed-size blocks with reuse (copy of
duckdb_vss_tpu/utils/blockstore.py; the on-disk format is the same, so
either package opens the other's block file).

The reference extension streams its index into DuckDB's block-managed
storage (LinkedBlock over FixedSizeAllocator, the reference's
src/hnsw/hnsw_index.cpp:15-114), and its slow suite proves blocks are
RECLAIMED across DROP INDEX / CREATE INDEX / CHECKPOINT cycles
(test/sql/slow/hnsw_reclaim_storage.test_slow). This module is the
engine's analog: one mutable `data.vssblk` file of 256 KiB CRC-checked
blocks (IO in native/vss_store.cpp, pure-Python fallback), with the
allocator here — blobs take blocks from the free list before growing
the file, so the file size stays bounded under drop/recreate churn
exactly like DuckDB's.

The native file runs on the library utils/persist.py loads (the
committed native/libvss_store.so, or the one built from its source);
where none loads, the pure-Python file writes the same format.

The checkpoint catalog records each object's block list; blocks owned by
a previous catalog version but not the new one return to the free list.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib

from duckdb_vss_tpu_torch.utils import persist

BLOCK_SIZE = 1 << 18  # matches native BLOCK_SIZE / DuckDB-scale blocks
_USABLE = BLOCK_SIZE - 8
_BF_HDR = 8 + 4 + 4 + 8 * 6  # vss_bf_header
_BF_MAGIC = b"VSSBLK01"


def _get_lib():
    """The library persist.get_lib bound (its vss_bf_* functions), or
    None."""
    return persist.get_lib()


class BlockStoreError(RuntimeError):
    pass


class _NativeFile:
    def __init__(self, path: str, lib):
        self._lib = lib
        self._h = lib.vss_bf_open(path.encode(), BLOCK_SIZE)
        if not self._h:
            raise BlockStoreError(f"cannot open block file {path}")

    def total_blocks(self) -> int:
        return int(self._lib.vss_bf_total_blocks(self._h))

    def write(self, block_id: int, data: bytes) -> None:
        rc = self._lib.vss_bf_write(self._h, block_id, data, len(data))
        if rc != 0:
            raise BlockStoreError(f"block {block_id} write failed rc={rc}")

    def read(self, block_id: int) -> bytes:
        buf = ctypes.create_string_buffer(_USABLE)
        got = self._lib.vss_bf_read(self._h, block_id, buf, _USABLE)
        if got < 0:
            raise BlockStoreError(f"block {block_id} read failed rc={got}")
        return buf.raw[: int(got)]

    def flush(self) -> None:
        self._lib.vss_bf_flush(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.vss_bf_close(self._h)
            self._h = None


class _PyFile:
    """Pure-Python fallback with the identical on-disk format."""

    def __init__(self, path: str):
        fresh = not os.path.exists(path)
        self._f = open(path, "r+b" if not fresh else "w+b")
        if fresh:
            self._f.write(struct.pack("<8sII", _BF_MAGIC, 1, BLOCK_SIZE))
            self._f.write(b"\0" * (8 * 6))
            self._f.flush()
        else:
            raw = self._f.read(16)
            if len(raw) < 16 or raw[:8] != _BF_MAGIC:
                raise BlockStoreError(f"bad block file header in {path}")

    def total_blocks(self) -> int:
        self._f.flush()
        end = os.fstat(self._f.fileno()).st_size
        if end <= _BF_HDR:
            return 0
        return (end - _BF_HDR + BLOCK_SIZE - 1) // BLOCK_SIZE

    def write(self, block_id: int, data: bytes) -> None:
        if len(data) > _USABLE:
            raise BlockStoreError("payload exceeds block capacity")
        self._f.seek(_BF_HDR + block_id * BLOCK_SIZE)
        crc = zlib.crc32(data) & 0xFFFFFFFF
        self._f.write(struct.pack("<II", len(data), crc))
        self._f.write(data)
        self._f.write(b"\0" * (_USABLE - len(data)))

    def read(self, block_id: int) -> bytes:
        self._f.seek(_BF_HDR + block_id * BLOCK_SIZE)
        raw = self._f.read(8)
        if len(raw) < 8:
            raise BlockStoreError(f"block {block_id} out of range")
        length, crc = struct.unpack("<II", raw)
        if length > _USABLE:
            raise BlockStoreError(f"block {block_id} corrupt length")
        data = self._f.read(length)
        if (zlib.crc32(data) & 0xFFFFFFFF) != crc:
            raise BlockStoreError(f"block {block_id} CRC mismatch")
        return data

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.close()


class BlockManager:
    """Allocator over a block file: write_blob reuses freed blocks first
    (the reclaim property), grows the file only when the free list runs
    dry. The caller persists .free_blocks in its catalog."""

    def __init__(self, path: str, free_blocks: list[int] | None = None):
        self.path = path
        lib = _get_lib()
        self._file = _NativeFile(path, lib) if lib is not None \
            else _PyFile(path)
        self.free_blocks: list[int] = sorted(free_blocks or [],
                                             reverse=True)

    @property
    def block_size(self) -> int:
        return BLOCK_SIZE

    def total_blocks(self) -> int:
        return self._file.total_blocks()

    def _alloc(self) -> int:
        if self.free_blocks:
            return self.free_blocks.pop()
        return self.total_blocks()

    def write_blob(self, data: bytes) -> list[int]:
        """Store a blob; returns the block ids holding it (in order)."""
        ids = []
        off = 0
        n = len(data)
        while True:
            chunk = data[off: off + _USABLE]
            bid = self._alloc()
            self._file.write(bid, chunk)
            ids.append(bid)
            off += _USABLE
            if off >= n:
                break
        self._file.flush()
        return ids

    def read_blob(self, block_ids: list[int]) -> bytes:
        return b"".join(self._file.read(b) for b in block_ids)

    def free_blob(self, block_ids: list[int]) -> None:
        self.free_blocks.extend(int(b) for b in block_ids)
        self.free_blocks.sort(reverse=True)

    def used_blocks(self, catalog_blocks: list[list[int]]) -> int:
        return sum(len(b) for b in catalog_blocks)

    def close(self) -> None:
        self._file.close()
