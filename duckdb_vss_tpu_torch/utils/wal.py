"""Write-ahead log (copy of duckdb_vss_tpu/utils/wal.py; the port imports
nothing of the JAX package, so it keeps its own copy, and the frame
format is the same byte for byte: a log written by either package
replays in the other).

The reference has two persistence targets: checkpoint blocks and the
DuckDB WAL (BoundIndex::GetStorageInfo(to_wal), the reference's
src/hnsw/hnsw_index.cpp:534-554), with WAL replay
exercised by test/sql/hnsw/hnsw_insert_wal.test. DuckDB's WAL carries
logical row operations; the reference piggybacks whole-index images on
it. Here the engine owns its WAL directly: an append-only log of logical
DML/DDL records (insert/delete/create_table/create_index/...) written by
`Database` mutations, truncated at checkpoint, and replayed by
`open_database` for operations newer than the last checkpoint. Replaying
logical records rebuilds index maintenance through the normal code path,
so indexes come back consistent even when the process died between
checkpoints (the failure mode hnsw_insert_wal.test:3-21 documents as
broken upstream).

Frame format (little-endian): [u32 magic 'DVTW' | u32 payload_len |
u32 crc32(payload)] + payload. The payload is self-describing and
pickle-free — a durability artifact must not be a code-execution surface
on replay, and must stay readable across Python versions:
[u32 json_len | json meta (UTF-8) | raw array sections...]. The meta is
the record with every numpy array replaced by
{"__nd__": section_idx, "dtype": "<f4", "shape": [...]}; sections are
C-order little-endian raw bytes appended in index order. Replay stops at
the first short or corrupt frame — a torn tail from a crash mid-append
loses only the interrupted record, matching standard WAL semantics.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Iterator

import numpy as np

MAGIC = 0x44565457  # 'DVTW'
_HDR = struct.Struct("<III")  # magic, payload_len, crc32(payload)
_U32 = struct.Struct("<I")


def _encode(record: dict) -> bytes:
    sections: list[bytes] = []

    def enc(v):
        if isinstance(v, np.ndarray):
            a = np.ascontiguousarray(v)
            # normalize to little-endian on-disk byte order
            if a.dtype.byteorder == ">":
                a = a.astype(a.dtype.newbyteorder("<"))
            sections.append(a.tobytes())
            return {"__nd__": len(sections) - 1,
                    "dtype": a.dtype.str, "shape": list(a.shape)}
        if isinstance(v, np.generic):
            return enc(np.asarray(v)) if v.ndim else v.item()
        if isinstance(v, dict):
            return {str(k): enc(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [enc(x) for x in v]
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        raise TypeError(f"WAL cannot encode {type(v)!r}")

    meta = json.dumps(enc(record), separators=(",", ":")).encode()
    return b"".join([_U32.pack(len(meta)), meta] + sections)


def _decode(payload: bytes) -> dict:
    (meta_len,) = _U32.unpack_from(payload, 0)
    meta = json.loads(payload[4:4 + meta_len].decode())
    # section offsets are implied by traversal order of __nd__ indices
    off = [4 + meta_len]

    def size_of(node):
        return int(np.prod(node["shape"], dtype=np.int64)) * \
            np.dtype(node["dtype"]).itemsize

    # first pass: collect section sizes in index order
    sizes: dict[int, int] = {}

    def walk(v):
        if isinstance(v, dict):
            if "__nd__" in v and isinstance(v.get("__nd__"), int):
                sizes[v["__nd__"]] = size_of(v)
            else:
                for x in v.values():
                    walk(x)
        elif isinstance(v, list):
            for x in v:
                walk(x)

    walk(meta)
    starts = {}
    pos = off[0]
    for i in sorted(sizes):
        starts[i] = pos
        pos += sizes[i]

    def dec(v):
        if isinstance(v, dict):
            if "__nd__" in v and isinstance(v.get("__nd__"), int):
                i = v["__nd__"]
                raw = payload[starts[i]:starts[i] + sizes[i]]
                return np.frombuffer(raw, dtype=np.dtype(v["dtype"])) \
                    .reshape(v["shape"]).copy()
            return {k: dec(x) for k, x in v.items()}
        if isinstance(v, list):
            return [dec(x) for x in v]
        return v

    return dec(meta)


class WriteAheadLog:
    """Append-only framed record log with CRC-checked replay."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._f = None

    def _file(self):
        if self._f is None:
            self._f = open(self.path, "ab")
        return self._f

    def append(self, record: dict) -> None:
        payload = _encode(record)
        f = self._file()
        f.write(_HDR.pack(MAGIC, len(payload), zlib.crc32(payload)))
        f.write(payload)
        f.flush()
        if self.fsync:
            os.fsync(f.fileno())

    def replay(self) -> Iterator[dict]:
        """Yield intact records in append order; stop at a torn tail."""
        self.close()  # release the append handle before reading
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            while True:
                hdr = f.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    return
                magic, ln, crc = _HDR.unpack(hdr)
                if magic != MAGIC:
                    return
                payload = f.read(ln)
                if len(payload) < ln or zlib.crc32(payload) != crc:
                    return
                yield _decode(payload)

    def truncate(self) -> None:
        """Drop all records (called after a successful checkpoint)."""
        self.close()
        with open(self.path, "wb"):
            pass

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
