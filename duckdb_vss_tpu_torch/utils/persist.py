"""Index persistence through the native vss_store container (port of
duckdb_vss_tpu/utils/persist.py).

Python moves the arrays (device -> host -> file and back) and rebuilds
the index object; the C++ library ``native/vss_store.cpp`` owns the
on-disk format: a sectioned container of 256 KiB checksummed blocks and
an mmap read path. The format is the JAX package's, byte for byte: the
same ``_FileHeader``, the same section names in the same order, the
store's scalar kind in ``reserved[0]``, a bf16 store as its 16-bit
patterns. Either package loads the other's files.

The library is the committed ``native/libvss_store.so``. Where that
cannot be loaded (another host's C library), it is compiled from
``native/vss_store.cpp`` into ``build/native/`` (a directory git
ignores) at first use. Only when neither works does persistence fall
back to a numpy ``.npz`` container, as the JAX package does without
its library.

A lazy load (the default) reads the header and the host-side key map
now and parks a loader in the index; the first data-touching call
reads the device sections again and fills them on the index's device.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from duckdb_vss_tpu_torch.models.flat import row_sq_norms
from duckdb_vss_tpu_torch.models.graph import L_MAX, GraphState
from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex
from duckdb_vss_tpu_torch.utils.config import HNSWConfig, MetricKind
from duckdb_vss_tpu_torch.utils.convert import device_tensor, host_array

_METRIC_CODE = {MetricKind.L2SQ: 0, MetricKind.COSINE: 1, MetricKind.IP: 2}
_CODE_METRIC = {v: k for k, v in _METRIC_CODE.items()}
# the store's precision (FlatIndex scalar_kind) in header reserved[0]
_SCALAR_CODE = {"f32": 0, "bf16": 1}
_CODE_SCALAR = {v: k for k, v in _SCALAR_CODE.items()}
# a section's element type as numpy reads it (bf16 as its bits)
_SECTION_DTYPE = {"f32": np.float32, "bf16": np.uint16}

REPO = Path(__file__).resolve().parents[2]
LIB_SOURCE = REPO / "native" / "vss_store.cpp"
LIB_COMMITTED = REPO / "native" / "libvss_store.so"
LIB_BUILT = REPO / "build" / "native" / "libvss_store.so"


class _FileHeader(ctypes.Structure):
    _fields_ = [
        ("magic", ctypes.c_uint64),
        ("version", ctypes.c_uint32),
        ("n_sections", ctypes.c_uint32),
        ("metric", ctypes.c_uint32),
        ("dims", ctypes.c_uint32),
        ("d_pad", ctypes.c_uint32),
        ("m", ctypes.c_uint32),
        ("m0", ctypes.c_uint32),
        ("ef_construction", ctypes.c_uint32),
        ("ef_search", ctypes.c_uint32),
        ("max_level", ctypes.c_int32),
        ("entry_node", ctypes.c_int64),
        ("count", ctypes.c_uint64),
        ("capacity", ctypes.c_uint64),
        ("cap_upper", ctypes.c_uint64),
        ("upper_count", ctypes.c_uint64),
        ("reserved", ctypes.c_uint64 * 4),
    ]


class PersistError(RuntimeError):
    pass


def build_lib() -> Path:
    """Compile native/vss_store.cpp into build/native/. Raises
    OSError or CalledProcessError when no C++ compiler is found or the
    build fails."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise OSError("no C++ compiler (g++ or c++) on PATH")
    LIB_BUILT.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_BUILT.with_suffix(f".{os.getpid()}.so")
    subprocess.run([cxx, "-O3", "-fPIC", "-std=c++17", "-shared", "-o",
                    str(tmp), str(LIB_SOURCE)], check=True,
                   capture_output=True, timeout=300)
    os.replace(tmp, LIB_BUILT)
    return LIB_BUILT


def _open_lib() -> ctypes.CDLL | None:
    """The committed library; else one built from the source (reused
    while newer than it); None when neither loads."""
    try:
        return ctypes.CDLL(str(LIB_COMMITTED))
    except OSError:
        pass
    if not LIB_SOURCE.exists():
        return None
    try:
        if (not LIB_BUILT.exists()
                or LIB_BUILT.stat().st_mtime < LIB_SOURCE.stat().st_mtime):
            build_lib()
        return ctypes.CDLL(str(LIB_BUILT))
    except (OSError, subprocess.SubprocessError):
        return None


_LIB: list = []  # [] until the first get_lib, then [CDLL or None]


def get_lib() -> ctypes.CDLL | None:
    """The bound vss_store library (index files and the block file), or
    None (the .npz fallback, and the block store's pure-Python file)."""
    if not _LIB:
        lib = _open_lib()
        if lib is not None:
            lib.vss_writer_open.restype = ctypes.c_void_p
            lib.vss_writer_open.argtypes = [ctypes.c_char_p,
                                            ctypes.POINTER(_FileHeader)]
            lib.vss_writer_section.restype = ctypes.c_int
            lib.vss_writer_section.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
                ctypes.c_void_p, ctypes.c_uint64]
            lib.vss_writer_close.restype = ctypes.c_int
            lib.vss_writer_close.argtypes = [ctypes.c_void_p]
            lib.vss_reader_open.restype = ctypes.c_void_p
            lib.vss_reader_open.argtypes = [ctypes.c_char_p]
            lib.vss_reader_open_mem.restype = ctypes.c_void_p
            lib.vss_reader_open_mem.argtypes = [ctypes.c_char_p,
                                                ctypes.c_uint64]
            lib.vss_reader_header.restype = ctypes.POINTER(_FileHeader)
            lib.vss_reader_header.argtypes = [ctypes.c_void_p]
            lib.vss_reader_section.restype = ctypes.c_int64
            lib.vss_reader_section.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                ctypes.c_uint64]
            lib.vss_reader_close.restype = None
            lib.vss_reader_close.argtypes = [ctypes.c_void_p]
            # the block file of utils/blockstore.py, in the same library
            lib.vss_bf_open.restype = ctypes.c_void_p
            lib.vss_bf_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
            lib.vss_bf_total_blocks.restype = ctypes.c_int64
            lib.vss_bf_total_blocks.argtypes = [ctypes.c_void_p]
            lib.vss_bf_write.restype = ctypes.c_int
            lib.vss_bf_write.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                         ctypes.c_void_p, ctypes.c_uint32]
            lib.vss_bf_read.restype = ctypes.c_int64
            lib.vss_bf_read.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                        ctypes.c_void_p, ctypes.c_uint32]
            lib.vss_bf_flush.restype = ctypes.c_int
            lib.vss_bf_flush.argtypes = [ctypes.c_void_p]
            lib.vss_bf_close.restype = ctypes.c_int
            lib.vss_bf_close.argtypes = [ctypes.c_void_p]
        _LIB.append(lib)
    return _LIB[0]


def save_index(index: HNSWIndex, path: str) -> None:
    """Serialize an HNSWIndex: the native container, or the .npz
    fallback without the library."""
    index._ensure_loaded()
    st, g, cfg = index.store, index.graph, index.config
    arrays = {
        "keys": np.ascontiguousarray(st._keys),
        "valid": st._valid.cpu().numpy().astype(np.uint8),
        "vectors": host_array(st._vectors),
        "neighbors0": g.neighbors0.cpu().numpy(),
        # the packed-2D upper table; its bytes are the logical
        # [cap_u, L_MAX, m] layout, row-major
        "upper_nbrs": g.upper_neighbors.cpu().numpy(),
        "upper_slot": g.upper_slot.cpu().numpy(),
        "upper_node": g.upper_node.cpu().numpy(),
        "levels": g.levels.cpu().numpy(),
    }
    arrays = {name: np.ascontiguousarray(a) for name, a in arrays.items()}
    meta = dict(
        metric=_METRIC_CODE[cfg.metric],
        dims=st.dims,
        d_pad=st.d_pad,
        m=cfg.m,
        m0=cfg.m0,
        ef_construction=cfg.ef_construction,
        ef_search=cfg.ef_search,
        max_level=int(g.max_level),
        entry_node=int(g.entry_node),
        count=st.size,
        capacity=st.capacity,
        cap_upper=g.upper_neighbors.shape[0],
        upper_count=int(g.upper_count),
        scalar_kind=_SCALAR_CODE[st.scalar_kind],
    )
    free_slots = np.asarray(st._free_slots, np.int64)
    lib = get_lib()
    if lib is None:
        # through a file object: np.savez appends ".npz" to a bare path
        with open(path, "wb") as f:
            np.savez(f, __meta__=np.array([list(meta.values())], np.int64),
                     __meta_keys__=np.array(list(meta.keys())),
                     __next_slot__=np.int64(st._next_slot),
                     __free_slots__=free_slots, **arrays)
        return
    hdr = _FileHeader()
    for k, v in meta.items():
        if k == "scalar_kind":
            hdr.reserved[0] = v
        else:
            setattr(hdr, k, v)
    w = lib.vss_writer_open(str(path).encode(), ctypes.byref(hdr))
    if not w:
        raise PersistError(f"cannot open {path} for writing")
    arrays["free_slots"] = free_slots
    arrays["next_slot"] = np.asarray([st._next_slot], np.int64)
    try:
        for name, arr in arrays.items():
            rc = lib.vss_writer_section(
                w, name.encode(), 0, arr.ctypes.data_as(ctypes.c_void_p),
                arr.nbytes)
            if rc != 0:
                raise PersistError(f"write section {name} failed rc={rc}")
    finally:
        lib.vss_writer_close(w)
    index.is_dirty = False


def load_index(path: str, lazy: bool | None = None,
               device: str | torch.device = "cuda") -> HNSWIndex:
    """Rebuild an HNSWIndex on ``device`` (the key map and free-list
    from the saved keys). lazy (default on, as the JAX package's
    DVT_DEFERRED_LOAD) reads only the header and the host-side sections
    now; the first data-touching call on the index reads the device
    sections and fills them."""
    lib = get_lib()
    if lib is None or not os.path.exists(path):
        return _load_npz(path, device)
    return _load_native(lambda: (lib.vss_reader_open(str(path).encode()),
                                 None), lazy, str(path), device)


def load_index_from_buffer(get_bytes, lazy: bool | None = None,
                           device: str | torch.device = "cuda"
                           ) -> HNSWIndex:
    """Like load_index, over an in-memory image of the container.

    get_bytes is a bytes object, or a zero-argument callable returning
    one (a lazy load then calls it again at materialize time instead of
    pinning the image)."""
    lib = get_lib()
    if lib is None:
        raise PersistError("native vss_store library unavailable")
    factory = get_bytes if callable(get_bytes) else (lambda: get_bytes)

    def open_reader():
        buf = factory()
        # the reader views the caller's buffer: keep it with the handle
        return lib.vss_reader_open_mem(buf, len(buf)), buf

    return _load_native(open_reader, lazy, "<buffer>", device)


def _store_tensors(vectors: np.ndarray, scalar_kind: str, device):
    """(vectors, vec_sq) on ``device`` from the saved rows; the norms
    are summed as FlatIndex.add sums them, so they equal the saved
    store's bit for bit."""
    if scalar_kind == "bf16":
        stored = (vectors.astype(np.uint32) << 16).view(np.float32)
        vec = device_tensor(vectors, torch.bfloat16, device)
    else:
        stored = vectors
        vec = device_tensor(vectors, torch.float32, device)
    return vec, torch.from_numpy(row_sq_norms(stored)).to(device)


def _load_native(open_reader, lazy: bool | None, what: str,
                 device) -> HNSWIndex:
    if lazy is None:
        lazy = True
    lib = get_lib()
    r, _buf = open_reader()
    if not r:
        raise PersistError(f"cannot open {what} (missing or corrupt header)")

    def read(name, dtype, shape, rr):
        arr = np.empty(shape, dtype)
        got = lib.vss_reader_section(rr, name.encode(),
                                     arr.ctypes.data_as(ctypes.c_void_p),
                                     arr.nbytes)
        if got < 0:
            raise PersistError(f"section {name}: rc={got} (corrupt?)")
        if got != arr.nbytes:
            raise PersistError(
                f"section {name}: size {got} != expected {arr.nbytes}")
        return arr

    try:
        # copy the header now: it lives in memory the reader frees
        hptr = lib.vss_reader_header(r).contents
        hdr = {f: int(getattr(hptr, f)) for f, _ in _FileHeader._fields_
               if f != "reserved"}
        scalar_kind = _CODE_SCALAR[int(hptr.reserved[0])]
        cap, cap_u, d_pad = hdr["capacity"], hdr["cap_upper"], hdr["d_pad"]
        m, m0 = hdr["m"], hdr["m0"]
        cfg = HNSWConfig(metric=_CODE_METRIC[hdr["metric"]],
                         ef_construction=hdr["ef_construction"],
                         ef_search=hdr["ef_search"], m=m, m0=m0)
        # the host-side bookkeeping is read now, lazy or not: it is
        # small and answers catalog questions without a load
        keys = read("keys", np.int64, (cap,), r)
        n_free = lib.vss_reader_section(r, b"free_slots", None, 0) // 8
        free_slots = (read("free_slots", np.int64, (int(n_free),), r)
                      if n_free > 0 else np.zeros((0,), np.int64))
        next_slot = int(read("next_slot", np.int64, (1,), r)[0])
    except Exception:
        lib.vss_reader_close(r)
        raise

    def fill(ix, rr):
        """Read the device sections into ``ix`` (the eager path and the
        lazy loader)."""
        dev = ix.device
        valid = read("valid", np.uint8, (cap,), rr).astype(bool)
        vectors = read("vectors", _SECTION_DTYPE[scalar_kind],
                       (cap, d_pad), rr)
        graph = {
            "neighbors0": read("neighbors0", np.int32, (cap, m0), rr),
            "upper_neighbors": read("upper_nbrs", np.int32,
                                    (cap_u, L_MAX * m), rr),
            "upper_slot": read("upper_slot", np.int32, (cap,), rr),
            "upper_node": read("upper_node", np.int32, (cap_u,), rr),
            "levels": read("levels", np.int32, (cap,), rr),
        }
        st = ix.store
        st._vectors, st._vec_sq = _store_tensors(vectors, scalar_kind, dev)
        st._valid = torch.from_numpy(valid).to(dev)
        ix.graph = GraphState(
            **{f: torch.from_numpy(a).to(dev) for f, a in graph.items()},
            entry_node=torch.tensor(hdr["entry_node"], dtype=torch.int32,
                                    device=dev),
            max_level=torch.tensor(hdr["max_level"], dtype=torch.int32,
                                   device=dev),
            upper_count=torch.tensor(hdr["upper_count"], dtype=torch.int32,
                                     device=dev))

    idx = HNSWIndex(hdr["dims"], cfg, capacity=cap, device=device,
                    scalar_kind=scalar_kind, _defer_alloc=lazy)
    st = idx.store
    st._keys = keys
    st._key_to_slot = {int(k): i for i, k in enumerate(keys.tolist())
                       if k >= 0}
    st._free_slots = [int(x) for x in free_slots.tolist()]
    st._next_slot = next_slot
    st.size = hdr["count"]
    if lazy:
        lib.vss_reader_close(r)

        def materialize(ix):
            r2, _buf2 = open_reader()
            if not r2:
                raise PersistError(f"cannot re-open {what} for the deferred "
                                   "load")
            try:
                fill(ix, r2)
            finally:
                lib.vss_reader_close(r2)

        idx._pending_load = materialize
    else:
        try:
            fill(idx, r)
        finally:
            lib.vss_reader_close(r)
    idx.is_dirty = False
    return idx


def _load_npz(path: str, device) -> HNSWIndex:
    # the fallback writes to the exact path; an older writer may have
    # added ".npz"
    npz_path = path if os.path.exists(path) else path + ".npz"
    if not os.path.exists(npz_path):
        raise PersistError(f"no such checkpoint: {path}")
    z = np.load(npz_path, allow_pickle=False)
    meta = dict(zip([str(k) for k in z["__meta_keys__"]],
                    z["__meta__"][0].tolist()))
    cfg = HNSWConfig(metric=_CODE_METRIC[int(meta["metric"])],
                     ef_construction=int(meta["ef_construction"]),
                     ef_search=int(meta["ef_search"]), m=int(meta["m"]),
                     m0=int(meta["m0"]))
    scalar_kind = _CODE_SCALAR[int(meta.get("scalar_kind", 0))]
    idx = HNSWIndex(int(meta["dims"]), cfg, capacity=int(meta["capacity"]),
                    device=device, scalar_kind=scalar_kind)
    dev = idx.device
    st = idx.store
    vectors = z["vectors"].view(_SECTION_DTYPE[scalar_kind])
    st._vectors, st._vec_sq = _store_tensors(vectors, scalar_kind, dev)
    st._valid = torch.from_numpy(z["valid"].astype(bool)).to(dev)
    st._keys = z["keys"].copy()
    st._key_to_slot = {int(k): i for i, k in enumerate(st._keys.tolist())
                       if k >= 0}
    st._free_slots = [int(x) for x in z["__free_slots__"].tolist()]
    st._next_slot = int(z["__next_slot__"])
    st.size = int(meta["count"])
    un = z["upper_nbrs"]
    idx.graph = GraphState(
        neighbors0=torch.from_numpy(z["neighbors0"]).to(dev),
        upper_neighbors=torch.from_numpy(un.reshape(un.shape[0], -1)).to(dev),
        upper_slot=torch.from_numpy(z["upper_slot"]).to(dev),
        upper_node=torch.from_numpy(z["upper_node"]).to(dev),
        levels=torch.from_numpy(z["levels"]).to(dev),
        entry_node=torch.tensor(int(meta["entry_node"]), dtype=torch.int32,
                                device=dev),
        max_level=torch.tensor(int(meta["max_level"]), dtype=torch.int32,
                               device=dev),
        upper_count=torch.tensor(int(meta["upper_count"]), dtype=torch.int32,
                                 device=dev))
    idx.is_dirty = False
    return idx
