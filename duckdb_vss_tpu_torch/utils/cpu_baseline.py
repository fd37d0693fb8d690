"""Measured CPU reference baseline (port of
duckdb_vss_tpu/utils/cpu_baseline.py): scalar usearch-style HNSW search
(native/cpu_hnsw.cpp) over the port's graph, one query per thread on all
cores, the reference extension's execution model
(hnsw_index.cpp:301-309, one search per scheduler thread; scalar
autovectorized distance loops, simsimd default OFF).

The library is compiled from ``native/cpu_hnsw.cpp`` into
``build/native/`` (a directory git ignores) at first use, with the
flags of ``native/Makefile``, and rebuilt when the source is newer.
``-march=native`` compiles for the CPU at hand, so the file name carries
a tag of that CPU's model and flags: a checkout shared by two hosts
builds one library for each. The committed ``native/libcpu_hnsw.so`` is
never loaded: it was built on another host and holds AVX-512 code, which
faults at its first call on a CPU without it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

from duckdb_vss_tpu_torch.models.graph import L_MAX

REPO = Path(__file__).resolve().parents[2]
LIB_SOURCE = REPO / "native" / "cpu_hnsw.cpp"


def host_tag() -> str:
    """A short hash of what -march=native compiles for: the CPU's model
    name and feature flags."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name",
                                                      "flags"))]
        text = "".join(sorted(set(lines)))
    except OSError:
        text = platform.machine() + platform.processor()
    return hashlib.sha256(text.encode()).hexdigest()[:12]


LIB_BUILT = REPO / "build" / "native" / f"libcpu_hnsw-{host_tag()}.so"


class _Graph(ctypes.Structure):
    _fields_ = [
        ("vectors", ctypes.c_void_p),
        ("nbr0", ctypes.c_void_p),
        ("upper", ctypes.c_void_p),
        ("upper_slot", ctypes.c_void_p),
        ("valid", ctypes.c_void_p),
        ("cap", ctypes.c_int64),
        ("cap_u", ctypes.c_int64),
        ("d_pad", ctypes.c_int32),
        ("dims", ctypes.c_int32),
        ("m0", ctypes.c_int32),
        ("levels", ctypes.c_int32),
        ("m", ctypes.c_int32),
        ("entry_node", ctypes.c_int32),
        ("max_level", ctypes.c_int32),
    ]


def build_lib() -> Path:
    """Compile native/cpu_hnsw.cpp for this host into build/native/.
    Raises OSError or CalledProcessError when no C++ compiler is found
    or the build fails."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise OSError("no C++ compiler (g++ or c++) on PATH")
    LIB_BUILT.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_BUILT.with_suffix(f".{os.getpid()}.so")
    subprocess.run([cxx, "-O3", "-fPIC", "-std=c++17", "-march=native",
                    "-shared", "-o", str(tmp), str(LIB_SOURCE), "-lpthread"],
                   check=True, capture_output=True, timeout=300)
    os.replace(tmp, LIB_BUILT)
    return LIB_BUILT


_LIB: list = []  # [] until the first get_lib, then [CDLL]


def get_lib() -> ctypes.CDLL:
    """The bound cpu_hnsw library, built first unless one newer than its
    source exists."""
    if not _LIB:
        if (not LIB_BUILT.exists()
                or LIB_BUILT.stat().st_mtime < LIB_SOURCE.stat().st_mtime):
            build_lib()
        lib = ctypes.CDLL(str(LIB_BUILT))
        lib.cpu_hnsw_search_batch.restype = ctypes.c_double
        lib.cpu_hnsw_search_batch.argtypes = [
            ctypes.POINTER(_Graph), ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.cpu_hnsw_build.restype = ctypes.c_double
        lib.cpu_hnsw_build.argtypes = [
            ctypes.POINTER(_Graph), ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int]
        _LIB.append(lib)
    return _LIB[0]


class CPUBaseline:
    """Host-resident copy of an HNSWIndex's graph + scalar search."""

    def _bind(self, entry_node: int, max_level: int) -> None:
        """The C view of the host arrays (which this object keeps)."""
        self._g = _Graph(
            vectors=self.vectors.ctypes.data,
            nbr0=self.nbr0.ctypes.data,
            upper=self.upper.ctypes.data,
            upper_slot=self.upper_slot.ctypes.data,
            valid=self.valid.ctypes.data,
            cap=self.vectors.shape[0],
            cap_u=self.upper.shape[0],
            d_pad=self.d_pad,
            dims=self.dims,
            m0=self.nbr0.shape[1],
            levels=self.upper.shape[1],
            m=self.upper.shape[2],
            entry_node=entry_node,
            max_level=max_level)

    @classmethod
    def build(cls, vectors: np.ndarray, levels: np.ndarray,
              m: int = 16, m0: int = 32, ef_construction: int = 128,
              l_max: int = 8, n_threads: int = 0):
        """Standalone reference-semantics build: insertion-based HNSW
        construction (usearch index_gt::add semantics — descent +
        ef_construction beam + refine_ diversity + back-link re-prune)
        over ``vectors`` with caller-sampled ``levels``. The baseline
        owns its own graph, as the reference extension builds its own
        index. Returns (baseline, build_seconds)."""
        lib = get_lib()
        vectors = np.ascontiguousarray(vectors, np.float32)
        n, d = vectors.shape
        levels = np.ascontiguousarray(levels, np.int32)
        cap_u = max(int((levels >= 1).sum()), 1)
        self = cls.__new__(cls)
        self.vectors = vectors
        self.nbr0 = np.full((n, m0), -1, np.int32)
        self.upper = np.full((cap_u, l_max, m), -1, np.int32)
        self.upper_slot = np.full((n,), -1, np.int32)
        self.valid = np.ones((n,), np.uint8)
        self.dims = d
        self.d_pad = d
        self.keys = np.arange(n, dtype=np.int64)
        self._bind(-1, -1)
        secs = lib.cpu_hnsw_build(
            ctypes.byref(self._g), levels.ctypes.data, n,
            int(ef_construction), int(n_threads))
        if secs < 0:
            raise RuntimeError("cpu_hnsw_build failed (upper overflow)")
        return self, float(secs)

    def __init__(self, index):
        """Copy a port HNSWIndex's store and graph to the host: f32 rows
        (a bf16 store is upcast), the base and upper adjacency, upper
        slots, and the valid flags as uint8."""
        index._ensure_loaded()
        g, st = index.graph, index.store
        self.vectors = np.ascontiguousarray(
            st._vectors.float().cpu().numpy())
        self.nbr0 = np.ascontiguousarray(g.neighbors0.cpu().numpy())
        un2 = g.upper_neighbors.cpu().numpy()
        self.upper = np.ascontiguousarray(
            un2.reshape(un2.shape[0], L_MAX, -1))
        self.upper_slot = np.ascontiguousarray(g.upper_slot.cpu().numpy())
        self.valid = np.ascontiguousarray(
            st._valid.cpu().numpy().astype(np.uint8))
        self.dims = st.dims
        self.d_pad = st.d_pad
        self.keys = st._keys
        self._bind(int(g.entry_node), int(g.max_level))

    def search(self, queries: np.ndarray, k: int, ef: int,
               n_threads: int = 0):
        """Returns (ids [B, k] slot ids, seconds). n_threads=0 = all."""
        lib = get_lib()
        q = np.zeros((len(queries), self.d_pad), np.float32)
        q[:, :self.dims] = np.asarray(queries, np.float32)[:, :self.dims]
        out = np.empty((len(queries), k), np.int32)
        secs = lib.cpu_hnsw_search_batch(
            ctypes.byref(self._g), q.ctypes.data, len(q), k, ef,
            n_threads, out.ctypes.data, None)
        return out, float(secs)
