"""Build and load the package's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface. nvcc
compiles it for sm_90a into ``build/kernels/lib<name>.so`` (a directory
git ignores) and ctypes binds it. Nothing is built at import: a wrapper
calls ``load`` at its first launch, and a library newer than its source
is reused.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

from duckdb_vss_tpu_torch.utils.config import MetricKind

# shared memory one block may use on Hopper (227 KB of the SM's 256 KB)
MAX_SMEM_BYTES = 232_448
# the Metric enum of every csrc/*.cu
METRIC_CODE = {MetricKind.L2SQ: 0, MetricKind.IP: 1, MetricKind.COSINE: 2}

# the kernels every search runs: the first of them to load builds all
# that are stale, their nvcc processes side by side
SEARCH_KERNELS = ("fused_descent", "fused_beam")

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def nvcc_command(source: Path, out: Path) -> list[str]:
    """The one nvcc line every kernel of the package is built with."""
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(out), str(source)]


def build(names: list[str]) -> dict[str, str]:
    """Compile the named kernels, one nvcc process each, all started
    together. Returns each compiler's output, which holds the
    ``-Xptxas -v`` register and shared-memory summary. Raises if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
        cmd = nvcc_command(source_path(name), tmp)
        procs.append((name, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for name, tmp, cmd, proc in procs:
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def stale(name: str) -> bool:
    """Whether the kernel's library is missing or older than its
    source."""
    lib = library_path(name)
    return (not lib.exists()
            or lib.stat().st_mtime < source_path(name).stat().st_mtime)


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first unless one newer than its
    source exists. A kernel of SEARCH_KERNELS is built with every other
    kernel of that set that is stale too (their nvcc runs beside this
    one's), so the next of them to load finds its library built."""
    if stale(name):
        group = SEARCH_KERNELS if name in SEARCH_KERNELS else (name,)
        build([name] + [n for n in group if n != name and stale(n)])
    return ctypes.CDLL(str(library_path(name)))


def check_tensor(t, name, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device``: what a kernel reads through a raw pointer."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")
