#!/usr/bin/env python3
"""Chip smoke run of duckdb_vss_tpu_torch, the PyTorch/CUDA port, on one GPU.

Drives the port's main path through the calls a user makes:
HNSWIndex.add (the bulk build, IVF kNN sweep at this size), then
HNSWIndex.search (mxu descent, seed beam, kernel K1, exact rerank). The
configuration is the SIFT1M shape of ann-benchmarks'
sift-128-euclidean: 1,000,000 x 128 f32 base vectors and 10,000
queries, k=10, l2sq, with the HNSW defaults M=16, M0=32,
ef_construction=128, ef_search=64. The data is SIFT-shaped clustered
data made from --seed with bench.py's generator (4096 centres, sigma
0.25). Ground truth is the port's own exact f32 FlatIndex scan.

Phases (any failure raises and exits non-zero):
  1. device: nvidia-smi name and power limit, torch's device name;
  2. build: compile csrc/fused_beam.cu with nvcc for sm_90a, print the
     -Xptxas -v summary;
  3. main path: build + search at full width, with every kernel launch
     count set to 0 just before and read just after; requires recall@10
     >= 0.95 against the flat scan, K1 launched, its plain version not;
  4. kernel check: K1 against its plain PyTorch version on the same card
     inputs (id-set overlap >= 0.95, scores within rtol/atol 3e-3 where
     the ids agree: bf16 rounding of the products; equal n_dist and
     expansion counts): l2sq on the 1M tables (B=1024, ef 64, expand 4,
     32 steps) and ef 128 / expand 8; ip and cosine on a random table;
     l2sq at the search chunk's shape (B=8192), where K1's time is then
     taken beside its plain version's and its bound.

The line before the last is the kernel table as one JSON object; the
last line is {"ok": true, "device": {...}}. Run from the repository
root: python3 chip_smoke.py
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12  # dense bf16, same source
TOL = 3e-3
MIN_OVERLAP = 0.95
MIN_RECALL = 0.95
N, NQ, D, K = 1_000_000, 10_000, 128, 10  # SIFT1M: base rows, queries
TIMED_B = 8192  # search_device's timed batch and K1's timed shape


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def make_data(rng, n, d, n_centers=4096, sigma=0.25, chunk=200_000):
    """bench.py's SIFT-shaped clustered generator."""
    import numpy as np

    centers = rng.normal(size=(n_centers, d)).astype(np.float32)
    out = np.empty((n, d), np.float32)
    for off in range(0, n, chunk):
        m = min(chunk, n - off)
        asg = rng.integers(0, n_centers, m)
        out[off:off + m] = centers[asg] + sigma * rng.normal(
            size=(m, d)).astype(np.float32)
    return out, centers


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare_beam(name, args, kw):
    """K1 and its plain version on the same card inputs. Returns the
    largest score difference where the ids agree."""
    import numpy as np
    import torch

    from duckdb_vss_tpu_torch.ops.fused_beam import (INF_SCORE,
                                                     beam_search_plain,
                                                     fused_beam_search)

    s_k, i_k, nd_k, ne_k = fused_beam_search(*args, **kw)
    s_p, i_p, nd_p, ne_p = beam_search_plain(*args, **kw)
    if s_k.is_cuda:  # a fault during the run surfaces here
        torch.cuda.synchronize()
    s_k, i_k = s_k.cpu().numpy(), i_k.cpu().numpy()
    s_p, i_p = s_p.cpu().numpy(), i_p.cpu().numpy()
    ef = kw["ef"]
    overlap = float(np.mean([len(set(a) & set(b)) / ef
                             for a, b in zip(i_k.tolist(), i_p.tolist())]))
    same = (i_k == i_p) & (s_p < INF_SCORE)
    err = float(np.abs(s_k[same] - s_p[same]).max()) if same.any() else 0.0
    close = np.allclose(s_k[same], s_p[same], rtol=TOL, atol=TOL)
    log(f"# kernel check {name}: B={i_k.shape[0]} ef={ef} "
        f"expand={kw['expand']} steps={kw['max_steps']} overlap={overlap:.4f}"
        f" max_abs_err={err:.3e} n_dist kernel={int(nd_k)} plain={int(nd_p)}")
    check(overlap >= MIN_OVERLAP, f"{name}: overlap {overlap} < {MIN_OVERLAP}")
    check(close, f"{name}: scores differ beyond rtol/atol {TOL}")
    check(int(nd_k) > 0, f"{name}: kernel kept no candidate")
    check(int(nd_k) == int(nd_p) and int(ne_k) == int(ne_p),
          f"{name}: kernel counts (n_dist {int(nd_k)}, expansions "
          f"{int(ne_k)}) differ from the plain version's ({int(nd_p)}, "
          f"{int(ne_p)})")
    return err


def random_beam_inputs(device, n=16384, d=128, m0=32, b=1024, ef=64,
                       seed=0):
    """Kernel inputs on a random table and graph (for ip and cosine)."""
    import numpy as np
    import torch

    from duckdb_vss_tpu_torch.models.graph import make_neighborhood_tables
    from duckdb_vss_tpu_torch.ops.fused_beam import INF_SCORE, pack_meta

    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    vecs[7] = 0.0  # a zero row: cosine's zero-norm case
    nbr = rng.integers(0, n, (n, m0)).astype(np.int32)
    nbr[rng.random((n, m0)) < 0.1] = -1
    q = rng.normal(size=(b, d)).astype(np.float32)
    q[3] = 0.0
    seeds = rng.integers(0, n, (b, ef)).astype(np.int32)
    seed_s = np.sort(np.abs(rng.normal(size=(b, ef))).astype(np.float32), 1)
    seeds[5], seed_s[5] = -1, INF_SCORE  # an empty beam
    t = {k: torch.from_numpy(v).to(device) for k, v in dict(
        vecs=vecs, nbr=nbr, q=q, seeds=seeds, seed_s=seed_s).items()}
    vec_sq = (t["vecs"] * t["vecs"]).sum(1)
    nv, scale, sq = make_neighborhood_tables(t["vecs"], vec_sq, t["nbr"])
    meta = pack_meta(t["nbr"], scale, sq)
    q_sq = (t["q"] * t["q"]).sum(1)
    return (t["q"], q_sq, t["seed_s"], t["seeds"], meta, nv)


def kernel_checks_random(device):
    """K1 against its plain version on random tables for ip and cosine
    (also run by the gpu-marked test in tests/test_torch_hnsw.py)."""
    from duckdb_vss_tpu_torch.utils.config import MetricKind

    errs = {}
    for metric in (MetricKind.IP, MetricKind.COSINE):
        args = random_beam_inputs(device)
        kw = dict(ef=64, expand=4, m0=32, d=128, max_steps=32, metric=metric)
        errs[metric.value] = compare_beam(f"random-{metric.value}", args, kw)
    return errs


def path_beam_inputs(idx, queries_np, ef):
    """The kernel's inputs exactly as the search path builds them."""
    from duckdb_vss_tpu_torch.models.graph import mxu_descent, seed_beam

    qd = idx.store.prepare_queries(queries_np)
    q_sq = (qd * qd).sum(-1)
    uv, uvsq, unode = idx._upper_vectors()
    nv, _scale, _sq, meta = idx._neighborhood_tables()
    seeds, _ = mxu_descent(uv, uvsq, unode, idx.graph.entry_node, qd,
                           idx.metric, 8)
    seed_s, seed_i = seed_beam(idx.store._vectors, idx.store._vec_sq, seeds,
                               qd, q_sq, idx.metric, ef)
    return (qd, q_sq, seed_s, seed_i, meta, nv)


def search_stages(idx, qd, args, kw, k, search_ms, k1_ms):
    """Device time of each search_graph stage at the chunk's shape."""
    from duckdb_vss_tpu_torch.models.graph import (_finish_search,
                                                   mxu_descent, seed_beam)
    from duckdb_vss_tpu_torch.ops.fused_beam import fused_beam_search
    from duckdb_vss_tpu_torch.utils.timing import device_time

    st = idx.store
    q_sq = (qd * qd).sum(-1)
    uv, uvsq, unode = idx._upper_vectors()
    seeds, _ = mxu_descent(uv, uvsq, unode, idx.graph.entry_node, qd,
                           idx.metric, 8)
    s, i, _, _ = fused_beam_search(*args, **kw)
    ms = {
        "descent": device_time(lambda: mxu_descent(
            uv, uvsq, unode, idx.graph.entry_node, qd, idx.metric, 8),
            iters=5),
        "seed_beam": device_time(lambda: seed_beam(
            st._vectors, st._vec_sq, seeds, qd, q_sq, idx.metric, kw["ef"]),
            iters=5),
        "finish": device_time(lambda: _finish_search(
            st._vectors, st._vec_sq, st._valid, qd, q_sq, idx.metric, k, s,
            i, 0), iters=5),
    }
    parts = ", ".join(f"{n} {t * 1e3:.3f}" for n, t in ms.items())
    log(f"# search stages at B={qd.shape[0]} (device ms): {parts}, K1 "
        f"{k1_ms:.3f}; whole search_device {search_ms:.3f} (descent table "
        f"{uv.shape[0]} rows)")


def beam_bound_ms(args, kw, n_expanded):
    """Least time for the same work on the card: every live selection
    reads one M0*d-byte int8 tile and its 3*M0 meta ints once; queries,
    seeds and outputs move once. Two operations per tile byte (bf16
    products) against the dense bf16 peak."""
    b, ef, m0, d = args[0].shape[0], kw["ef"], kw["m0"], kw["d"]
    nbytes = (n_expanded * (m0 * d + 3 * m0 * 4)
              + b * (d * 4 + 4 + ef * 8)  # queries, q_sq, seed beam
              + b * ef * 8 + b * 8)  # output beam, counts
    ops = n_expanded * m0 * d * 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                      else "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1234)
    opts = ap.parse_args(argv)

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA device", file=sys.stderr)
        return 1
    try:
        import duckdb_vss_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port package is missing beside this script "
              f"({e})", file=sys.stderr)
        return 1
    pkg_dir = os.path.dirname(os.path.abspath(duckdb_vss_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != here:
        print(f"chip_smoke: imported the port from {pkg_dir}, not from this "
              "checkout", file=sys.stderr)
        return 1

    from duckdb_vss_tpu_torch import HNSWConfig, MetricKind
    from duckdb_vss_tpu_torch.models.flat import FlatIndex
    from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex
    from duckdb_vss_tpu_torch.ops import fused_beam as fb
    from duckdb_vss_tpu_torch.utils.timing import device_time

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # ---- 1. device ---------------------------------------------------
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"# nvidia-smi: {smi}")
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")

    # ---- 2. build ----------------------------------------------------
    t0 = time.perf_counter()
    build_log = fb.build_library()
    log(f"# nvcc build of {os.path.relpath(fb.SOURCE, here)}: "
        f"{time.perf_counter() - t0:.2f} s")
    for line in build_log.splitlines():
        if "ptxas" in line or "Used" in line or "spill" in line:
            log(f"#   {line.strip()}")

    # ---- 3. main path at full width -----------------------------------
    n, nq, d, k = N, NQ, D, K
    rng = np.random.default_rng(opts.seed)
    t0 = time.perf_counter()
    vecs, centers = make_data(rng, n, d)
    q = (centers[rng.integers(0, len(centers), nq)]
         + 0.25 * rng.normal(size=(nq, d)).astype(np.float32))
    keys = np.arange(n, dtype=np.int64)
    log(f"# data: {n} x {d} base, {nq} queries, seed {opts.seed}: "
        f"{time.perf_counter() - t0:.1f} s")

    config = HNSWConfig()  # M=16, M0=32, ef_construction=128, ef_search=64
    torch.cuda.reset_peak_memory_stats()
    fb.fused_beam_search.launches = 0
    fb.beam_search_plain.calls = 0
    idx = HNSWIndex(d, config, capacity=n, device=dev)
    t0 = time.perf_counter()
    idx.add(vecs, keys)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # first search builds the int8 neighborhood layout (lazily, as in
    # the JAX package); the timed search runs on the built layout
    t0 = time.perf_counter()
    idx.search(q[:64], k)
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores, got = idx.search(q, k)
    search_s = time.perf_counter() - t0
    k1_launches = fb.fused_beam_search.launches
    plain_calls = fb.beam_search_plain.calls
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    phases = {p: round(s, 3) for p, s in idx.build_stats["phase_s"].items()}
    log(f"# build: {build_s:.2f} s ({n / build_s:.0f} vec/s) phases {phases}")
    log(f"# layout (first search, 64 queries): {layout_s:.2f} s")
    log(f"# search: {nq} queries in {search_s:.3f} s = {nq / search_s:.0f} "
        f"QPS (host arrays in and out, ef_search {config.ef_search})")
    log(f"# K1 launches on the main path: {k1_launches}; plain version "
        f"calls: {plain_calls}; peak device memory {peak_gb:.2f} GiB")

    flat = FlatIndex(d, MetricKind.L2SQ, capacity=n, device=dev)
    flat.add(vecs, keys)
    t0 = time.perf_counter()
    _, want = flat.search(q, k)
    flat_s = time.perf_counter() - t0
    recall = float(np.mean([len(set(a) & set(b)) / k
                            for a, b in zip(got.tolist(), want.tolist())]))
    log(f"# recall@{k} vs the exact f32 flat scan: {recall:.4f} "
        f"(flat scan {flat_s:.2f} s)")
    check(got.shape == (nq, k) and (got >= 0).all(), "missing results")
    check(np.isfinite(scores).all() and (scores >= 0).all(),
          "non-finite or negative l2sq scores")
    exact = ((q[:50, None, :] - vecs[got[:50]]) ** 2).sum(-1)
    check(np.allclose(scores[:50], exact, rtol=1e-4, atol=1e-4),
          "emitted distances are not the exact l2sq values")
    check(recall >= MIN_RECALL, f"recall@{k} {recall} < {MIN_RECALL}")
    check(k1_launches > 0, "the main path never launched kernel K1")
    check(plain_calls == 0, "the main path ran K1's plain version")
    qd = idx.store.prepare_queries(q[:TIMED_B])
    dev_s = device_time(lambda: idx.search_device(qd, k), iters=5)
    log(f"# search_device ({TIMED_B} queries on the card): {dev_s * 1e3:.2f} "
        f"ms = {TIMED_B / dev_s:.0f} QPS")
    del flat

    # ---- 4. kernel check and timing -------------------------------------
    kw = dict(ef=64, expand=4, m0=config.m0, d=idx.store.d_pad,
              max_steps=32, metric=MetricKind.L2SQ)
    err = compare_beam("1M-l2sq", path_beam_inputs(idx, q[:1024], 64), kw)
    kw128 = dict(kw, ef=128, expand=8, max_steps=64)
    err = max(err, compare_beam("1M-l2sq-ef128-e8",
                                path_beam_inputs(idx, q[:1024], 128), kw128))
    errs = kernel_checks_random(dev)
    args = path_beam_inputs(idx, q[:TIMED_B], 64)
    err = max([err, compare_beam("1M-l2sq-search-chunk", args, kw)]
              + list(errs.values()))

    n_exp = int(fb.fused_beam_search(*args, **kw)[3])
    k_ms = device_time(lambda: fb.fused_beam_search(*args, **kw), iters=10) * 1e3
    p_ms = device_time(lambda: fb.beam_search_plain(*args, **kw), iters=3) * 1e3
    bound_ms, bound_by = beam_bound_ms(args, kw, n_exp)
    log(f"# K1 at B={TIMED_B}, ef 64, expand 4, 32 steps: {k_ms:.3f} ms; plain "
        f"{p_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}, {n_exp} live "
        f"expansions); {bound_ms / k_ms:.1%} of the bound")
    search_stages(idx, qd, args, kw, k, dev_s * 1e3, k_ms)
    log(f"# total {time.perf_counter() - t_start:.1f} s")

    kernels = [{
        "name": "fused_beam",
        "route": "cuda",
        "source": "duckdb_vss_tpu_torch/csrc/fused_beam.cu",
        "replaces": "duckdb_vss_tpu/ops/pallas_beam.py:133",
        "launches": k1_launches,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
