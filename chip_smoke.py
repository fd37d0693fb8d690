#!/usr/bin/env python3
"""Chip smoke run of duckdb_vss_tpu_torch, the PyTorch/CUDA port, on one GPU.

Drives the port's main paths through the calls a user makes. Path 1:
HNSWIndex.add (the bulk build, IVF kNN sweep at this size), then
HNSWIndex.search (mxu descent, seed beam, kernel K1, exact rerank).
Path 2: HNSWIndex.add of 16,384 further rows into the built graph
(incremental insert, 64 batches of 256 through the int8 layout), then
HNSWIndex.search once through the fused beam and once with
layout="flat", traversal_dtype="f32", use_pallas=True: the step-by-step
beam, whose per-step scoring is kernel K2. Path 3: removals, isolate,
compact, stats, save and load, a bf16 store, the query transfer dtypes,
the augmented table, cluster, join and the stashed flat scan on that
index (phase 8 below). Path 4: the SQL layer, a disk-backed Database on
the card driven through db.execute (phase 9 below). Path 5: the
sharded index (parallel/sharded.py), four shards of the same rows on
the one card, in one process, on a grid of card slots, in P NCCL
processes (one card a rank, the collectives on the cards) and in two
gloo processes (phase 10 below). Path 6: the entry module (entry.py):
entry()'s search step, the same step over the index of path 1, and
dryrun_multichip on 2 and 4 shards and on grids of 4 and 8 card slots
(phase 4c below). The
configuration is the SIFT1M shape of ann-benchmarks'
sift-128-euclidean: 1,000,000 x 128 f32 base vectors and 10,000
queries, k=10, l2sq, with the HNSW defaults M=16, M0=32,
ef_construction=128, ef_search=64. The data is SIFT-shaped
clustered data made from --seed with bench.py's generator (4096
centres, sigma 0.25). Ground truth is the port's own exact f32
FlatIndex scan.

Phases (any failure raises and exits non-zero):
  1. device: nvidia-smi name and power limit, torch's device name;
  2. build: compile csrc/fused_beam.cu and csrc/gather_scores.cu with
     nvcc for sm_90a (two processes, started together), print each
     -Xptxas -v summary;
  3. main path 1: build + search at full width, with every kernel launch
     count set to 0 just before and read just after; requires recall@10
     >= 0.95 against the flat scan, K1 launched, its plain version not.
     Then the measured CPU baseline (utils/cpu_baseline.py, native/
     cpu_hnsw.cpp compiled for the host), 1,000 queries on every core
     over that index's graph at ef 64: every id in range, recall and
     QPS recorded with the CPU's name and thread count;
  4. kernel check: K1 against its plain PyTorch version on the same card
     inputs (id-set overlap >= 0.95, scores within rtol/atol 3e-3 where
     the ids agree: bf16 rounding of the products; equal n_dist and
     expansion counts): l2sq on the 1M tables (B=1024, ef 64, expand 4,
     32 steps) and ef 128 / expand 8; 4 steps, which end the queries
     while they expand, and 96, which every query leaves early (the
     kernel stops a query at its first step that selects nothing, the
     plain version runs the trip count); ip and cosine on a random
     table, and there also meta rows of 97 ints and expand 12 and 40;
     l2sq at the search chunk's shape (B=8192), where K1's time is then
     taken beside its plain version's and its bound, and once more at
     ef 128 / expand 8. The bound counts what the function needs from
     this run's counts: a meta row per live selection and one row of d
     int8 per candidate kept; the time for whole tiles (what the kernel
     copies, and what the bound counted before) is printed beside it.
     Then each phase's share of a block's resident clocks
     (tools/k1_phases.py, printed, not checked);
 4a. kernel check: K3 (the fused descent) against its plain PyTorch
     version on path 1's upper table (65,536 rows, l2sq) at B=8192 and
     B=1: every score within descent_bound (f32 sums in another order),
     the same slots wherever the plain scores are further apart than
     twice it, INF_SCORE and -1 past the live rows; then K3's time at
     both shapes beside its plain version's and its bound (bf16
     tensor-core operations at B=8192, bytes at B=1);
 4b. one graph per seed: the 1M rows bulk-built a second time on the
     same seed; every graph array (neighbors0, the upper tables,
     levels, entry node, max level, upper count) and n_distances must
     equal the first build's, and K1 at B=8192 must return the same
     beams and n_dist on both builds' tables (and agree with its plain
     version on the second's); the second index is kept for path 2;
 4c. main path 6, the entry module, counts set to 0 before and read
     after (path6): (a) entry() on the card, its step over its 512 x 64
     index: shapes (8, 10), ascending scores, ids >= 0, recall@10 >=
     0.95 against the exact scan; (b) the same step (the mxu descent,
     the step-by-step beam over the bf16 traversal copy, the exact
     rerank) over path 1's index, the queries in chunks of 8192:
     recall@10 >= 0.95, its device time per 8192 queries beside the
     fused search's; (c) dryrun_multichip(4) and (8) (2 and 4 shards),
     whose asserts must hold, each launching K1, then the same on grids
     of card slots, (q 2, shard 2) and (q 2, shard 4), K1 launched once
     per slot per search; its plain version never. Then K1 against its
     plain version on each shard of every replica row of the dry runs'
     indexes, built again, at the shapes their searches give it
     (dryrun_kernel_checks);
  5. main path 2, counts set to 0 before and read after: the insert,
     then (a) a fused search of the 10,000 queries and the inserted
     rows, recall@10 >= 0.95 against the flat scan over all 1,016,384
     rows and the inserted rows at rank 1 of their own search in >= 0.99
     of cases; (b) the flat-layout search through K2, recall@10 >= 0.95,
     K2 launched once per beam step, its plain version and K1 never;
     then the same rows inserted into 4b's second index: every graph
     array, the store, the int8 tables and meta rows, the distance
     count, the beam steps and K1's n_dist on both indexes' tables
     must equal (second_insert), and the second index is freed;
  6. kernel check: K2 against its plain PyTorch version for l2sq, ip and
     cosine, on the 1M store with the ids of a real beam step
     ([8192, 128], with -1s) and on a random table with zero rows, zero
     queries and rows of -1 only: largest difference <= 1e-4 of the
     scores' scale (f32 sums in another order), INF_SCORE exactly where
     id < 0; the wrapper refuses a bf16 table, a width off 128, strided
     ids. K2's time at that shape beside its plain version's and its
     byte bound;
  7. one more insert batch under torch.profiler, as one search_device
     call of each path before it: device kernels per call and the card's
     busy share (printed, not checked);
  8. main path 3 on that index, counts set to 0 before and read after
     (path3): remove every tenth key and the profiled batch, search
     (recall@10 >= 0.95 against the flat scan of the live rows, no
     removed key returned); isolate (then no edge into a tombstone) and
     search; compact and stats (level-0 nodes = live rows) and search
     through K1 on the rebuilt tables; save_index on the native
     container, load_index lazy and eager and load_index_from_buffer:
     each loaded index returns the same keys and scores as before the
     save; a bf16 store of the 1M base rows, bulk built (recall >=
     0.95); queries sent as bf16 and as int8 (recall >= 0.95 each); the
     flat layout with and without the augmented table at ef 64 (recall
     >= 0.95); cluster at level 1 (heads of level >= 1, exact scores);
     join of a 10,000-row held-out index (no blocking pair); the stashed
     flat scan of 1,024 queries equal to the per-block scan. K1
     launched, its plain version never;
  9. main path 4, the SQL layer, counts set to 0 before and read after
     (path4): Database(path=<tmp>, device="cuda"); the 1M base rows
     loaded through Table.insert (WAL-logged), CREATE INDEX (the bulk
     build), 200 single ORDER BY array_distance LIMIT 10 statements
     (EXPLAIN shows HNSW_INDEX_SCAN; recall@10 >= 0.95, d within the f32
     bound of the float64 distance; p50 and p99), the lateral join of a
     10,000-row query table (100,000 rows, recall >= 0.95) at ef 64
     through K1 and at SET hnsw_ef_search = 160 through the step-by-step
     beam alone; min_by (the scan's ids), a filter over the index scan
     (even ids only), the cosine FLAT_TOPN_SCAN and, under PRAGMA
     disable_optimizer, the host TopN (both exact within ties), one
     projected SELECT under torch.profiler (it must launch CUDA
     kernels); DELETE of every tenth row (no deleted id back, recall
     against the live rows), PRAGMA hnsw_compact_index, hnsw_index_info
     (count = table rows); CHECKPOINT, pragma_database_size, reopen
     (the lateral join equal key for key and distance for distance),
     16,384 rows inserted into the WAL, reopen with replay (each at rank
     1 of its own search in >= 0.99 of cases, recall >= 0.95). The
     seconds of every step, with the host parts timed apart. K1
     launched, its plain version never.
 10. main path 5, the sharded index, counts set to 0 before and read
     after (path5): (a) ShardedHNSWIndex on make_mesh(4) with 262,144
     rows a shard, the 1M rows bulk-built shard by shard (the capacity
     must not grow), the queries at the default ef_local (32: recall@10
     >= 0.90) and at ef_local=64 (>= 0.95), K1 once per shard per chunk,
     one search under tracing.trace + annotate (the trace must hold the
     region and a K1 kernel event); (b) remove every tenth key (none
     returned), isolate, compact, stats (count = live rows), recall >=
     0.95 at ef_local=64, save and load (keys and scores equal); (d)
     the same rows in a grid of one card slot a shard
     (make_mesh(4, devices=...), four slots of cuda:0 on one card, each
     searching on its own stream): keys and scores equal to (a)'s bit for
     bit at ef_local 32 and 64, K1 once per shard per chunk, the file
     after (b)'s steps byte-equal to (a)'s; its ms per 8,192-query
     search beside (a)'s, the host syncs of one search, under
     torch.profiler how much the shards' kernels overlap, and the
     device memory of one search beside (a)'s; on four cards or more
     also the replica rows (path5_replicas): the rows on a (q 2, shard
     2) grid, one slot a card, bit for bit as a one-row mesh of two
     shards on cuda:0 on both replica rows, before and after compact,
     a byte-equal file, the seconds in _sync_replicas (on one card it
     logs that it did not run); (e)
     this script again
     in P processes (--sharded-rank R --backend nccl), one
     "cpu:gloo,cuda:nccl" group, rank r on cuda:r with its block of the
     4 shards, every cross-rank value gathered on the cards (P = 4 on
     four cards or more, 2 on two or three, 1 on one card, where the log
     says that four ranks did not run): (a)'s and (b)'s lifecycle and a
     ShardedFlatIndex on every rank, whose keys and scores must equal
     (a)'s at ef_local 32 and 64, (b)'s after compact and a one-process
     ShardedFlatIndex's on this card, bit for bit; rank 0's file
     byte-equal to (a)'s; K1 S_local times a chunk on every rank and
     equal to its plain version on each rank's first shard; rank 0's ms
     a search beside (a)'s and (d)'s, its host syncs (the queries'
     upload once a chunk before its first K1 launch and gather, the
     results' two downloads a chunk after its last, none between), and
     under torch.profiler its card's busy time without NCCL's kernels,
     the NCCL all-gather calls (and kernels, on more than one card); (c) this
     script again in two processes (--sharded-rank), a gloo group on the
     one card, two shards each, the same rows from --seed: both ranks
     return the same keys and scores, and rank 0's file loaded here
     returns them too, and so do (a)'s one process and its 4 shards
     (one graph per seed, whatever the ranks). K1 launched, its
     plain version never. Then K1 against its plain version at the
     sharded default (ef 32, expand 4, 16 steps) on shard 0's tables of
     that file, B=1024, and its time at B=8192 beside its plain
     version's and its bound.

The line before the last is the kernel table as one JSON object; the
last line is {"ok": true, "device": {...}}. Run from the repository
root: python3 chip_smoke.py. On a machine with several cards, path 5
(d) and path 6 (c) lay their slots over the cards (card_slots) and path
5 (e) runs a rank a card.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12  # dense bf16, same source
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, same source
TOL = 3e-3
MIN_OVERLAP = 0.95
MIN_RECALL = 0.95
N, NQ, D, K = 1_000_000, 10_000, 128, 10  # SIFT1M: base rows, queries
TIMED_B = 8192  # search_device's timed batch and the kernels' timed shape
N_INSERT = 16_384  # rows added incrementally: 64 batches of 256
MIN_SELF_RECALL = 0.99  # an inserted row is its own nearest neighbor
GATHER_TOL = 1e-4  # K2 vs plain, relative to the scores' scale
DESCENT_BOUND_C = 5  # K3 vs plain: see descent_bound
RANK_TIMEOUT_S = 300  # a path 5 (e) rank's limit on each collective
# the first 8 bytes of a native index file (VSS_MAGIC, native/vss_store.cpp)
NATIVE_MAGIC = (0x30315550_54535356).to_bytes(8, "little")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_lines() -> list[str]:
    """Each card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()


def nvidia_smi_line() -> str:
    return nvidia_smi_lines()[0]


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


def early_exit_checks(args, kw):
    """K1 against its plain version at a trip count that ends the
    queries (at least 98% of the selections are live) and at one every
    query leaves early (the kernel gives the same for twice as long)."""
    import torch

    from duckdb_vss_tpu_torch.ops.fused_beam import fused_beam_search

    b, e = args[0].shape[0], kw["expand"]
    short, long = dict(kw, max_steps=4), dict(kw, max_steps=96)
    err = compare_beam("1M-l2sq-4-steps", args, short)
    n_exp = int(fused_beam_search(*args, **short)[3])
    check(n_exp >= 0.98 * b * 4 * e, f"4 steps: only {n_exp} of "
          f"{b * 4 * e} selections were live")
    err = max(err, compare_beam("1M-l2sq-96-steps", args, long))
    got = fused_beam_search(*args, **long)
    twice = fused_beam_search(*args, **dict(kw, max_steps=192))
    check(all(torch.equal(a, c) for a, c in zip(got, twice)),
          "96 steps: a query was still expanding")
    check(int(got[3]) < b * 96 * e, "96 steps: no selection was dead")
    log(f"# K1 early exit: {int(got[3])} expansions in 96 steps "
        f"({int(got[3]) / b / e:.1f} live steps a query), the same in 192")
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
    """K1 against its plain version on random tables for ip and cosine,
    for l2sq with meta rows of 97 ints: rows that do not start on
    16-byte boundaries, which the kernel reads with plain loads instead
    of bulk copies, and for expand 12 and 40 (more selections than the
    search path asks for, and more than a warp has lanes to start their
    copies) (also run by the gpu-marked test in
    tests/test_torch_hnsw.py)."""
    from duckdb_vss_tpu_torch.utils.config import MetricKind

    errs = {}
    args = random_beam_inputs(device)
    kw = dict(ef=64, expand=4, m0=32, d=128, max_steps=32)
    for metric in (MetricKind.IP, MetricKind.COSINE):
        errs[metric.value] = compare_beam(f"random-{metric.value}", args,
                                          dict(kw, metric=metric))
    narrow = args[:4] + (args[4][:, :97].contiguous(), args[5])
    errs["l2sq-97"] = compare_beam("random-l2sq-meta-rows-of-97", narrow,
                                   dict(kw, metric=MetricKind.L2SQ))
    errs["l2sq-e12"] = compare_beam(
        "random-l2sq-expand-12", args,
        dict(kw, expand=12, max_steps=12, metric=MetricKind.L2SQ))
    few = args[:4] + (pack_few_neighbors(args[4], 32, 4), args[5][:, :4]
                      .contiguous())
    errs["l2sq-e40"] = compare_beam(
        "random-l2sq-expand-40-m0-4", few,
        dict(kw, expand=40, m0=4, max_steps=8, metric=MetricKind.L2SQ))
    return errs


def pack_few_neighbors(meta, m0, keep):
    """Meta rows of the first ``keep`` of m0 neighbors, repacked."""
    import torch

    from duckdb_vss_tpu_torch.ops.fused_beam import pack_meta

    return pack_meta(meta[:, :keep],
                     meta[:, m0:m0 + keep].contiguous().view(torch.float32),
                     meta[:, 2 * m0:2 * m0 + keep].contiguous()
                     .view(torch.float32))


def path_beam_inputs(idx, queries_np, ef):
    """The kernel's inputs exactly as the search path builds them."""
    from duckdb_vss_tpu_torch.models.graph import mxu_descent, seed_beam

    qd = idx.store.prepare_queries(queries_np)
    q_sq = (qd * qd).sum(-1)
    uv, uvsq, unode = idx.tables.upper()
    nv, _scale, _sq, meta = idx.tables.neighborhood(idx.layout,
                                                    idx.nbr_budget_bytes)
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
    uv, uvsq, unode = idx.tables.upper()
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


def beam_bound_ms(args, kw, n_expanded, n_dist):
    """Least time for the same work on the card, from this run's counts:
    every live selection reads its 3*M0 meta ints once, every candidate
    the dedup keeps (n_dist of them: the only rows the function scores)
    its d int8 once; queries, seeds and outputs move once. Two
    operations per row byte (bf16 products) against the dense bf16
    peak. Returns (ms, "bytes" or "operations", ms when every live
    selection reads its whole M0*d-byte tile instead, which is what the
    kernel copies and what this bound counted before the kernel scored
    kept rows only)."""
    b, ef, m0, d = args[0].shape[0], kw["ef"], kw["m0"], kw["d"]
    io = (b * (d * 4 + 4 + ef * 8)  # queries, q_sq, seed beam
          + b * ef * 8 + b * 8)  # output beam, counts
    nbytes = n_expanded * 3 * m0 * 4 + n_dist * d + io
    ops = n_dist * d * 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    tiles_ms = (n_expanded * (m0 * d + 3 * m0 * 4) + io) / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", tiles_ms * 1e3)


def time_beam(args, kw):
    """K1's time, its bound from this run's counts and the log line's
    tail that states both bounds."""
    from duckdb_vss_tpu_torch.ops.fused_beam import fused_beam_search
    from duckdb_vss_tpu_torch.utils.timing import device_time

    _, _, n_dist, n_exp = fused_beam_search(*args, **kw)
    ms = device_time(lambda: fused_beam_search(*args, **kw), iters=10) * 1e3
    bound, by, tiles = beam_bound_ms(args, kw, int(n_exp), int(n_dist))
    return ms, bound, by, tiles, (
        f"bound {bound:.4f} ms ({by}: {int(n_exp)} meta rows, "
        f"{int(n_dist)} kept rows), the kernel at {bound / ms:.1%} of "
        f"it; with whole tiles read {tiles:.4f} ms, {tiles / ms:.1%}")


def recall_of(got, want, k):
    import numpy as np

    return float(np.mean([len(set(a) & set(b)) / k
                          for a, b in zip(got.tolist(), want.tolist())]))


def compare_gather(name, vectors, ids, queries, metric):
    """K2 and its plain version on the same card inputs. Returns the
    largest score difference over the live candidates."""
    import torch

    from duckdb_vss_tpu_torch.ops import fused_gather as fg

    q_sq = (queries * queries).sum(-1)
    got = fg.gather_scores_kernel(vectors, ids, queries, q_sq, metric)
    if got.is_cuda:  # a fault during the run surfaces here
        torch.cuda.synchronize()
    want = fg.gather_scores_plain(vectors, ids, queries, q_sq, metric)
    live = ids >= 0
    check(got.shape == ids.shape and got.dtype == torch.float32,
          f"{name}: output {got.dtype} {tuple(got.shape)}")
    check(bool((got[~live] == fg.INF_SCORE).all()),
          f"{name}: a score other than INF_SCORE where id < 0")
    check(bool((got[live] < fg.INF_SCORE).all()),
          f"{name}: INF_SCORE at a live candidate")
    scale = max(1.0, float(want[live].abs().max())) if live.any() else 1.0
    err = float((got[live] - want[live]).abs().max()) if live.any() else 0.0
    log(f"# kernel check {name}: ids {tuple(ids.shape)} live "
        f"{int(live.sum())} max_abs_err={err:.3e} (scale {scale:.1f})")
    check(err <= GATHER_TOL * scale,
          f"{name}: max_abs_err {err} > {GATHER_TOL} x scale {scale}")
    return err


def gather_checks_random(device, n=4096, d=256, b=64, c=40, seed=0):
    """K2 against its plain version on a random table, every metric:
    zero rows, zero queries, rows of -1 only, a width of two passes
    (also run by the gpu-marked test in tests/test_torch_gather.py)."""
    import numpy as np
    import torch

    from duckdb_vss_tpu_torch.utils.config import MetricKind

    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    vecs[[5, 9]] = 0.0
    q = rng.normal(size=(b, d)).astype(np.float32)
    q[2] = 0.0
    ids = rng.integers(0, n, (b, c)).astype(np.int32)
    ids[rng.random((b, c)) < 0.2] = -1
    ids[:, 3] = 5  # every query meets a zero row
    ids[4] = -1  # no candidate at all
    t = [torch.from_numpy(a).to(device) for a in (vecs, ids, q)]
    return {m.value: compare_gather(f"random-{m.value}", *t, m)
            for m in (MetricKind.L2SQ, MetricKind.IP, MetricKind.COSINE)}


def gather_rejects(device):
    """K2's wrapper raises on what the kernel does not take, and
    launches nothing (also run by the gpu-marked test in
    tests/test_torch_gather.py)."""
    import torch

    from duckdb_vss_tpu_torch.ops import fused_gather as fg
    from duckdb_vss_tpu_torch.utils.config import MetricKind

    v = torch.randn(64, 128, device=device)
    q = torch.randn(4, 128, device=device)
    q_sq = (q * q).sum(-1)
    ids = torch.zeros((4, 8), dtype=torch.int32, device=device)
    bad = {
        "a bf16 table": (v.to(torch.bfloat16), ids, q, q_sq),
        "a row width of 96": (v[:, :96].contiguous(), ids,
                              q[:, :96].contiguous(), q_sq),
        "ids that are not contiguous": (v, ids.T.contiguous().T, q, q_sq),
        "int64 ids": (v, ids.long(), q, q_sq),
        "queries on the CPU": (v, ids, q.cpu(), q_sq),
        "one query too few": (v, ids, q[:3], q_sq),
    }
    launches = fg.gather_scores_kernel.launches
    for what, args in bad.items():
        try:
            fg.gather_scores_kernel(*args, MetricKind.L2SQ)
        except ValueError:
            continue
        check(False, f"K2's wrapper took {what}")
    check(fg.gather_scores_kernel.launches == launches,
          "K2 launched on inputs it must refuse")
    log(f"# kernel check K2 wrapper: refused {len(bad)} bad inputs")


def beam_step_ids(idx, qd, expand=4):
    """The candidate ids of the search beam's first step, as
    graph.beam_search hands them to K2: the neighbor lists of the best
    ``expand`` descent seeds, with -1 for absent neighbors, ids already
    in the beam and repeats within the block. [B, expand * M0] int32."""
    import torch

    from duckdb_vss_tpu_torch.models.graph import mxu_descent, seed_beam

    uv, uvsq, unode = idx.tables.upper()
    seeds, _ = mxu_descent(uv, uvsq, unode, idx.graph.entry_node, qd,
                           idx.metric, 8)
    _, beam = seed_beam(idx.store._vectors, idx.store._vec_sq, seeds, qd,
                        (qd * qd).sum(-1), idx.metric, 8)
    sel = beam[:, :expand]
    nbrs = torch.where((sel >= 0)[:, :, None],
                       idx.graph.neighbors0[sel.clamp_min(0).long()], -1)
    nbrs = nbrs.reshape(qd.shape[0], -1)
    in_beam = (nbrs[:, :, None] == beam[:, None, :]).any(dim=2)
    dup = torch.triu(nbrs[:, :, None] == nbrs[:, None, :], 1).any(dim=1)
    return torch.where((nbrs >= 0) & ~in_beam & ~dup, nbrs, -1).contiguous()


def descent_bound(q, table_sq, metric):
    """Per query, the largest difference two correct f32 computations
    of its descent scores may show (the bound of tests/test_torch_topk.py,
    d u (|q|^2 + |v|^2) times DESCENT_BOUND_C for l2sq): the products of
    bf16 values are exact in f32 on both sides, and only the order of
    the f32 additions differs, the tensor cores' adder truncating where
    the plain product rounds (at most 2u an addition against u). [B]
    float64."""
    import numpy as np

    q = q.double().cpu().numpy()
    v_sq_max = float(table_sq.double().max().cpu()) if len(table_sq) else 0.0
    d = q.shape[1]
    q_sq = (q * q).sum(1)
    if metric.value == "l2sq":
        scale = q_sq + v_sq_max
    elif metric.value == "cosine":
        scale = np.ones_like(q_sq)
    else:
        scale = np.sqrt(q_sq * v_sq_max) + 1.0
    return DESCENT_BOUND_C * d * 2.0 ** -24 * scale


def descent_reference(q, table, table_sq, nodes, k, metric):
    """K3's plain version on the same inputs, the table padded with dead
    rows to a multiple of 16,384 (its blocks; a dead row is never taken
    before a live one, so the live places are the same)."""
    import torch

    from duckdb_vss_tpu_torch.ops import fused_descent as fd

    u, d = table.shape
    pad = -u % 16384 if u > 16384 else 0
    if pad:
        table = torch.cat([table, table.new_zeros((pad, d))])
        table_sq = torch.cat([table_sq, table_sq.new_zeros(pad)])
        nodes = torch.cat([nodes, nodes.new_full((pad,), -1)])
    return fd.fused_descent_plain(q, table, table_sq, nodes, k, metric)


def compare_descent(name, q, table, table_sq, nodes, metric, k=8):
    """K3 and its plain version on the same card inputs: every score
    within descent_bound of the plain one, INF_SCORE and slot -1 exactly
    past the live rows, and the same slots wherever the plain scores
    around a place are further apart than twice the bound (in a closer
    group, the same set; in a group cut by the k-th place, distinct new
    slots). Returns the largest score difference over the bound."""
    import numpy as np
    import torch

    from duckdb_vss_tpu_torch.ops import fused_descent as fd
    from duckdb_vss_tpu_torch.utils.padding import INF_SCORE

    got_s, got_i = fd.fused_descent(q, table, table_sq, nodes, k, metric)
    if got_s.is_cuda:  # a fault during the run surfaces here
        torch.cuda.synchronize()
    want_s, want_i = descent_reference(q, table, table_sq, nodes, k + 1,
                                       metric)
    check(tuple(got_s.shape) == (q.shape[0], k) and got_i.dtype == torch.int32,
          f"{name}: output {got_i.dtype} {tuple(got_s.shape)}")
    bound = descent_bound(q, table_sq, metric)
    got_s, got_i = got_s.cpu().numpy(), got_i.cpu().numpy()
    want_s, want_i = want_s.cpu().numpy(), want_i.cpu().numpy()
    live = want_s[:, :k] < INF_SCORE
    check(bool((got_s[~live] == INF_SCORE).all()
               and (got_i[~live] == -1).all()),
          f"{name}: a place past the live rows holds a score or a slot")
    diff = np.abs(got_s.astype(np.float64) - want_s[:, :k])
    ratio = float((diff / bound[:, None])[live].max()) if live.any() else 0.0
    check(ratio <= 1.0, f"{name}: a score differs by {ratio:.2f} x the bound")
    bad = 0
    for r in range(got_s.shape[0]):
        s, tie = want_s[r].astype(np.float64), 2.0 * bound[r]
        n_live = int(live[r].sum())
        start = 0
        while start < n_live:
            end = start + 1
            while end <= k and s[end] < INF_SCORE and s[end] - s[end - 1] <= tie:
                end += 1
            g, w = got_i[r, start:min(end, k)], want_i[r, start:min(end, k)]
            if end <= k:
                bad += set(g.tolist()) != set(w.tolist())
            else:
                bad += (len(set(g.tolist())) != len(g)
                        or bool(set(g.tolist()) & set(got_i[r, :start].tolist())))
            start = end
    check(bad == 0, f"{name}: {bad} groups of slots differ beyond ties")
    log(f"# kernel check {name}: B={q.shape[0]} U={table.shape[0]} "
        f"D={table.shape[1]} k={k} live places {int(live.sum())} largest "
        f"score difference {ratio:.3f} x the bound")
    return ratio


def descent_random_inputs(device, b, u, d=128, seed=0, dead=0.05):
    """Queries and an upper table for K3: SIFT-like magnitudes, a share
    ``dead`` of the rows dead, a zero row and a zero query (cosine's
    zero-norm rule), the table's norms taken from its f32 rows as
    upper_table does."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    vecs = (30.0 * rng.random((u, d))).astype(np.float32)
    vecs[7 % u] = 0.0
    nodes = np.arange(u, dtype=np.int32)
    nodes[rng.random(u) < dead] = -1
    q = (30.0 * rng.random((b, d))).astype(np.float32)
    q[b // 2] = 0.0
    v = torch.from_numpy(vecs).to(device)
    nd = torch.from_numpy(nodes).to(device)
    return (torch.from_numpy(q).to(device), v.to(torch.bfloat16),
            (v * v).sum(1) * (nd >= 0), nd)


# K3's other plans, each as (D, B, U, k, share of dead rows): 8, 4, 2
# and 1 warps a block (D of 256, 1,024, 2,048 and 4,096, several
# 128-deep panels a tile), lists of 8 places for k below 8 and of 32
# past it, up to the most seeds the kernel takes; and an insert step of
# the insert cell (1,572,864 rows reserved): 256 rows against the whole
# upper-slot table, 393,216 rows of which a sixth live
DESCENT_PLAN_CASES = ((256, 1808, 65_488, 8, 0.05),
                      (1024, 1808, 16_400, 8, 0.05),
                      (2048, 256, 16_400, 8, 0.05),
                      (4096, 256, 16_400, 8, 0.05),
                      (128, 1808, 65_488, 4, 0.05),
                      (1024, 1, 16_400, 4, 0.05),
                      (128, 1, 65_488, 16, 0.05),
                      (128, 1808, 65_488, 16, 0.05),
                      (256, 256, 65_488, 32, 0.05),
                      (128, 256, 393_216, 8, 5 / 6))


def descent_checks_random(device, batches=(1, 256, 1808, 8192),
                          rows=(65_536, 65_488)):
    """K3 against its plain version on random tables for every metric:
    at D=128 and k=8 for every batch and row count (65,488 is no
    multiple of the kernel's 128-row tile), then at each of
    DESCENT_PLAN_CASES; also run by the gpu-marked test in
    tests/test_torch_fused_descent.py. Returns each case's largest
    score difference over its bound."""
    from duckdb_vss_tpu_torch.utils.config import MetricKind

    cases = [(128, b, u, 8, 0.05) for u in rows for b in batches]
    out = {}
    for d, b, u, k, dead in cases + list(DESCENT_PLAN_CASES):
        # the D=128, k=8 cases keep the seeds they were first checked on
        seed = b + u if (d, k) == (128, 8) else b + u + d + 100 * k
        args = descent_random_inputs(device, b, u, d=d, seed=seed,
                                     dead=dead)
        for m in (MetricKind.L2SQ, MetricKind.IP, MetricKind.COSINE):
            name = f"random-{m.value}-B{b}-U{u}-D{d}-k{k}"
            out[name] = compare_descent(name, *args, m, k=k)
    return out


def descent_bound_ms(q, table, nodes, k):
    """The least time of the descent's work on the card: its bf16
    tensor-core operations (2 d per query and live row) over the peak,
    or its bytes (the nodes, the live rows with their norms, the
    queries, the results) over HBM's bandwidth, whichever is longer."""
    b, d = q.shape
    live = int((nodes >= 0).sum())
    ops = 2.0 * b * live * d
    nbytes = (4 * nodes.shape[0] + live * (2 * d + 4) + 4 * b * d
              + 8 * b * k)
    by_ops, by_bytes = ops / BF16_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return ((by_ops, "bf16 operations") if by_ops >= by_bytes
            else (by_bytes, "bytes"))


def time_descent(q, table, table_sq, nodes, metric, k=8):
    """K3's time at one shape (CUDA events over repeated calls), its
    plain version's, and the bound: (ms, plain ms, bound ms, bound by)."""
    from duckdb_vss_tpu_torch.ops import fused_descent as fd
    from duckdb_vss_tpu_torch.utils.timing import device_time

    args = (q, table, table_sq, nodes, k, metric)
    ms = device_time(lambda: fd.fused_descent(*args), iters=50) * 1e3
    p_ms = device_time(lambda: fd.fused_descent_plain(*args), iters=5) * 1e3
    bound, by = descent_bound_ms(q, table, nodes, k)
    return ms, p_ms, bound, by


def descent_engaged(device, n=8192, d=128):
    """One HNSWIndex.search on the card goes through K3 and never
    through its plain version (also run by the gpu-marked test)."""
    import numpy as np

    from duckdb_vss_tpu_torch import HNSWConfig
    from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex
    from duckdb_vss_tpu_torch.ops import fused_descent as fd

    rng = np.random.default_rng(5)
    idx = HNSWIndex(d, HNSWConfig(), capacity=n, device=device)
    idx.add(rng.random((n, d)).astype(np.float32), np.arange(n))
    launches, calls = fd.fused_descent.launches, fd.fused_descent_plain.calls
    idx.search(rng.random((100, d)).astype(np.float32), 10)
    check(fd.fused_descent.launches > launches,
          "HNSWIndex.search did not launch K3")
    check(fd.fused_descent_plain.calls == calls,
          "HNSWIndex.search ran K3's plain version")
    log(f"# K3 engaged: {fd.fused_descent.launches - launches} launch(es) "
        "for one search, its plain version never")


def gather_bound_ms(ids, d):
    """Least time for the same work on the card: every live candidate's
    row (d floats) is read once, and ids, queries, q_sq and the output
    move once. Four f32 operations per row element (dot and norm)."""
    b, c = ids.shape
    live = int((ids >= 0).sum())
    nbytes = live * d * 4 + b * c * 4 + b * d * 4 + b * 4 + b * c * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = live * d * 4 / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", live)


def profile_on_card(what, fn, smi):
    """Run fn once under torch.profiler and print how many device
    kernels it launched, how long the card was busy within its wall
    time, the five operators with the most device time and the port's
    own kernels. Returns the number of device kernels and copies (0 when
    the profiler recorded no device activity)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # key_averages lists every device kernel (device_type CUDA) and, once
    # more, the operator that launched it (device_type CPU, with the
    # kernel's time as its own device time): count the kernels, name the
    # operators, and the port's own kernels, which no operator launches
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"# profile of {what} on {smi}: {wall_ms:.1f} ms under the "
            "profiler; device time not measured (the profiler recorded no "
            "device activity)")
        return 0
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ops = sorted((e for e in events if e.device_type != DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)[:5]
    own = [e for e in kernels
           if "gather_scores" in e.key or "fused_beam" in e.key]
    names = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms"
                      f" x{e.count}" for e in ops + own)
    n_kernels = sum(e.count for e in kernels)
    log(f"# profile of {what} on {smi}: {wall_ms:.1f} ms under the profiler, "
        f"{n_kernels} device kernels and copies, card "
        f"busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.1%} of the wall time); "
        f"most device time by operator: {names}")
    return n_kernels


def timed(dev, fn):
    """(fn(), seconds) on the host clock, the card synchronized before
    and after."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def blocking_pairs(matches, men_keys, pref_s, pref_k):
    """Pairs (proposer m, candidate w in m's list) that prefer each other
    over their partners: m ranks w before his partner (or has none) and
    w's partner is farther from her than m (or she has none). A stable
    matching has none."""
    import numpy as np

    row = {int(m): i for i, m in enumerate(men_keys)}

    def score_of(m, w):
        i = row[m]
        hit = np.nonzero(pref_k[i] == w)[0]
        return float(pref_s[i, hit[0]]) if len(hit) else np.inf

    partner = {w: score_of(m, w) for m, w in matches.items()}
    n_bad = 0
    for m in row:
        mine = score_of(m, matches[m]) if m in matches else np.inf
        for s, w in zip(pref_s[row[m]], pref_k[row[m]]):
            if w >= 0 and s < mine and partner.get(int(w), np.inf) > s:
                n_bad += 1
    return n_bad


def path3(idx, all_vecs, extra_keys, q, n_base, want_base, make_rows, smi,
          k=K, n_join=10_000, n_stash_q=1024, timed_b=TIMED_B):
    """Main path 3, everything a user does with one index after CREATE
    INDEX and INSERT: remove, isolate, compact, stats, save and load
    (lazy, eager, from a buffer), a bf16 store, bf16 and int8 query
    transfers, the augmented table, cluster, join and the stashed flat
    scan. ``all_vecs`` holds the rows of keys 0..len-1, ``extra_keys``
    further live keys (removed here too), ``want_base`` the exact top-k
    keys of ``q`` among the first ``n_base`` rows, ``make_rows(n)`` draws
    n more rows from the data's generator. Raises on any failed check;
    returns what it measured."""
    import numpy as np
    import torch

    from duckdb_vss_tpu_torch import MetricKind
    from duckdb_vss_tpu_torch.models.flat import FlatIndex
    from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex
    from duckdb_vss_tpu_torch.ops.topk import flat_topk, flat_topk_stashed
    from duckdb_vss_tpu_torch.utils import persist
    from duckdb_vss_tpu_torch.utils.timing import device_time

    dev, d, out = idx.device, idx.dims, {}
    here = os.path.dirname(os.path.abspath(__file__))
    n_all = len(all_vecs)
    dead = np.r_[np.arange(0, n_all, 10), extra_keys].astype(np.int64)
    live_keys = np.setdiff1d(np.arange(n_all), dead)
    n_removed, out["remove_s"] = timed(dev, lambda: idx.remove(dead))
    check(n_removed == len(dead) and len(idx) == len(live_keys),
          f"removed {n_removed} of {len(dead)} keys")
    flat = FlatIndex(d, MetricKind.L2SQ, capacity=len(live_keys), device=dev)
    flat.add(all_vecs[live_keys], live_keys)
    want = flat.search(q, k)[1]
    del flat
    log(f"# path 3 on {smi}: removed {n_removed} keys (every tenth of "
        f"{n_all} and {len(extra_keys)} more) in {out['remove_s']:.3f} s; "
        f"{len(live_keys)} live rows")

    def search_checked(name, index=idx, truth=want, removed=dead, **kw):
        (scores, got), sec = timed(dev, lambda: index.search(q, k, **kw))
        rec = recall_of(got, truth, k)
        back = int(np.isin(got, removed).sum())
        log(f"# path 3 ({name}) on {smi}: {len(q)} queries in {sec:.3f} s, "
            f"recall@{k} {rec:.4f}, removed keys returned {back}")
        check(np.isfinite(scores).all() and (got >= 0).all(),
              f"{name}: missing or non-finite results")
        check(rec >= MIN_RECALL, f"{name}: recall {rec} < {MIN_RECALL}")
        check(back == 0, f"{name}: {back} removed keys returned")
        out[f"recall_{name}"] = rec
        return scores, got

    # 1. tombstones: traversal walks through them, results drop them
    search_checked("removed")

    # 2. isolate: no edge points into a tombstone any more
    def edges_into_tombstones():
        valid = idx.store._valid
        return sum(int(((t >= 0) & ~valid[t.clamp_min(0).long()]).sum())
                   for t in (idx.graph.neighbors0, idx.graph.upper_neighbors))

    before = edges_into_tombstones()
    _, out["isolate_s"] = timed(dev, idx.isolate)
    after = edges_into_tombstones()
    log(f"# path 3 isolate on {smi}: {out['isolate_s']:.3f} s; edges into "
        f"tombstones "
        f"{before} -> {after}")
    check(before > 0 and after == 0, f"isolate left {after} edges")
    search_checked("isolated")

    # 3. compact and stats: live nodes renumbered, K1 on the new tables
    _, out["compact_s"] = timed(dev, idx.compact)
    stats, out["stats_s"] = timed(dev, idx.stats)
    lv = stats["levels"]
    log(f"# path 3 compact on {smi}: {out['compact_s']:.3f} s; stats "
        f"{out['stats_s']:.3f} s: count {stats['count']}, capacity "
        f"{stats['capacity']}, max_level {stats['max_level']}, nodes per "
        f"level {[x['nodes'] for x in lv]}, level-0 edges {lv[0]['edges']}")
    check(lv[0]["nodes"] == len(live_keys) == stats["count"],
          f"level-0 nodes {lv[0]['nodes']} != live {len(live_keys)}")
    scores_c, got_c = search_checked("compacted")
    again = idx.search(q, k)
    log(f"# path 3: the same search again equals it: "
        f"{np.array_equal(again[1], got_c) and np.array_equal(again[0], scores_c)}")

    # 4. save and load on the native container: the same keys and scores
    lib = persist.get_lib()
    check(lib is not None, "the native vss_store library did not load (the "
          ".npz fallback would run)")
    log(f"# path 3 persistence through {os.path.relpath(lib._name, here)}")
    build_dir = os.path.join(here, "build")
    os.makedirs(build_dir, exist_ok=True)

    def same_as_saved(name, loaded):
        (s2, k2), sec = timed(dev, lambda: loaded.search(q, k))
        n_keys = int((k2 != got_c).sum())
        n_scores = int((s2 != scores_c).sum())
        log(f"# path 3 {name} on {smi}: first search {sec:.3f} s; keys "
            f"differing "
            f"from before the save {n_keys}, scores {n_scores}")
        check(n_keys == 0 and n_scores == 0,
              f"{name}: the loaded index searches differently")
        return sec

    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        path = os.path.join(tmp, "index.vss")
        _, out["save_s"] = timed(dev, lambda: persist.save_index(idx, path))
        with open(path, "rb") as f:
            check(f.read(8) == NATIVE_MAGIC, "not a native container")
        size_mb = os.path.getsize(path) / 2**20
        lazy, out["open_lazy_s"] = timed(
            dev, lambda: persist.load_index(path, device=dev))
        check(lazy._pending_load is not None and lazy.graph is None,
              "the lazy load read the device sections")
        out["lazy_first_search_s"] = same_as_saved("lazy load", lazy)
        del lazy
        eager, out["load_eager_s"] = timed(
            dev, lambda: persist.load_index(path, lazy=False, device=dev))
        same_as_saved("eager load", eager)
        del eager
        with open(path, "rb") as f:
            img = f.read()
        buf, out["load_buffer_s"] = timed(
            dev, lambda: persist.load_index_from_buffer(img, lazy=False,
                                                        device=dev))
        same_as_saved("load from a buffer", buf)
        del buf, img
    log(f"# path 3 persistence on {smi}: save {out['save_s']:.2f} s "
        f"({size_mb:.0f} MiB), lazy open {out['open_lazy_s']:.3f} s + first "
        f"search {out['lazy_first_search_s']:.2f} s, eager load "
        f"{out['load_eager_s']:.2f} s, from a buffer "
        f"{out['load_buffer_s']:.2f} s")

    # 5. a bf16 store of the base rows, bulk built
    base = all_vecs[:n_base]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    b16 = HNSWIndex(d, idx.config, capacity=len(base), device=dev,
                    scalar_kind="bf16")
    _, out["bf16_build_s"] = timed(dev, lambda: b16.add(
        base, np.arange(len(base))))
    b16.search(q[:64], k)  # builds the int8 layout from the bf16 rows
    search_checked("bf16_store", index=b16, truth=want_base,
                   removed=np.zeros(0, np.int64))
    qd16 = b16.store.prepare_queries(q[:timed_b])
    out["bf16_search_device_ms"] = (device_time(
        lambda: b16.search_device(qd16, k), iters=5) * 1e3
        if dev.type == "cuda" else float("nan"))
    peak = (torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda"
            else float("nan"))
    log(f"# path 3 bf16 store on {smi}: build {out['bf16_build_s']:.2f} s, "
        f"search_device {out['bf16_search_device_ms']:.2f} ms at "
        f"B={timed_b}, peak device memory {peak:.2f} GiB, store "
        f"{b16.store._vectors.dtype}")
    del b16, qd16

    # 6. queries sent as bf16 and as int8
    for transfer in ("bf16", "int8"):
        idx.query_transfer_dtype = transfer
        search_checked(f"transfer_{transfer}")
    idx.query_transfer_dtype = "f32"

    # 7. the flat layout's step-by-step beam with and without the
    # augmented table, ef 64
    idx.layout, idx.use_aug = "flat", True
    search_checked("aug", ef=64)
    idx.use_aug = False
    idx.tables.drop("aug")
    search_checked("flat_bf16", ef=64)
    idx.layout = "auto"

    # 8. cluster heads at level 1
    (ckeys, cscores), out["cluster_s"] = timed(
        dev, lambda: idx.cluster(q, level=1))
    levels = idx.graph.levels.cpu().numpy()
    check((ckeys >= 0).all(), "cluster: a missing key")
    heads = np.array([idx.store._key_to_slot[int(c)] for c in ckeys])
    exact = ((q - all_vecs[ckeys]) ** 2).sum(1)
    log(f"# path 3 cluster on {smi}: {len(q)} queries in "
        f"{out['cluster_s']:.3f} s, "
        f"{len(np.unique(ckeys))} distinct heads, lowest head level "
        f"{levels[heads].min()}")
    check((levels[heads] >= 1).all(), "cluster: a head below level 1")
    check(np.allclose(cscores, exact, rtol=1e-4, atol=1e-4),
          "cluster: scores are not the exact l2sq distances")

    # 9. join: a held-out index proposes to the big one (K1 searches)
    held = make_rows(n_join)
    hidx = HNSWIndex(d, idx.config, capacity=n_join, device=dev)
    hkeys = np.arange(n_join, dtype=np.int64) + 2 * 10**9
    hidx.add(held, hkeys)
    matches, out["join_s"] = timed(dev, lambda: hidx.join(idx, k=16))
    pref_s, pref_k = idx.search(held, 16)
    n_bad = blocking_pairs(matches, hkeys, pref_s, pref_k)
    log(f"# path 3 join on {smi}: {n_join} proposers, {len(matches)} "
        f"matched in {out['join_s']:.2f} s; blocking pairs {n_bad}")
    check(len(matches) > 0 and n_bad == 0, f"join: {n_bad} blocking pairs")
    del hidx

    # 10. the stashed flat scan equals the per-block one, id for id
    st = idx.store
    qd = st.prepare_queries(q[:n_stash_q])
    args = (qd, st._vectors, k, MetricKind.L2SQ)
    blk = 16384 if st.capacity % 16384 == 0 else st.capacity
    plain = flat_topk(*args, vec_sq=st._vec_sq, valid=st._valid,
                      block_n=blk)
    stash = flat_topk_stashed(*args, st._vec_sq, st._valid, blk)
    routed = flat_topk(*args, vec_sq=st._vec_sq, valid=st._valid,
                       block_n=blk, stash_bytes=n_stash_q * st.capacity * 4)
    same = all(torch.equal(a, b) for a, b in zip(plain + routed,
                                                 stash + stash))
    if dev.type == "cuda":
        out["stash_ms"] = device_time(lambda: flat_topk_stashed(
            *args, st._vec_sq, st._valid, blk), iters=3) * 1e3
        out["blockwise_ms"] = device_time(lambda: flat_topk(
            *args, vec_sq=st._vec_sq, valid=st._valid, block_n=blk),
            iters=3) * 1e3
    log(f"# path 3 stashed flat scan on {smi}, {n_stash_q} queries over "
        f"{st.capacity} rows: equal to the per-block scan id for id and "
        f"score for score: {same}; device ms stashed "
        f"{out.get('stash_ms', float('nan')):.2f}, per block "
        f"{out.get('blockwise_ms', float('nan')):.2f}")
    check(same, "the stashed flat scan differs from the per-block scan")
    return out


@contextlib.contextmanager
def clocked(acc, dev, *targets):
    """For the block's duration, sum into acc[key] the seconds spent in
    each ``(owner, method name, key)`` of ``targets`` (an instance, a
    class or a module), the card synchronized before the clock stops."""
    import torch

    saved = []
    for owner, name, key in targets:
        fn = getattr(owner, name)
        acc.setdefault(key, 0.0)

        def wrapper(*a, _fn=fn, _key=key, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                acc[_key] += time.perf_counter() - t0

        saved.append((owner, name, owner.__dict__.get(name)))
        setattr(owner, name, wrapper)
    try:
        yield acc
    finally:
        for owner, name, old in reversed(saved):
            if old is None:
                delattr(owner, name)
            else:
                setattr(owner, name, old)


def vec_literal(v) -> str:
    """A FLOAT[d] SQL literal that parses back to ``v``'s f32 values
    exactly (each element as the shortest repr of its double)."""
    return ("[" + ", ".join(repr(float(x)) for x in v)
            + f"]::FLOAT[{len(v)}]")


def exact_scores(vecs, q, metric):
    """float64 array_distance (l2) or array_cosine_distance of q against
    every row, in chunks."""
    import numpy as np

    q = q.astype(np.float64)
    out = np.empty(len(vecs), np.float64)
    for off in range(0, len(vecs), 200_000):
        v = vecs[off:off + 200_000].astype(np.float64)
        if metric == "l2":
            out[off:off + len(v)] = np.sqrt(((v - q) ** 2).sum(1))
        else:
            out[off:off + len(v)] = 1.0 - v @ q / np.maximum(
                np.sqrt((v * v).sum(1) * (q @ q)), 1e-30)
    return out


def within_ties(got_ids, got_d, exact, k, tol, what):
    """An exact top-k within ties: k distinct ids, each at most the
    k-th exact distance + tol from the query, and each emitted distance
    within tol of its exact value."""
    import numpy as np

    kth = np.partition(exact, k - 1)[k - 1]
    check(len(got_ids) == k and len(set(got_ids.tolist())) == k,
          f"{what}: {len(got_ids)} rows, {len(set(got_ids.tolist()))} "
          "distinct")
    check(bool((exact[got_ids] <= kth + tol).all()),
          f"{what}: a row beyond the exact {k}-th distance {kth}")
    err = float(np.abs(got_d - exact[got_ids]).max())
    check(err <= tol, f"{what}: emitted distance off by {err} > {tol}")
    return err


def path4(dev, vecs, q, want, new, smi, tmp_root, k=K, n_single=200):
    """Main path 4, the SQL layer: a disk-backed Database on ``dev`` and
    db.execute(...) for every step but the two bulk row loads (through
    Table.insert, which the WAL logs). ``vecs`` are the rows of ids
    0..n-1, ``want`` the exact top-k ids of ``q`` among them, ``new``
    rows inserted after the reopen. Raises on any failed check; returns
    what it measured."""
    import gc

    import numpy as np
    import torch

    from duckdb_vss_tpu_torch import MetricKind
    from duckdb_vss_tpu_torch.models import graph as port_graph
    from duckdb_vss_tpu_torch.models.flat import FlatIndex
    from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex
    from duckdb_vss_tpu_torch.ops import fused_beam as fb
    from duckdb_vss_tpu_torch.sql import engine
    from duckdb_vss_tpu_torch.sql.engine import Database, open_database

    n, d = vecs.shape
    nq = len(q)
    out = {}
    f32_rel = 2 * d * 2.0 ** -24  # a sum of d f32 squares, then its root
    root = tempfile.mkdtemp(dir=tmp_root)
    path = os.path.join(root, "db")
    wal_path = os.path.join(path, "vss.wal")

    def sql(stmt):
        return db.execute(stmt)

    def truth(keys, rows, qs):
        flat = FlatIndex(d, MetricKind.L2SQ, capacity=len(keys), device=dev)
        flat.add(rows, keys)
        return flat.search(qs, k)[1]

    # 1. schema and the bulk load (logged)
    db = Database(path=path, device=dev)
    sql("SET hnsw_enable_experimental_persistence = true")
    sql(f"CREATE TABLE items (id BIGINT, vec FLOAT[{d}])")
    items = db.table("items")
    acc = {}
    with clocked(acc, dev, (db.wal, "append", "wal")):
        _, out["load_s"] = timed(dev, lambda: items.insert(
            {"id": np.arange(n, dtype=np.int64), "vec": vecs}))
    out["load_wal_s"] = acc["wal"]
    out["wal_mib"] = os.path.getsize(wal_path) / 2**20
    log(f"# path 4 load on {smi}: {n} rows through Table.insert in "
        f"{out['load_s']:.2f} s, of which the WAL append {acc['wal']:.2f} s "
        f"({out['wal_mib']:.0f} MiB, fsync on)")

    # 2. CREATE INDEX: the row gather on the host, the bulk build on the card
    acc = {}
    with clocked(acc, dev, (items, "_gather_index_rows", "gather"),
                 (HNSWIndex, "add", "build")):
        _, out["create_index_s"] = timed(dev, lambda: sql(
            "CREATE INDEX items_idx ON items USING HNSW (vec)"))
    out["create_gather_s"], out["create_build_s"] = acc["gather"], acc["build"]
    index = db.indexes["items_idx"].index
    check(index.device == dev and len(index) == n,
          f"the index holds {len(index)} rows on {index.device}")
    log(f"# path 4 CREATE INDEX on {smi}: {out['create_index_s']:.2f} s: row "
        f"gather {acc['gather']:.2f} s, build {acc['build']:.2f} s")

    # 3. single-vector ORDER BY ... LIMIT k statements
    def topk_stmt(qv, fn="array_distance", where=""):
        lit = vec_literal(qv)
        return (f"SELECT id, {fn}(vec, {lit}) AS d FROM items {where}"
                f"ORDER BY {fn}(vec, {lit}) LIMIT {k}")

    plan = sql("EXPLAIN " + topk_stmt(q[0]))
    check("HNSW_INDEX_SCAN" in plan, f"no index scan in the plan:\n{plan}")
    sql(topk_stmt(q[0]))  # the first search builds the int8 layout
    got, ms, acc = [], [], {}
    with clocked(acc, dev, (index, "search", "search"),
                 (items, "fetch", "fetch")):
        for i in range(n_single):
            res, sec = timed(dev, lambda: sql(topk_stmt(q[i])))
            ms.append(sec * 1e3)
            exact = np.sqrt(((vecs[res["id"]].astype(np.float64) - q[i]) ** 2)
                            .sum(1))
            check(bool((np.abs(res["d"] - exact)
                        <= f32_rel * exact + 1e-6).all()),
                  f"statement {i}: d off the exact distance beyond the f32 "
                  "bound")
            got.append(res["id"])
    got = np.stack(got)
    out["single_recall"] = recall_of(got, want[:n_single], k)
    out["single_p50_ms"], out["single_p99_ms"] = (
        float(np.percentile(ms, 50)), float(np.percentile(ms, 99)))
    log(f"# path 4 single statements on {smi}: {n_single} ORDER BY "
        f"array_distance LIMIT {k}: recall@{k} {out['single_recall']:.4f}, "
        f"p50 {out['single_p50_ms']:.2f} ms, p99 {out['single_p99_ms']:.2f}"
        f" ms; of the {sum(ms):.0f} ms in all HNSWIndex.search "
        f"{acc['search'] * 1e3:.0f} ms, Table.fetch {acc['fetch'] * 1e3:.0f}"
        " ms, the rest parse, plan and projection")
    check(out["single_recall"] >= MIN_RECALL,
          f"single statements: recall {out['single_recall']} < {MIN_RECALL}")
    del items, index  # what follows reaches them through db

    # 4. the lateral join: one batched index search for every outer row
    sql(f"CREATE TABLE queries (qid BIGINT, qvec FLOAT[{d}])")
    db.table("queries").insert({"qid": np.arange(nq, dtype=np.int64),
                                "qvec": q})
    join_stmt = (
        "SELECT qid, id, d FROM queries, LATERAL (SELECT id, "
        "array_distance(items.vec, queries.qvec) AS d FROM items ORDER BY "
        f"array_distance(items.vec, queries.qvec) LIMIT {k})")
    plan = sql("EXPLAIN " + join_stmt)
    check("HNSW_INDEX_JOIN" in plan, f"no index join in the plan:\n{plan}")

    def lateral(name, truth_ids, removed=None):
        acc = {}
        with clocked(acc, dev, (db.indexes["items_idx"].index, "search",
                                "search")):
            res, sec = timed(dev, lambda: sql(join_stmt))
        check(len(res["id"]) == nq * k, f"{name}: {len(res['id'])} rows")
        order = np.argsort(res["qid"], kind="stable")
        ids = res["id"][order].reshape(nq, k)
        dist = res["d"][order].reshape(nq, k)
        check(bool((res["qid"][order].reshape(nq, k)
                    == np.arange(nq)[:, None]).all()), f"{name}: qid groups")
        rec = recall_of(ids, truth_ids, k)
        back = 0 if removed is None else int(removed(ids).sum())
        log(f"# path 4 lateral join ({name}) on {smi}: {nq * k} rows in "
            f"{sec:.3f} s (HNSWIndex.search {acc['search']:.3f} s, host "
            f"assembly {sec - acc['search']:.3f} s), recall@{k} {rec:.4f}, "
            f"deleted ids returned {back}")
        check(np.isfinite(dist).all(), f"{name}: non-finite d")
        check(rec >= MIN_RECALL, f"{name}: recall {rec} < {MIN_RECALL}")
        check(back == 0, f"{name}: {back} deleted ids returned")
        out[f"join_{name}_s"], out[f"join_{name}_search_s"] = (
            sec, acc["search"])
        out[f"join_{name}_recall"] = rec
        return ids, dist

    launches, plain = fb.fused_beam_search.launches, fb.beam_search_plain.calls
    lateral("ef64", want)
    check(fb.fused_beam_search.launches + fb.beam_search_plain.calls
          > launches + plain, "the lateral join did not run the fused beam")
    sql("SET hnsw_ef_search = 160")
    steps = port_graph.beam_search.steps
    launches, plain = fb.fused_beam_search.launches, fb.beam_search_plain.calls
    lateral("ef160", want)
    check(port_graph.beam_search.steps > steps
          and fb.fused_beam_search.launches == launches
          and fb.beam_search_plain.calls == plain,
          "ef 160 did not run the step-by-step beam alone")
    sql("SET hnsw_ef_search = 0")

    # 5. min_by, a filter over the index scan, and the brute-force paths
    qv = q[1]
    lit = vec_literal(qv)
    scan_ids = sql(topk_stmt(qv))["id"]
    res = sql(f"SELECT min_by(id, array_distance(vec, {lit}), {k}) AS ids "
              "FROM items")
    check(list(res["ids"][0]) == scan_ids.tolist(),
          f"min_by {list(res['ids'][0])} != the scan's {scan_ids.tolist()}")
    filt = topk_stmt(qv, where="WHERE id % 2 = 0 ")
    plan = sql("EXPLAIN " + filt)
    check(plan.index("FILTER") < plan.index("HNSW_INDEX_SCAN"),
          f"no filter over the index scan:\n{plan}")
    even = sql(filt)["id"]
    check(len(even) > 0 and bool((even % 2 == 0).all()),
          f"WHERE id % 2 = 0 gave {even.tolist()}")
    cos = topk_stmt(qv, fn="array_cosine_distance")
    check("FLAT_TOPN_SCAN" in sql("EXPLAIN " + cos), "no flat scan for cosine")
    res, out["flat_cosine_s"] = timed(dev, lambda: sql(cos))
    err_cos = within_ties(res["id"], res["d"], exact_scores(vecs, qv, "cos"),
                          k, 5 * d * 2.0 ** -24, "cosine flat scan")
    sql("PRAGMA disable_optimizer")
    plan = sql("EXPLAIN " + topk_stmt(qv))
    check("TOP_N" in plan and "HNSW_INDEX_SCAN" not in plan,
          f"the optimizer was not off:\n{plan}")
    res, out["host_topn_s"] = timed(dev, lambda: sql(topk_stmt(qv)))
    exact = exact_scores(vecs, qv, "l2")
    err_l2 = within_ties(res["id"], res["d"], exact, k,
                         f32_rel * float(exact.max()), "host TopN")
    sql("PRAGMA enable_optimizer")
    log(f"# path 4 min_by = the scan's ids; filter kept {len(even)} even ids;"
        f" cosine FLAT_TOPN_SCAN {out['flat_cosine_s']:.2f} s (first, builds"
        f" the flat block), host TopN {out['host_topn_s']:.2f} s: both exact"
        f" within ties (max |d - exact| {err_cos:.2e}, {err_l2:.2e})")
    if dev.type == "cuda":
        n_kernels = profile_on_card("one projected SELECT (index scan)",
                                    lambda: sql(topk_stmt(q[2])), smi)
        check(n_kernels > 0, "the projected SELECT launched no CUDA kernel")

    # 6. DELETE, then compact
    dead = np.arange(0, n, 10)
    n_del, out["delete_s"] = timed(dev, lambda: sql(
        "DELETE FROM items WHERE id % 10 = 0"))
    check(n_del == len(dead), f"deleted {n_del} rows")
    live = np.setdiff1d(np.arange(n), dead)
    want_live = truth(live, vecs[live], q)

    def gone(ids):
        return np.isin(ids, dead)

    lateral("deleted", want_live, removed=gone)
    _, out["compact_s"] = timed(dev, lambda: sql(
        "PRAGMA hnsw_compact_index('items_idx')"))
    info = sql("SELECT * FROM pragma_hnsw_index_info()")
    n_rows = sql("SELECT count(*) AS n FROM items")["n"][0]
    check(int(info["count"][0]) == n_rows == len(live)
          and info["levels"][0][0]["nodes"] == len(live),
          f"index count {info['count'][0]} vs table {n_rows}")
    ids_c, dist_c = lateral("compacted", want_live,
                            removed=gone)
    log(f"# path 4 DELETE {n_del} rows on {smi}: {out['delete_s']:.2f} s; "
        f"compact {out['compact_s']:.2f} s; hnsw_index_info count "
        f"{info['count'][0]} = table rows {n_rows}")

    # 7. CHECKPOINT, reopen, insert into the WAL, reopen with replay
    acc = {}
    with clocked(acc, dev, (engine, "_serialize_table", "tables")):
        _, out["checkpoint_s"] = timed(dev, lambda: sql("CHECKPOINT"))
    size = sql("SELECT * FROM pragma_database_size()")
    log(f"# path 4 CHECKPOINT on {smi}: {out['checkpoint_s']:.2f} s (table "
        f"serialization {acc['tables']:.2f} s); pragma_database_size "
        + json.dumps({c: int(v[0]) for c, v in size.items()}))

    def reopen(name):
        nonlocal db
        db.wal.close()
        del db
        gc.collect()
        acc = {}
        with clocked(acc, dev, (engine, "restore_table", "tables"),
                     (HNSWIndex, "add", "replay_insert")):
            db, sec = timed(dev, lambda: open_database(path, device=dev))
        out[f"reopen_{name}_s"] = sec
        out[f"reopen_{name}_tables_s"] = acc["tables"]
        out[f"reopen_{name}_replay_insert_s"] = acc["replay_insert"]
        log(f"# path 4 reopen ({name}) on {smi}: {sec:.2f} s (table rows "
            f"restored in {acc['tables']:.2f} s, WAL inserts replayed into "
            f"the index in {acc['replay_insert']:.2f} s)")

    reopen("checkpoint")
    ids_r, dist_r = lateral("reopened", want_live,
                            removed=gone)
    check(np.array_equal(ids_r, ids_c) and np.array_equal(dist_r, dist_c),
          f"after the reopen {int((ids_r != ids_c).sum())} keys and "
          f"{int((dist_r != dist_c).sum())} distances differ")
    new_ids = np.arange(n, n + len(new), dtype=np.int64)
    _, out["insert_s"] = timed(dev, lambda: db.table("items").insert(
        {"id": new_ids, "vec": new}))
    log(f"# path 4 after the reopen: the lateral join equals the one before "
        f"the close, key for key and distance for distance; INSERT of "
        f"{len(new)} rows {out['insert_s']:.2f} s (WAL "
        f"{os.path.getsize(wal_path) / 2**20:.0f} MiB)")
    reopen("replay")
    check(len(db.indexes["items_idx"].index) == len(live) + len(new),
          "the replay did not restore the inserted rows")
    sql(f"CREATE TABLE fresh (fid BIGINT, fvec FLOAT[{d}])")
    db.table("fresh").insert({"fid": new_ids, "fvec": new})
    res = sql("SELECT fid, id FROM fresh, LATERAL (SELECT id FROM items "
              "ORDER BY array_distance(items.vec, fresh.fvec) LIMIT 1)")
    out["self_recall"] = float(np.mean(res["id"] == res["fid"]))
    all_keys = np.r_[live, new_ids]
    lateral("replayed", truth(all_keys, np.concatenate([vecs[live], new]), q),
            removed=gone)
    log(f"# path 4 replayed rows at rank 1 of their own search: "
        f"{out['self_recall']:.4f}")
    check(out["self_recall"] >= MIN_SELF_RECALL,
          f"self-recall {out['self_recall']} < {MIN_SELF_RECALL}")
    db.wal.close()
    return out


def second_build(idx, vecs, keys, q, kw, smi):
    """The same rows bulk-built a second time on the same seed: every
    graph array and n_distances must equal the first build's, and K1 at
    the search chunk's shape must return the same beams and n_dist on
    both builds' tables (and agree with its plain version on the
    second's). Returns (K1's largest score difference from its plain
    version, the second index, its int8 layout built, for path 2's
    second insert)."""
    import torch

    from duckdb_vss_tpu_torch.models.graph import GraphState
    from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex
    from duckdb_vss_tpu_torch.ops.fused_beam import fused_beam_search

    again = HNSWIndex(idx.dims, idx.config, capacity=len(vecs),
                      device=idx.device)
    t0 = time.perf_counter()
    again.add(vecs, keys)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    phases = {p: round(s, 3)
              for p, s in again.build_stats["phase_s"].items()}
    differ = [f for f in GraphState._fields
              if not torch.equal(getattr(idx.graph, f),
                                 getattr(again.graph, f))]
    nd1, nd2 = (ix.build_stats["n_distances"] for ix in (idx, again))
    log(f"# second build on {smi}, same rows and seed: {build_s:.2f} s, "
        f"phases {phases}; arrays that differ from the first build: "
        f"{differ or 'none'}; n_distances {nd2} (first {nd1})")
    check(not differ, f"a second build on one seed differs in {differ}")
    check(nd1 == nd2, f"a second build counted {nd2} distances, not {nd1}")
    args2 = path_beam_inputs(again, q[:TIMED_B], 64)
    first = fused_beam_search(*path_beam_inputs(idx, q[:TIMED_B], 64), **kw)
    second = fused_beam_search(*args2, **kw)
    log(f"# K1 at B={TIMED_B} on both builds' tables: n_dist "
        f"{int(first[2])} and {int(second[2])}")
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          "K1 differs between the two builds' tables")
    return compare_beam("1M-l2sq-search-chunk-second-build", args2,
                        kw), again


def second_insert(idx, again, new, new_keys, q, kw, smi, steps_first):
    """Path 2's insert once more, into ``again`` (second_build's index
    of the same rows on the same seed): every graph array, the store,
    the int8 tables and meta rows, the distance count and the beam
    steps must equal those of path 2's insert into ``idx``, and K1 at
    the search chunk's shape must return the same beams and n_dist on
    both indexes' tables. The counts of the kernels and of the beam's
    steps are restored after (this is a check, not path 2). Returns the
    insert's seconds."""
    import numpy as np
    import torch

    from duckdb_vss_tpu_torch.models import graph as port_graph
    from duckdb_vss_tpu_torch.models.graph import GraphState
    from duckdb_vss_tpu_torch.ops import fused_beam as fb
    from duckdb_vss_tpu_torch.ops import fused_gather as fg

    counters = ((fb.fused_beam_search, "launches"),
                (fb.beam_search_plain, "calls"),
                (fg.gather_scores_kernel, "launches"),
                (fg.gather_scores_plain, "calls"),
                (port_graph.beam_search, "steps"))
    saved = [getattr(fn, name) for fn, name in counters]
    check("nbr" in again.tables.built,
          "the second build has no int8 layout before its insert")
    _, insert_s = timed(again.device, lambda: again.add(new, new_keys))
    steps = port_graph.beam_search.steps - saved[-1]
    differ = [f for f in GraphState._fields
              if not torch.equal(getattr(idx.graph, f),
                                 getattr(again.graph, f))]
    differ += [f"store.{f}" for f in ("_vectors", "_vec_sq", "_valid")
               if not torch.equal(getattr(idx.store, f),
                                  getattr(again.store, f))]
    if not np.array_equal(idx.store._keys, again.store._keys):
        differ.append("store._keys")
    differ += [name for name, a, b in zip(
        ("nbr_vecs", "nbr_scale", "nbr_sq", "nbr_meta"),
        idx.tables.built["nbr"], again.tables.built["nbr"])
        if not torch.equal(a, b)]
    nd1, nd2 = idx.build_distance_count, again.build_distance_count
    first = fb.fused_beam_search(*path_beam_inputs(idx, q[:TIMED_B], 64),
                                 **kw)
    second = fb.fused_beam_search(*path_beam_inputs(again, q[:TIMED_B], 64),
                                  **kw)
    for (fn, name), value in zip(counters, saved):
        setattr(fn, name, value)
    log(f"# second insert on {smi}: the same {len(new)} rows into the second "
        f"build in {insert_s:.2f} s ({steps} beam steps, the first insert "
        f"{steps_first}); arrays that differ from the first insert's: "
        f"{differ or 'none'}; distance counts {nd2} (first {nd1}); K1 at "
        f"B={TIMED_B} on both: n_dist {int(first[2])} and {int(second[2])}")
    check(not differ, f"two inserts on one seed differ in {differ}")
    check(steps == steps_first, f"the second insert took {steps} beam "
          f"steps, the first {steps_first}")
    check(nd1 == nd2, f"the second insert counted {nd2} distances, not {nd1}")
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          "K1 differs between the two inserts' tables")
    return insert_s


def path6(idx, q, want, smi, search_ms, k=K):
    """The entry module on the card. (a) entry(): its step over its own
    512 x 64 index (recall@10 against the exact scan of the 512 rows);
    (b) the same step over idx (its graph, store, bf16 traversal copy
    and upper table) for the queries in chunks of TIMED_B (recall@10
    against ``want``) and its device time for one chunk; (c)
    dryrun_multichip(4) and (8), whose asserts are its checks. Returns
    the measured values."""
    import numpy as np
    import torch

    from duckdb_vss_tpu_torch import entry as port_entry
    from duckdb_vss_tpu_torch.models import graph as port_graph
    from duckdb_vss_tpu_torch.ops.fused_beam import fused_beam_search
    from duckdb_vss_tpu_torch.utils.timing import device_time

    out = {}
    # (a) entry() as a caller gets it, on the card
    t0 = time.perf_counter()
    fn, args = port_entry.entry()
    scores, ids, _ = fn(*args)
    s, i = scores.cpu().numpy(), ids.cpu().numpy()
    out["a_s"] = time.perf_counter() - t0
    valid = args[3].cpu().numpy()
    rows = args[1].cpu().numpy().astype(np.float64)
    qa = args[4].cpu().numpy().astype(np.float64)
    d2 = ((qa[:, None, :] - rows[None, valid, :]) ** 2).sum(-1)
    exact = np.nonzero(valid)[0][np.argsort(d2, axis=1, kind="stable")[:, :k]]
    out["a_recall"] = recall_of(i, exact, k)
    log(f"# path 6 (a) entry() on {smi}: scores {s.shape}, ids {i.shape}, "
        f"recall@{k} {out['a_recall']:.4f} against the exact scan of "
        f"{int(valid.sum())} rows ({out['a_s']:.2f} s with the build)")
    check(s.shape == i.shape == (8, k), "(6a): result shapes")
    check(bool((s[:, 1:] >= s[:, :-1]).all()), "(6a): scores do not ascend")
    check(bool((i >= 0).all()), "(6a): missing ids")
    check(out["a_recall"] >= MIN_RECALL,
          f"(6a): recall {out['a_recall']} < {MIN_RECALL}")
    # (b) the same step at full width, on the 1M index of path 1
    st = idx.store
    trav = idx.tables.traversal()
    uv, uvsq, unode = idx.tables.upper()

    def step(qd):
        return fn(idx.graph, st._vectors, st._vec_sq, st._valid, qd, trav,
                  uv, uvsq, unode)

    steps0 = port_graph.beam_search.steps
    t0 = time.perf_counter()
    got = [step(st.prepare_queries(q[c:c + TIMED_B]))[1].cpu().numpy()
           for c in range(0, len(q), TIMED_B)]
    out["b_s"] = time.perf_counter() - t0
    slots = np.concatenate(got)
    check(trav.dtype == torch.bfloat16 and (slots >= 0).all(),
          "(6b): bf16 traversal copy, every id found")
    out["b_recall"] = recall_of(st._keys[slots], want, k)
    out["b_steps"] = port_graph.beam_search.steps - steps0
    qd = st.prepare_queries(q[:TIMED_B])
    out["b_ms"] = device_time(lambda: step(qd), iters=3) * 1e3
    log(f"# path 6 (b) the entry's step on path 1's index on {smi}: "
        f"{len(q)} queries in {out['b_s']:.3f} s, recall@{k} "
        f"{out['b_recall']:.4f} ({out['b_steps']} beam steps); "
        f"{out['b_ms']:.2f} ms per {TIMED_B} queries on the card, against "
        f"{search_ms:.2f} ms for path 1's fused search")
    check(out["b_recall"] >= MIN_RECALL,
          f"(6b): recall {out['b_recall']} < {MIN_RECALL}")
    # (c) the sharded lifecycle on 2 and 4 shards of the card, then on
    # grids of card slots: (q 2, shard 2) and (q 2, shard 4)
    for n in (4, 8):
        for label, devices in (("", None), ("grid", card_slots(n))):
            k1_before = fused_beam_search.launches
            t0 = time.perf_counter()
            port_entry.dryrun_multichip(n, devices=devices)
            out[f"c{n}{label}_s"] = time.perf_counter() - t0
            out[f"c{n}{label}_k1"] = fused_beam_search.launches - k1_before
        log(f"# path 6 (c) dryrun_multichip({n}) on the slots "
            f"{card_slots(n)}: K1 launches {out[f'c{n}grid_k1']} (one per "
            f"slot per search), {out[f'c{n}grid_s']:.2f} s")
    return out


def dryrun_kernel_checks():
    """K1 against its plain version at the shapes dryrun_multichip(4)
    and (8) give it, on the one-device mesh and on the grid of card
    slots: the dry run's index built again as sharded_lifecycle builds
    it, on each of its shards in every replica row, after the first add
    (capacity 1024) and after remove, compact, reserve(2048) and the
    second add; the queries of the search that follows each (4 and 2
    rows, padded to 8 rows as the search pads them; on a grid of two
    replica rows, row 0's block of 4), at the search's ef_local, its
    expand of 4 and search_graph's step count for that ef. Returns the
    largest score difference."""
    import numpy as np

    from duckdb_vss_tpu_torch import entry as port_entry
    from duckdb_vss_tpu_torch.parallel.sharded import (ShardedHNSWIndex,
                                                       ef_local_policy)

    err = 0.0
    for n in (4, 8):
        for label, devices in (("", None), ("-grid", card_slots(n))):
            grown, vecs, keys, extra = port_entry.sharded_lifecycle(
                n, devices=devices)
            fresh = ShardedHNSWIndex(grown.dims, grown.config, grown.mesh,
                                     capacity_per_shard=1024, build_batch=32)
            fresh.add(vecs, keys)
            rows = len(grown.mesh.grid)
            for what, sh, qs, k in (("fresh", fresh, vecs[:4], 3),
                                    ("grown", grown, extra[:2], 1)):
                ef = ef_local_policy(32, k, sh.n_shards)
                kw = dict(ef=ef, expand=4, m0=sh.config.m0, d=sh.d_pad,
                          max_steps=max(8, ef // 2), metric=sh.config.metric)
                padded = np.zeros((8 // rows, sh.dims), np.float32)
                padded[:len(qs)] = qs[:8 // rows]
                for r in range(rows):
                    for j in range(len(sh.mesh.shards)):
                        err = max(err, compare_beam(
                            f"dryrun{n}{label}-{what}-cap{sh.cap}-row{r}-"
                            f"shard{j}",
                            sharded_beam_inputs(sh, padded, ef, shard=j,
                                                row=r), kw))
    return err


def sift_like(seed, n=N, nq=NQ, d=D):
    """The run's data from ``seed``: base rows, their centres, queries,
    and the generator (for rows drawn later)."""
    import numpy as np

    from duckdb_vss_tpu_torch.tools.build_peak import make_data

    rng = np.random.default_rng(seed)
    vecs, centers = make_data(rng, n, d)
    q = (centers[rng.integers(0, len(centers), nq)]
         + 0.25 * rng.normal(size=(nq, d)).astype(np.float32))
    return vecs, centers, q, rng


def cpu_name() -> str:
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    return "an unnamed CPU"


def cpu_baseline_phase(idx, q, want, k=K, n_q=1000, ef=64):
    """The measured CPU baseline (utils/cpu_baseline.py: native/
    cpu_hnsw.cpp compiled for this host), one query per thread on every
    core, over the index's own graph at ef: recall@k and QPS, recorded,
    not held to a floor. The graph is bulk-built for the mxu descent's
    exact seeding; the baseline's one-entry greedy descent finds fewer
    of the neighbours there, in the JAX package's binding alike
    (tests/test_torch_cpu_baseline.py). Returns what it measured."""
    import numpy as np

    from duckdb_vss_tpu_torch.utils import cpu_baseline

    out = {}
    t0 = time.perf_counter()
    cpu_baseline.get_lib()
    out["lib_s"] = time.perf_counter() - t0
    base = cpu_baseline.CPUBaseline(idx)
    ids, secs = base.search(q[:n_q], k, ef)
    check(ids.shape == (n_q, k) and (ids < len(base.vectors)).all(),
          "CPU baseline: ids out of range")
    keys = np.where(ids >= 0, idx.store._keys[ids.clip(0)], -1)
    out["recall"] = recall_of(keys, want[:n_q], k)
    out["qps"] = n_q / secs
    log(f"# CPU baseline on {cpu_name()}, {os.cpu_count()} threads, over "
        f"path 1's graph: {n_q} queries at ef {ef} = {out['qps']:.0f} QPS, "
        f"recall@{k} {out['recall']:.4f} (one entry node, greedy descent; "
        f"library built in {out['lib_s']:.1f} s)")
    return out


def sharded_beam_inputs(sh, queries_np, ef, shard=0, row=0):
    """K1's inputs exactly as the sharded search builds them for one of
    its shards in one replica row, on that shard's device (the
    search_graph default of 4 descent seeds)."""
    import torch

    from duckdb_vss_tpu_torch.models.graph import mxu_descent, seed_beam
    from duckdb_vss_tpu_torch.utils.padding import pad_2d_np

    check(sharded_layout_on(sh),
          "the sharded index runs without the int8 layout")
    tables = sh.search_tables()[(row, shard)]
    st, vectors, vec_sq = sh._source(shard, row)
    qd = torch.from_numpy(pad_2d_np(queries_np, len(queries_np),
                                    sh.d_pad)).to(vectors.device)
    q_sq = (qd * qd).sum(-1)
    metric = sh.config.metric
    seeds, _ = mxu_descent(*tables.upper, st.entry_node, qd, metric, 4)
    seed_s, seed_i = seed_beam(vectors, vec_sq, seeds, qd, q_sq, metric, ef)
    return (qd, q_sq, seed_s, seed_i, tables.meta, tables.tiles[0])


def sharded_layout_on(sh):
    """Whether every shard of every replica row searches through the
    int8 layout and K1 (its tables built on the way)."""
    return all(t.meta is not None for t in sh.search_tables().values())


def card_slots(n):
    """n slot names over the cards of this machine, in turn: on one card,
    n slots of cuda:0."""
    import torch

    return [f"cuda:{i % torch.cuda.device_count()}" for i in range(n)]


def search_memory(fn, devices):
    """Run fn once and return ({device: [GiB allocated before it, GiB
    allocated at its peak, GiB reserved at its peak]}, the current
    device's peak allocation before the call in GiB). The peak counters
    are reset for the call, so a caller that reports the peak of a
    longer span takes the larger of that and the later peak."""
    import torch

    devs = sorted({str(torch.device(d)) for d in devices})
    prior = torch.cuda.max_memory_allocated() / 2**30
    before = {}
    for d in devs:
        torch.cuda.synchronize(d)
        before[d] = torch.cuda.memory_allocated(d) / 2**30
        torch.cuda.reset_peak_memory_stats(d)
    fn()
    for d in devs:
        torch.cuda.synchronize(d)
    return {d: [before[d], torch.cuda.max_memory_allocated(d) / 2**30,
                torch.cuda.max_memory_reserved(d) / 2**30]
            for d in devs}, prior


def trace_names(log_dir):
    """(every event name, the kernel events' names) of the one trace
    file utils/tracing.trace wrote into log_dir."""
    import glob

    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    check(len(files) == 1, f"trace files in {log_dir}: {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    return names, kernels


def host_syncs(fn, phase=None):
    """Run fn under torch.cuda's sync debug mode and return where a
    synchronizing CUDA call was made: {"file:line": count}, a line inside
    torch followed by the innermost line of this checkout that reached
    it; with ``phase``, each key starts with what phase() returns at the
    sync ("<phase>: file:line")."""
    import collections
    import traceback
    import warnings

    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    seen = collections.Counter()

    def where(filename, lineno):
        return f"{filename.split('site-packages/')[-1]}:{lineno}" \
            if not filename.startswith(here) \
            else f"{os.path.relpath(filename, here)}:{lineno}"

    inside = [False]  # count only what fn itself makes

    def record(message, category, filename, lineno, file=None, line=None):
        if not inside[0] or "synchroniz" not in str(message):
            return
        at = where(filename, lineno)
        if not filename.startswith(here):
            mine = [f for f in traceback.extract_stack()
                    if f.filename.startswith(here)]
            if mine:
                at += " via " + where(mine[-1].filename, mine[-1].lineno)
        if phase is not None:
            at = f"{phase()}: {at}"
        seen[at] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            inside[0] = True
            fn()
            inside[0] = False
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(seen)


def shard_overlap(fn, tmp_dir):
    """Run fn once under torch.profiler and read its trace: the streams
    (of any card) that ran a K1 kernel are the shards' streams. Returns
    the wall span of their kernels, the sum of each stream's own span
    (equal to the wall span when the shards run one after another), the
    same two for K1's kernels alone, each shard stream's span
    (``shard_ms``), the kernels' busy time on those streams, in all and
    for each, and on the others (the merge), the copies by kind, and for
    each shard stream the host's window of the launches of its kernels
    (``host_issue_ms``) beside the window in which they ran
    (``device_run_ms``), both from the first shard kernel's launch, in
    ms; and the call's wall (host clock, the cards synchronized, the
    profiler's cost included), the union of all kernels' spans over it
    and the same without NCCL's kernels (which also wait there for the
    other ranks), NCCL's kernels and the host's collective calls
    (overlap_of)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(tmp_dir, "overlap.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return overlap_of(json.load(f)["traceEvents"], wall_ms)


def overlap_of(events, host_wall_ms):
    """shard_overlap's figures from a trace's events and the call's wall
    (``host_wall_ms``). ``busy_ms`` is the union of every kernel's span,
    ``busy_but_nccl_ms`` that of the kernels without "nccl" in their
    names, each also as a share of the wall; ``nccl_*`` are NCCL's
    kernels (a one-rank group launches none) and ``collective_calls``
    the host's operators named with "nccl" or "allgather", by count."""
    kern = [e for e in events if e.get("cat") == "kernel"]
    for e in kern:
        args = e.get("args", {})
        e["stream"] = (args.get("device"), args.get("stream"))
    k1_streams = {e["stream"] for e in kern
                  if "fused_beam" in e.get("name", "")}

    def spans(evs):
        by = {}
        for e in evs:
            by.setdefault(e["stream"], []).append(e)
        if not by:
            return 0.0, []
        part = [(max(e["ts"] + e["dur"] for e in v)
                 - min(e["ts"] for e in v)) / 1e3 for _, v in sorted(
                     by.items(), key=lambda kv: str(kv[0]))]
        wall = (max(e["ts"] + e["dur"] for e in evs)
                - min(e["ts"] for e in evs))
        return wall / 1e3, part

    shard_k = [e for e in kern if e["stream"] in k1_streams]
    out = {"streams": len(k1_streams)}
    out["wall_ms"], out["shard_ms"] = spans(shard_k)
    out["sum_of_shards_ms"] = sum(out["shard_ms"])
    out["k1_wall_ms"], k1_part = spans(
        [e for e in shard_k if "fused_beam" in e.get("name", "")])
    out["k1_sum_ms"] = sum(k1_part)
    out["shard_busy_ms"] = sum(e["dur"] for e in shard_k) / 1e3
    # the host's launch call of a kernel carries its correlation id
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    by = {}
    for e in shard_k:
        by.setdefault(e["stream"], []).append(e)
    streams = sorted(by, key=str)
    issued = {st: [launch_ts[e["args"]["correlation"]] for e in by[st]
                   if e.get("args", {}).get("correlation") in launch_ts]
              for st in streams}
    t0 = min((min(v) for v in issued.values() if v), default=0.0)
    out["busy_by_shard_ms"] = [sum(e["dur"] for e in by[st]) / 1e3
                               for st in streams]
    out["host_issue_ms"] = [[(min(issued[st]) - t0) / 1e3,
                             (max(issued[st]) - t0) / 1e3]
                            if issued[st] else None for st in streams]
    out["device_run_ms"] = [[(min(e["ts"] for e in by[st]) - t0) / 1e3,
                             (max(e["ts"] + e["dur"] for e in by[st])
                              - t0) / 1e3] for st in streams]
    out["merge_busy_ms"] = sum(e["dur"] for e in kern
                               if e["stream"] not in k1_streams) / 1e3

    def union_ms(evs):
        busy, end = 0.0, float("-inf")
        for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in evs):
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy / 1e3

    nccl = [e for e in kern if "nccl" in e.get("name", "").lower()]
    rest = [e for e in kern if "nccl" not in e.get("name", "").lower()]
    out["host_wall_ms"] = host_wall_ms
    out["busy_ms"] = union_ms(kern)
    out["busy_share"] = out["busy_ms"] / host_wall_ms
    out["busy_but_nccl_ms"] = union_ms(rest)
    out["busy_but_nccl_share"] = out["busy_but_nccl_ms"] / host_wall_ms
    out["nccl_kernels"] = len(nccl)
    out["nccl_ms"] = sum(e["dur"] for e in nccl) / 1e3
    out["nccl_names"] = sorted({e["name"] for e in nccl})
    calls = {}
    for e in events:
        name = e.get("name", "")
        low = name.lower().replace("_", "")
        if e.get("cat") in ("cpu_op", "user_annotation") and (
                "nccl" in low or "allgather" in low):
            calls[name] = calls.get(name, 0) + 1
    out["collective_calls"] = calls
    copies = {}
    for e in events:
        if e.get("cat") == "gpu_memcpy":
            name = e.get("name", "copy")
            n, ms = copies.get(name, (0, 0.0))
            copies[name] = (n + 1, ms + e["dur"] / 1e3)
    out["copies"] = {name: [n, round(ms, 4)] for name, (n, ms) in
                     copies.items()}
    return out


def path5(dev, vecs, q, want, smi, seed, single_qps, k=K, n_shards=4,
          cap=262_144):
    """Main path 5, the sharded index on the one card: (a) one process,
    4 shards of 1M x 128 bulk-built, searched at the default ef_local and
    at ef_local=64 (K1 once per shard per chunk), under tracing.trace;
    (b) remove, isolate, compact, stats, save and load; (d) the same
    rows in a grid of one card slot a shard (path5_grid), equal to (a)
    bit for bit; (e) NCCL ranks, one card each (path5_nccl); (c) two
    processes on the card in a gloo group, 2 shards each, and rank 0's
    file loaded here. Raises on any failed check; returns what it
    measured and the loaded index of (c)."""
    import numpy as np
    import torch

    from duckdb_vss_tpu_torch import HNSWConfig, MetricKind
    from duckdb_vss_tpu_torch.models.flat import FlatIndex
    from duckdb_vss_tpu_torch.ops import fused_beam as fb
    from duckdb_vss_tpu_torch.parallel.sharded import (ShardedHNSWIndex,
                                                       ef_local_policy,
                                                       make_mesh)
    from duckdb_vss_tpu_torch.utils import tracing
    from duckdb_vss_tpu_torch.utils.timing import device_time

    n, d = vecs.shape
    nq, out = len(q), {}
    here = os.path.dirname(os.path.abspath(__file__))
    build_dir = os.path.join(here, "build")
    os.makedirs(build_dir, exist_ok=True)
    keys = np.arange(n, dtype=np.int64)
    n_chunks = -(-nq // 8192)

    # (a) one process: four shards of the 1M rows
    mesh = make_mesh(n_shards, device=dev)
    sh = ShardedHNSWIndex(d, HNSWConfig(), mesh, capacity_per_shard=cap)
    _, out["build_s"] = timed(dev, lambda: sh.add(vecs, keys))
    shard_s = [round(sum(st["phase_s"].values()), 2) for st in sh.build_stats]
    log(f"# path 5 build on {smi}: {n} rows into {n_shards} shards in "
        f"{out['build_s']:.2f} s (bulk build per shard {shard_s} s); counts "
        f"{sh.counts.tolist()}, capacity per shard {sh.cap}")
    check(sh.cap == cap, f"the capacity grew to {sh.cap}: K1 would leave")
    _, out["layout_s"] = timed(dev, lambda: sh.search(q[:64], k))
    check(sharded_layout_on(sh),
          "the sharded search runs without the int8 layout")
    ef_def = ef_local_policy(sh.config.ef_search, k, n_shards)
    before = fb.fused_beam_search.launches
    (s_def, k_def), out["search_s"] = timed(dev, lambda: sh.search(q, k))
    launched = fb.fused_beam_search.launches - before
    out["recall_default"] = recall_of(k_def, want, k)
    (s64, k64), out["search_ef64_s"] = timed(
        dev, lambda: sh.search(q, k, ef_local=64))
    out["recall_ef64"] = recall_of(k64, want, k)
    log(f"# path 5 (a) on {smi}: {nq} queries at ef_local {ef_def} (the "
        f"default) in {out['search_s']:.3f} s = {nq / out['search_s']:.0f} "
        f"QPS, recall@{k} {out['recall_default']:.4f}; at ef_local 64 "
        f"{out['search_ef64_s']:.3f} s = {nq / out['search_ef64_s']:.0f} QPS,"
        f" recall@{k} {out['recall_ef64']:.4f}; the single index (path 1) "
        f"{single_qps:.0f} QPS; K1 launches in one search {launched} "
        f"({n_shards} shards x {n_chunks} chunks); int8 layout built in "
        f"{out['layout_s']:.2f} s")
    check(np.isfinite(s_def).all() and (k_def >= 0).all(),
          "(a): missing or non-finite results")
    check(launched == n_shards * n_chunks,
          f"(a): {launched} K1 launches, not one per shard per chunk")
    check(out["recall_default"] >= 0.90,
          f"(a): recall {out['recall_default']} < 0.90 at the default ef")
    check(out["recall_ef64"] >= MIN_RECALL,
          f"(a): recall {out['recall_ef64']} < {MIN_RECALL} at ef_local 64")
    with tempfile.TemporaryDirectory(dir=build_dir) as tb:
        with tracing.trace(tb):
            with tracing.annotate("sharded_search"):
                (_, k_tr), out["search_traced_s"] = timed(
                    dev, lambda: sh.search(q, k))
        names, kernels = trace_names(tb)
    k1_events = sorted(x for x in kernels if "fused_beam" in x)
    log(f"# path 5 (a) under tracing.trace on {smi}: "
        f"{out['search_traced_s']:.3f} s; region 'sharded_search' in the "
        f"trace: {'sharded_search' in names}; {len(kernels)} kernel names, "
        f"K1 as {k1_events[:1]}")
    check("sharded_search" in names, "the trace lacks the annotated region")
    check(bool(k1_events), "the trace holds no K1 kernel event")
    check(np.array_equal(k_tr, k_def), "the traced search differs")
    out["search_ms"] = device_time(lambda: sh.search(q[:TIMED_B], k),
                                   iters=5) * 1e3
    with tempfile.TemporaryDirectory(dir=build_dir) as tb:
        overlap_a = shard_overlap(lambda: sh.search(q[:TIMED_B], k), tb)
    mem_a, out["peak_before_gib"] = search_memory(
        lambda: sh.search(q[:TIMED_B], k), [dev])
    (out["a_resident_gib"], out["a_search_peak_gib"],
     out["a_search_reserved_gib"]) = mem_a[str(torch.device(dev))]
    log(f"# path 5 (a) on {smi}: {out['search_ms']:.2f} ms per search of "
        f"{TIMED_B} queries (host arrays in and out, CUDA events); its "
        f"shards on one stream under torch.profiler: "
        + json.dumps(overlap_a) + "; device memory (GiB allocated before "
        f"one search, allocated at its peak, reserved at its peak) "
        + json.dumps(mem_a))

    # (b) maintenance: remove every tenth key, isolate, compact, persist
    dead = keys[::10]
    live = np.setdiff1d(keys, dead)
    n_removed, out["remove_s"] = timed(dev, lambda: sh.remove(dead))
    check(n_removed == len(dead) and len(sh) == len(live),
          f"(b): removed {n_removed} of {len(dead)}")
    _, got = sh.search(q, k, ef_local=64)
    back = int(np.isin(got, dead).sum())
    _, out["isolate_s"] = timed(dev, sh.isolate)
    _, out["compact_s"] = timed(dev, sh.compact)
    stats = sh.stats()
    flat = FlatIndex(d, MetricKind.L2SQ, capacity=len(live), device=dev)
    flat.add(vecs[live], live)
    want_live = flat.search(q, k)[1]
    del flat
    (s_c, k_c), _ = timed(dev, lambda: sh.search(q, k, ef_local=64))
    out["recall_compacted"] = recall_of(k_c, want_live, k)
    log(f"# path 5 (b) on {smi}: removed {n_removed} in "
        f"{out['remove_s']:.3f} s (removed keys returned {back}); isolate "
        f"{out['isolate_s']:.3f} s, compact {out['compact_s']:.3f} s; stats "
        f"count {stats['count']} (shards "
        f"{[x['count'] for x in stats['shards']]}); recall@{k} at ef_local "
        f"64 {out['recall_compacted']:.4f}")
    check(back == 0, f"(b): {back} removed keys returned")
    check(stats["count"] == len(live)
          == sum(x["count"] for x in stats["shards"]),
          f"(b): stats count {stats['count']} != live {len(live)}")
    check(not np.isin(k_c, dead).any(), "(b): a removed key after compact")
    check(out["recall_compacted"] >= MIN_RECALL,
          f"(b): recall {out['recall_compacted']} < {MIN_RECALL}")
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        path = os.path.join(tmp, "sharded.vss")
        _, out["save_s"] = timed(dev, lambda: sh.save(path))
        size_mb = os.path.getsize(path) / 2**20
        loaded, out["load_s"] = timed(
            dev, lambda: ShardedHNSWIndex.load(path, mesh))
        with open(path, "rb") as f:
            digest_a = hashlib.sha256(f.read()).hexdigest()
    s_l, k_l = loaded.search(q, k, ef_local=64)
    log(f"# path 5 (b) persistence on {smi}: save {out['save_s']:.2f} s "
        f"({size_mb:.0f} MiB), load {out['load_s']:.2f} s; keys differing "
        f"{int((k_l != k_c).sum())}, scores {int((s_l != s_c).sum())}")
    check(np.array_equal(k_l, k_c) and np.array_equal(s_l, s_c),
          "(b): the loaded index searches differently")
    del sh, loaded
    torch.cuda.empty_cache()

    # (d) the grid: the same rows on the same seed, one slot a shard
    grid = path5_grid(dev, vecs, q, smi, n_shards, cap, n_chunks, dead,
                      dict(k_def=k_def, s_def=s_def, k64=k64, s64=s64,
                           ms=out["search_ms"], digest=digest_a,
                           overlap=overlap_a, memory=mem_a))
    out["peak_before_gib"] = max(out["peak_before_gib"],
                                 grid.pop("peak_before_gib"))
    out.update(grid)
    out.update(path5_replicas(dev, vecs, q, dead, k))

    # (e) NCCL ranks, one card a rank, the collectives on the cards
    out.update(path5_nccl(dev, vecs, q, smi, seed, n_shards, cap, n_chunks,
                          dict(k_def=k_def, s_def=s_def, k64=k64, s64=s64,
                               k_c=k_c, s_c=s_c, digest=digest_a,
                               ms=out["search_ms"], d_ms=out["d_ms"])))

    # (c) two processes on the card, two shards each
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        ranks, out["ranks_s"] = run_ranks(tmp, seed)
        (s0, k0), (s1, k1) = [(np.load(os.path.join(tmp, f"rank{r}.npz"))[x]
                               for x in ("scores", "keys")) for r in (0, 1)]
        check(np.array_equal(k0, k1) and np.array_equal(s0, s1),
              "(c): the two ranks returned different results")
        two, out["load_2p_s"] = timed(dev, lambda: ShardedHNSWIndex.load(
            os.path.join(tmp, "sharded.vss"), mesh))
    s2, k2 = two.search(q, k)
    out["recall_2p"] = recall_of(k0, want, k)
    log(f"# path 5 (c) on {smi}: 2 ranks on cuda:0 in {out['ranks_s']:.1f} "
        f"s; build per rank "
        f"{[round(r['build_s'], 2) for r in ranks]} s, search per rank "
        f"{[round(r['search_s'], 3) for r in ranks]} s, K1 launches per "
        f"rank {[r['k1_launches'] for r in ranks]}; recall@{k} "
        f"{out['recall_2p']:.4f}; rank 0's file loaded here ({n_shards} "
        f"shards, {out['load_2p_s']:.2f} s): keys differing "
        f"{int((k2 != k0).sum())}, scores {int((s2 != s0).sum())}; against "
        f"(a) keys differing {int((k0 != k_def).sum())}, scores "
        f"{int((s0 != s_def).sum())}")
    check(np.array_equal(k2, k0) and np.array_equal(s2, s0),
          "(c): the loaded file searches differently from the ranks")
    check(np.array_equal(k0, k_def) and np.array_equal(s0, s_def),
          "(c): two ranks built and searched differently from one process")
    check(all(r["k1_launches"] == 2 * n_chunks for r in ranks),
          "(c): a rank did not launch K1 once per shard per chunk")
    return out, two


def path5_grid(dev, vecs, q, smi, n_shards, cap, n_chunks, dead, a, k=K):
    """Path 5 (d): the 1M rows on the same seed in a grid of one slot a
    shard over the card slots (make_mesh(4, devices=...)), each slot
    searching on its own stream. Its keys and scores at ef_local 32 and
    64 must equal (a)'s (``a``) bit for bit, K1 must launch once per
    shard per chunk and its plain version never, and after (b)'s
    remove, isolate and compact its file must be byte-equal to (a)'s.
    Prints its ms per search beside (a)'s, the host syncs of a search,
    how much the shards' kernels overlap and the device memory of a
    search. Returns what it measured."""
    import numpy as np
    import torch

    from duckdb_vss_tpu_torch import HNSWConfig
    from duckdb_vss_tpu_torch.ops import fused_beam as fb
    from duckdb_vss_tpu_torch.parallel.sharded import (ShardedHNSWIndex,
                                                       make_mesh)
    from duckdb_vss_tpu_torch.utils.timing import device_time

    here = os.path.dirname(os.path.abspath(__file__))
    build_dir = os.path.join(here, "build")
    n, d = vecs.shape
    out = {}
    slots = card_slots(n_shards)
    mesh = make_mesh(n_shards, devices=slots)
    gs = ShardedHNSWIndex(d, HNSWConfig(), mesh, capacity_per_shard=cap)
    _, out["d_build_s"] = timed(dev, lambda: gs.add(vecs, np.arange(n)))
    check(gs.cap == cap, f"(d): the capacity grew to {gs.cap}")
    check(sharded_layout_on(gs), "(d): the grid runs without the int8 layout")
    gs.search(q[:64], k)
    results = {}
    for ef_local in (None, 64):
        k1, plain = fb.fused_beam_search.launches, fb.beam_search_plain.calls
        results[ef_local], out[f"d_search_{ef_local or 32}_s"] = timed(
            dev, lambda: gs.search(q, k, ef_local=ef_local))
        check(fb.fused_beam_search.launches - k1 == n_shards * n_chunks,
              f"(d): K1 launched {fb.fused_beam_search.launches - k1} "
              f"times, not once per shard per chunk ({n_shards} x "
              f"{n_chunks})")
        check(fb.beam_search_plain.calls == plain,
              "(d): K1's plain version ran")
    diff = {ef: (int((results[ef][1] != a[kk]).sum()),
                 int((results[ef][0] != a[ss]).sum()))
            for ef, kk, ss in ((None, "k_def", "s_def"), (64, "k64", "s64"))}
    out["d_ms"] = device_time(lambda: gs.search(q[:TIMED_B], k),
                              iters=5) * 1e3
    syncs = host_syncs(lambda: gs.search(q[:TIMED_B], k))
    with tempfile.TemporaryDirectory(dir=build_dir) as tb:
        overlap = shard_overlap(lambda: gs.search(q[:TIMED_B], k), tb)
    mem, out["peak_before_gib"] = search_memory(
        lambda: gs.search(q[:TIMED_B], k), slots)
    out["d_resident_gib"] = max(m[0] for m in mem.values())
    out["d_search_peak_gib"] = max(m[1] for m in mem.values())
    out["d_search_reserved_gib"] = max(m[2] for m in mem.values())
    log(f"# path 5 (d) the grid on {smi}: slots {slots}; build "
        f"{out['d_build_s']:.2f} s; {len(q)} queries at ef_local 32 in "
        f"{out['d_search_32_s']:.3f} s and at 64 in "
        f"{out['d_search_64_s']:.3f} s; keys and scores differing from (a) "
        f"at 32 {diff[None]}, at 64 {diff[64]}; K1 {n_shards} x {n_chunks} "
        f"launches a search, plain 0")
    log(f"# path 5 (d) on {smi}: {out['d_ms']:.2f} ms per search of "
        f"{TIMED_B} queries against (a)'s {a['ms']:.2f} ms (host arrays in "
        f"and out, CUDA events); host syncs in one search {syncs}; "
        f"under torch.profiler " + json.dumps(overlap) + " against (a)'s "
        + json.dumps(a["overlap"]) + "; device memory (GiB allocated "
        "before one search, allocated at its peak, reserved at its peak) "
        + json.dumps(mem) + " against (a)'s " + json.dumps(a["memory"]))
    check(diff[None] == (0, 0) and diff[64] == (0, 0),
          "(d): the grid's keys or scores differ from (a)'s")
    check(overlap["streams"] == n_shards,
          f"(d): K1 ran on {overlap['streams']} streams, not one a shard")
    gs.remove(dead)
    gs.isolate()
    gs.compact()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        path = os.path.join(tmp, "grid.vss")
        gs.save(path)
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
    log(f"# path 5 (d) on {smi}: after remove, isolate and compact the "
        f"file's sha256 {digest[:16]}, (a)'s {a['digest'][:16]}")
    check(digest == a["digest"], "(d): the grid's file differs from (a)'s")
    del gs
    torch.cuda.empty_cache()
    out["d_overlap"] = overlap["sum_of_shards_ms"] / max(
        overlap["wall_ms"], 1e-9)
    return out


@contextlib.contextmanager
def replica_sync_clock():
    """For the block's duration, the seconds that ShardedHNSWIndex
    spends in _sync_replicas (copying row 0 into the other replica
    rows), every card synchronized before and after each call; yields
    a one-element list that holds the sum."""
    import torch

    from duckdb_vss_tpu_torch.parallel.sharded import ShardedHNSWIndex

    spent = [0.0]
    sync = ShardedHNSWIndex._sync_replicas

    def all_cards():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    def clocked_sync(self, names=None):
        all_cards()
        t0 = time.perf_counter()
        sync(self, names)
        all_cards()
        spent[0] += time.perf_counter() - t0

    ShardedHNSWIndex._sync_replicas = clocked_sync
    try:
        yield spent
    finally:
        del ShardedHNSWIndex._sync_replicas


def path5_replicas(dev, vecs, q, dead, k=K, n_shards=2, n_q=2,
                   cap=524_288):
    """Path 5 (d), its replica rows: on a machine with four cards, the 1M
    rows on make_mesh(2, n_q=2, devices=card_slots(4)), one slot a card
    (replica row r's shard j on cuda:(2r + j)), against the same rows on
    make_mesh(2) on cuda:0, the reference ((a)'s steps at two shards:
    (a)'s four shards are other graphs). At ef_local 32 and 64 the
    grid's keys and scores must equal the reference's bit for bit, and
    each replica row, given the same queries (a chunk of two copies of
    4,096 queries: row 0 answers the first, row 1 the second), must
    return them too; K1 must launch once per shard per replica row per
    chunk and equal its plain version on shard 0 of row 1. The same
    after (b)'s remove, isolate and compact, whose file must be
    byte-equal to the reference's; the file loaded onto the grid must
    search as it did. Prints the seconds add, compact and load spend in
    _sync_replicas and the memory each card holds, beside each card's
    name and power limit. On fewer than four cards it logs why it did
    not run and returns {}. Returns what it measured."""
    import numpy as np
    import torch

    from duckdb_vss_tpu_torch import HNSWConfig, MetricKind
    from duckdb_vss_tpu_torch.ops import fused_beam as fb
    from duckdb_vss_tpu_torch.parallel.sharded import (ShardedHNSWIndex,
                                                       make_mesh)

    n, d = vecs.shape
    n_cards = torch.cuda.device_count()
    if n_cards < n_q * n_shards:
        log(f"# path 5 (d) replica rows: not run: the (q {n_q}, shard "
            f"{n_shards}) grid of the {n} rows takes one card a slot, "
            f"{n_q * n_shards} cards (two replicas of the int8 tables "
            f"exceed one card's budget), and this machine has {n_cards}; "
            f"run it with four cards")
        return {}
    here = os.path.dirname(os.path.abspath(__file__))
    build_dir = os.path.join(here, "build")
    os.makedirs(build_dir, exist_ok=True)
    smis = nvidia_smi_lines()
    keys = np.arange(n, dtype=np.int64)
    n_chunks = -(-len(q) // 8192)
    half = q[:4096]
    doubled = np.concatenate([half, half])
    out = {}

    def same(a, b):
        return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])

    ref = ShardedHNSWIndex(d, HNSWConfig(), make_mesh(n_shards, device=dev),
                           capacity_per_shard=cap)
    _, out["r_ref_build_s"] = timed(dev, lambda: ref.add(vecs, keys))
    check(ref.cap == cap and sharded_layout_on(ref),
          "replica rows: the reference left the int8 layout")
    slots = card_slots(n_q * n_shards)
    mesh = make_mesh(n_shards, n_q=n_q, devices=slots)
    gs = ShardedHNSWIndex(d, HNSWConfig(), mesh, capacity_per_shard=cap)
    with replica_sync_clock() as spent:
        _, out["r_build_s"] = timed(dev, lambda: gs.add(vecs, keys))
    out["r_sync_add_s"] = spent[0]
    check(gs.cap == cap and sharded_layout_on(gs),
          "replica rows: the grid left the int8 layout")
    gs.search(q[:64], k)
    out["r_card_gib"] = [torch.cuda.memory_allocated(i) / 2**30
                         for i in range(n_cards)]

    def compare(when):
        for ef in (32, 64):
            want = ref.search(q, k, ef_local=ef)
            k1 = fb.fused_beam_search.launches
            got, out[f"r_search_{when}_{ef}_s"] = timed(
                dev, lambda: gs.search(q, k, ef_local=ef))
            launched = fb.fused_beam_search.launches - k1
            rows = gs.search(doubled, k, ef_local=ef)
            row0 = tuple(x[:len(half)] for x in rows)
            row1 = tuple(x[len(half):] for x in rows)
            head = tuple(x[:len(half)] for x in want)
            log(f"# path 5 (d) replica rows after the {when}, ef_local "
                f"{ef}: {len(q)} queries in "
                f"{out[f'r_search_{when}_{ef}_s']:.3f} "
                f"s; keys and scores differing from the reference "
                f"{int((got[1] != want[1]).sum())}, "
                f"{int((got[0] != want[0]).sum())}; row 0 and row 1 on the "
                f"same {len(half)} queries equal each other {same(row0, row1)}"
                f" and the reference {same(row0, head)}; K1 launches "
                f"{launched}")
            check(same(got, want), f"replica rows after the {when}, "
                  f"ef_local {ef}: "
                  "the grid's keys or scores differ from the reference's")
            check(same(row0, head) and same(row1, head),
                  f"replica rows after the {when}, ef_local {ef}: a "
                  "replica row answers otherwise")
            check(launched == n_shards * n_q * n_chunks,
                  f"replica rows: K1 launched {launched} times, not once "
                  f"per shard per replica row per chunk ({n_shards} x "
                  f"{n_q} x {n_chunks})")

    plain = fb.beam_search_plain.calls
    compare("build")
    check(fb.beam_search_plain.calls == plain,
          "replica rows: K1's plain version ran")
    saved = (fb.fused_beam_search.launches, fb.beam_search_plain.calls)
    err = compare_beam("replica-row1-shard0-l2sq-ef32", sharded_beam_inputs(
        gs, q[:1024], 32, shard=0, row=1), dict(
            ef=32, expand=4, m0=gs.config.m0, d=gs.d_pad, max_steps=16,
            metric=MetricKind.L2SQ))
    fb.fused_beam_search.launches, fb.beam_search_plain.calls = saved
    out["r_k1_err"] = err
    for index in (ref, gs):
        index.remove(dead)
        index.isolate()
    ref.compact()
    with replica_sync_clock() as spent:
        _, out["r_compact_s"] = timed(dev, gs.compact)
    out["r_sync_compact_s"] = spent[0]
    compare("compact")
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        digests = []
        for name, index in (("ref", ref), ("grid", gs)):
            path = os.path.join(tmp, f"{name}.vss")
            index.save(path)
            with open(path, "rb") as f:
                digests.append(hashlib.sha256(f.read()).hexdigest())
        want = gs.search(q, k, ef_local=64)
        del gs
        with replica_sync_clock() as spent:
            loaded, out["r_load_s"] = timed(
                dev, lambda: ShardedHNSWIndex.load(path, mesh))
        out["r_sync_load_s"] = spent[0]
    got = loaded.search(q, k, ef_local=64)
    log(f"# path 5 (d) replica rows: file sha256 {digests[1][:16]}, the "
        f"reference's {digests[0][:16]}; loaded onto the grid, keys and "
        f"scores differing {int((got[1] != want[1]).sum())}, "
        f"{int((got[0] != want[0]).sum())}")
    check(digests[0] == digests[1],
          "replica rows: the grid's file differs from the reference's")
    check(same(got, want), "replica rows: the loaded grid searches otherwise")
    del loaded, ref
    torch.cuda.empty_cache()
    log(f"# path 5 (d) replica rows on {' / '.join(smis)}: slots {slots}; "
        f"build {out['r_build_s']:.2f} s (the reference on {dev} "
        f"{out['r_ref_build_s']:.2f} s); seconds in _sync_replicas: add "
        f"{out['r_sync_add_s']:.3f}, compact {out['r_sync_compact_s']:.3f} "
        f"(compact {out['r_compact_s']:.2f}), load {out['r_sync_load_s']:.3f}"
        f" (load {out['r_load_s']:.2f}); GiB allocated on each card after the"
        f" build and a search "
        + json.dumps([round(x, 3) for x in out["r_card_gib"]]))
    out["r_card_gib"] = max(out["r_card_gib"])
    return out


def path5_nccl(dev, vecs, q, smi, seed, n_shards, cap, n_chunks, a, k=K):
    """Path 5 (e): P processes in one "cpu:gloo,cuda:nccl" group, rank r
    on cuda:r with its block of the 4 shards, every cross-rank value
    gathered on the cards (nccl_rank). P is 4 on four cards or more, 2
    on two or three, 1 on one card, where the one rank still gathers
    through NCCL. Each rank's keys and scores must equal (a)'s (``a``)
    bit for bit at ef_local 32 and 64 and after remove, isolate and
    compact; rank 0's file must be byte-equal to (a)'s; each rank's
    sharded flat top-k must equal a one-process ShardedFlatIndex's on
    this card; K1 must launch S_local times a chunk on every rank, and
    equal its plain version on each rank's first shard (the rank
    checks). Rank 0's search may sync the host only for the queries'
    upload, before its first K1 launch and gather, and for the results'
    downloads, after its last. Prints rank 0's ms a search beside (a)'s
    and (d)'s, its card's busy time without NCCL's kernels and NCCL's
    kernels under torch.profiler, its host syncs, the first collective's
    seconds and each rank's build. Returns what it measured."""
    import numpy as np
    import torch

    from duckdb_vss_tpu_torch import MetricKind
    from duckdb_vss_tpu_torch.parallel.sharded import (ShardedFlatIndex,
                                                       make_mesh)

    here = os.path.dirname(os.path.abspath(__file__))
    n_cards = torch.cuda.device_count()
    world = 4 if n_cards >= 4 else 2 if n_cards >= 2 else 1
    s_local = n_shards // world
    flat = ShardedFlatIndex(vecs.shape[1], MetricKind.L2SQ,
                            make_mesh(n_shards, device=dev),
                            capacity_per_shard=cap)
    flat.add(vecs, np.arange(len(vecs)))
    flat_s, flat_k = flat.search(q, k)
    del flat
    torch.cuda.empty_cache()
    if world < 4:
        log(f"# path 5 (e) on {smi}: four NCCL ranks need four cards; this "
            f"machine has {n_cards}, so four ranks did not run: {world} "
            f"rank(s) run, one card each, through NCCL all the same")
    with tempfile.TemporaryDirectory(dir=os.path.join(here, "build")) as tmp:
        ranks, secs = run_ranks(tmp, seed, world=world, backend="nccl")
        got = []
        for r in range(world):
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
                got.append(dict(z))
        with open(os.path.join(tmp, "sharded.vss"), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
    r0 = ranks[0]
    diff = [{name: int((g[name] != want).sum()) for name, want in (
        ("k_def", a["k_def"]), ("s_def", a["s_def"]), ("k64", a["k64"]),
        ("s64", a["s64"]), ("k_c", a["k_c"]), ("s_c", a["s_c"]),
        ("flat_k", flat_k), ("flat_s", flat_s))} for g in got]
    log(f"# path 5 (e) on {smi}: {world} NCCL rank(s) (backend "
        f"{r0['backend']}), cards {[r['card'] for r in ranks]}, "
        f"{s_local} shard(s) a rank, {secs:.1f} s; init_process_group "
        f"{[round(r['init_s'], 3) for r in ranks]} s, the first collective "
        f"{[round(r['first_collective_s'], 3) for r in ranks]} s; build "
        f"{[round(r['build_s'], 2) for r in ranks]} s; K1 launches per "
        f"search per rank {[r['k1_launches'] for r in ranks]} (want "
        f"{s_local} x {n_chunks}); values differing from (a), (b) and the "
        f"one-process sharded flat scan, per rank {diff}; rank 0's file "
        f"sha256 {digest[:16]}, (a)'s {a['digest'][:16]}")
    log(f"# path 5 (e) on {smi}: rank 0 {r0['ms']:.2f} ms per search of "
        f"{TIMED_B} queries against (a)'s {a['ms']:.2f} and (d)'s "
        f"{a['d_ms']:.2f} (host arrays in and out, CUDA events); under "
        f"torch.profiler " + json.dumps(r0["profile"]) + "; host syncs in "
        f"one search {r0['host_syncs']}")
    for r, (rank, d) in enumerate(zip(ranks, diff)):
        check(all(v == 0 for v in d.values()),
              f"(e): rank {r}'s results differ from (a), (b) or the "
              f"one-process sharded flat scan: {d}")
        check(all(n == s_local * n_chunks for n in rank["k1_launches"]),
              f"(e): rank {r} launched K1 {rank['k1_launches']} times a "
              f"search, not {s_local} x {n_chunks}")
        check(rank["plain_calls"] == 0, f"(e): rank {r} ran K1's plain "
              "version in a search")
        check(rank["k3_total"] > 0 and rank["k3_plain_calls"] == 0,
              f"(e): rank {r} launched K3 {rank['k3_total']} times and ran "
              f"its plain version {rank['k3_plain_calls']} times")
    check(digest == a["digest"], "(e): rank 0's file differs from (a)'s")
    # the only host syncs of a search: the queries' upload, once a chunk
    # before any K1 launch or gather, and the scores' and ids' downloads,
    # once a chunk each after the last (a rank's grid is one row on one
    # card); the merge's two gathers a chunk
    chunks = r0["per_search"][0] // s_local
    by_phase = {}
    for at, n in r0["host_syncs"].items():
        by_phase[at.split(":")[0]] = by_phase.get(at.split(":")[0], 0) + n
    check(r0["per_search"] == [s_local * chunks, 2 * chunks]
          and by_phase == {"before": chunks, "after": 2 * chunks},
          f"(e): rank 0's search ran K1 and the gathers "
          f"{r0['per_search']} times and synced the host "
          f"{r0['host_syncs']}; want {s_local * chunks} and {2 * chunks}, "
          f"{chunks} sync(s) before them (the upload) and {2 * chunks} "
          "after (the downloads), none between")
    # the merge's two all-gathers ran through NCCL: on more than one
    # card as NCCL's all-gather kernels (with one rank NCCL copies)
    check(sum(n for name, n in r0["profile"]["collective_calls"].items()
              if "nccl" in name.lower()
              and "allgather" in name.lower().replace("_", "")) >= 2,
          "(e): rank 0's profile shows no NCCL all-gather call: "
          + json.dumps(r0["profile"]["collective_calls"]))
    if world > 1:
        check(any("allgather" in name.lower()
                  for name in r0["profile"]["nccl_names"]),
              "(e): no NCCL all-gather kernel in rank 0's profile")
    return {"e_ranks": world, "e_s": secs, "e_ms": r0["ms"],
            "e_busy_but_nccl_ms": r0["profile"]["busy_but_nccl_ms"],
            "e_busy_but_nccl_share": r0["profile"]["busy_but_nccl_share"],
            "e_nccl_ms": r0["profile"]["nccl_ms"],
            "e_first_collective_s": r0["first_collective_s"],
            "e_k1_err": max(r["k1_err"] for r in ranks),
            "e_k1_launches": [r["k1_total"] for r in ranks],
            "e_k2_launches": [r["k2_total"] for r in ranks],
            "e_k3_launches": [r["k3_total"] for r in ranks]}


def run_ranks(out_dir, seed, world=2, backend="gloo", timeout_s=600):
    """Start this script's --sharded-rank mode in ``world`` fresh
    processes (rank r on cuda:r under NCCL, all on the current card
    under gloo), wait for them and return (their results, seconds).
    The first rank to fail or the time limit stops every process; every
    process is stopped before this returns."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    part = "(e)" if backend == "nccl" else "(c)"
    cmd = [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
           "--world", str(world), "--port", str(port), "--out", out_dir,
           "--backend", backend]
    t0 = time.perf_counter()
    logs = [os.path.join(out_dir, f"rank{r}.log") for r in range(world)]
    files = [open(path, "w") for path in logs]
    procs = [subprocess.Popen(cmd + ["--sharded-rank", str(r)], stdout=f,
                              stderr=subprocess.STDOUT, text=True)
             for r, f in enumerate(files)]
    try:
        while (any(p.poll() is None for p in procs)
               and not any(p.returncode for p in procs)
               and time.perf_counter() - t0 < timeout_s):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    secs = time.perf_counter() - t0
    for r, (p, path) in enumerate(zip(procs, logs)):
        with open(path) as f:
            text = f.read()
        check(p.returncode == 0,
              f"{part}: rank {r} exited {p.returncode} after {secs:.0f} s "
              f"(limit {timeout_s} s):\n{text[-4000:]}")
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results, secs


def sharded_rank(opts) -> int:
    """One rank of path 5 (c): the run's 1M rows from --seed, this rank's
    block of the 4 shards on cuda:0 (a gloo group over --world
    processes), the bulk build, one search of the queries, and the
    sharded file (written by rank 0). Results go to --out. With
    --backend nccl, one rank of path 5 (e) (nccl_rank)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: a rank needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if opts.backend == "nccl":
        return nccl_rank(opts)
    from duckdb_vss_tpu_torch import HNSWConfig
    from duckdb_vss_tpu_torch.ops import fused_beam as fb
    from duckdb_vss_tpu_torch.parallel.sharded import (ShardedHNSWIndex,
                                                       make_mesh)

    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{opts.port}",
                            world_size=opts.world, rank=opts.sharded_rank)
    try:
        vecs, _, q, _ = sift_like(opts.seed)
        dev = torch.device("cuda")
        mesh = make_mesh(4, device=dev)
        sh = ShardedHNSWIndex(D, HNSWConfig(), mesh,
                              capacity_per_shard=262_144)
        _, build_s = timed(dev, lambda: sh.add(vecs, np.arange(len(vecs))))
        fb.fused_beam_search.launches = 0
        (scores, keys), search_s = timed(dev, lambda: sh.search(q, K))
        launches = fb.fused_beam_search.launches
        sh.save(os.path.join(opts.out, "sharded.vss"))
    finally:
        dist.destroy_process_group()
    r = opts.sharded_rank
    np.savez(os.path.join(opts.out, f"rank{r}.npz"), scores=scores,
             keys=keys)
    with open(os.path.join(opts.out, f"rank{r}.json"), "w") as f:
        json.dump({"build_s": build_s, "search_s": search_s,
                   "k1_launches": launches, "shards": list(mesh.shards),
                   "cap": sh.cap}, f)
    return 0


def nccl_rank(opts) -> int:
    """One rank of path 5 (e), on cuda:<rank> in a "cpu:gloo,cuda:nccl"
    group over --world processes (a timeout of RANK_TIMEOUT_S on every
    collective): the run's 1M rows from --seed, this rank's block of the
    4 shards on its card, the bulk build, the queries at the default
    ef_local and at 64, K1 against its plain version on its first
    shard, the measurements (ms a search, host syncs, torch.profiler),
    remove every tenth key, isolate, compact, a search at ef_local 64,
    save (rank 0 writes), then a ShardedFlatIndex of the same rows
    searched. Every rank makes the same calls in the same order, so the
    collectives meet. Results go to --out."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from duckdb_vss_tpu_torch import HNSWConfig, MetricKind
    from duckdb_vss_tpu_torch.ops import fused_beam as fb
    from duckdb_vss_tpu_torch.ops import fused_descent as fd
    from duckdb_vss_tpu_torch.ops import fused_gather as fg
    from duckdb_vss_tpu_torch.parallel import sharded as tsh
    from duckdb_vss_tpu_torch.utils.timing import device_time

    r = opts.sharded_rank
    torch.cuda.set_device(r)
    card = torch.device("cuda", r)
    out, res = {"card": str(card)}, {}
    t0 = time.perf_counter()
    dist.init_process_group(
        "cpu:gloo,cuda:nccl", init_method=f"tcp://127.0.0.1:{opts.port}",
        world_size=opts.world, rank=r, device_id=card,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    out["init_s"] = time.perf_counter() - t0
    out["backend"] = str(dist.get_backend())
    try:
        vecs, _, q, _ = sift_like(opts.seed)
        keys = np.arange(len(vecs), dtype=np.int64)
        mesh = tsh.make_mesh(4, device=card)
        check(mesh.collectives == "card",
              f"rank {r}: the mesh gathers on the {mesh.collectives}")
        _, out["first_collective_s"] = timed(card, lambda: (
            tsh.all_gather_on_device(mesh, torch.zeros(1, device=card))))
        sh = tsh.ShardedHNSWIndex(D, HNSWConfig(), mesh,
                                  capacity_per_shard=262_144)
        _, out["build_s"] = timed(card, lambda: sh.add(vecs, keys))
        check(sh.cap == 262_144, f"rank {r}: the capacity grew to {sh.cap}")
        sh.search(q[:64], K)  # builds the int8 layout
        fb.fused_beam_search.launches = fb.beam_search_plain.calls = 0
        fg.gather_scores_kernel.launches = 0
        launches, plain = [], [0]

        def counted(fn):
            k1, p = fb.fused_beam_search.launches, fb.beam_search_plain.calls
            got = fn()
            launches.append(fb.fused_beam_search.launches - k1)
            plain[0] += fb.beam_search_plain.calls - p
            return got

        res["s_def"], res["k_def"] = counted(lambda: sh.search(q, K))
        res["s64"], res["k64"] = counted(
            lambda: sh.search(q, K, ef_local=64))
        n_main = fb.fused_beam_search.launches  # the check's launch aside
        out["k1_err"] = compare_beam(
            f"(e) rank {r}, shard {mesh.shards.start} on {card}, ef 32",
            sharded_beam_inputs(sh, q[:1024], 32),
            dict(ef=32, expand=4, m0=sh.config.m0, d=sh.d_pad,
                 max_steps=16, metric=MetricKind.L2SQ))
        fb.fused_beam_search.launches = n_main
        qt = q[:TIMED_B]
        out["ms"] = device_time(lambda: sh.search(qt, K), iters=5) * 1e3
        # where a search's host syncs fall: before its first K1 launch
        # and gather, after its last, or between (none may be)
        gathers, real_gather = [0], dist.all_gather_into_tensor

        def gather(*args, **kw):
            gathers[0] += 1
            return real_gather(*args, **kw)

        dist.all_gather_into_tensor = gather
        try:
            k1 = fb.fused_beam_search.launches
            sh.search(qt, K)
            out["per_search"] = per = [fb.fused_beam_search.launches - k1,
                                       gathers[0]]
            k1, gathers[0] = fb.fused_beam_search.launches, 0

            def phase():
                now = [fb.fused_beam_search.launches - k1, gathers[0]]
                return ("before" if now == [0, 0] else
                        "after" if now == per else "between")

            out["host_syncs"] = host_syncs(lambda: sh.search(qt, K), phase)
        finally:
            dist.all_gather_into_tensor = real_gather
        with tempfile.TemporaryDirectory(dir=opts.out) as tb:
            out["profile"] = shard_overlap(lambda: sh.search(qt, K), tb)
        sh.remove(keys[::10])
        sh.isolate()
        sh.compact()
        res["s_c"], res["k_c"] = counted(
            lambda: sh.search(q, K, ef_local=64))
        sh.save(os.path.join(opts.out, "sharded.vss"))
        out["k1_launches"], out["plain_calls"] = launches, plain[0]
        del sh
        torch.cuda.empty_cache()
        flat = tsh.ShardedFlatIndex(D, MetricKind.L2SQ, mesh,
                                    capacity_per_shard=262_144)
        flat.add(vecs, keys)
        res["flat_s"], res["flat_k"] = flat.search(q, K)
        out["k1_total"] = fb.fused_beam_search.launches
        out["k2_total"] = fg.gather_scores_kernel.launches
        out["k3_total"] = fd.fused_descent.launches
        out["k3_plain_calls"] = fd.fused_descent_plain.calls
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(opts.out, f"rank{r}.npz"), **res)
    with open(os.path.join(opts.out, f"rank{r}.json"), "w") as f:
        json.dump(out, f)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1234)
    # path 5 (c) and (e) start this script again, once per rank, with these
    ap.add_argument("--sharded-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                    help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=2, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    if opts.sharded_rank is not None:
        return sharded_rank(opts)

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
    from duckdb_vss_tpu_torch.models import graph as port_graph
    from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex
    from duckdb_vss_tpu_torch.ops import cuda_build
    from duckdb_vss_tpu_torch.ops import fused_beam as fb
    from duckdb_vss_tpu_torch.ops import fused_descent as fd
    from duckdb_vss_tpu_torch.ops import fused_gather as fg
    from duckdb_vss_tpu_torch.tools import k1_phases
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
    build_logs = cuda_build.build([fb.KERNEL, fg.KERNEL, fd.KERNEL])
    log(f"# nvcc build of {os.path.relpath(fb.SOURCE, here)}, "
        f"{os.path.relpath(fg.SOURCE, here)} and "
        f"{os.path.relpath(fd.SOURCE, here)} (in parallel): "
        f"{time.perf_counter() - t0:.2f} s")
    for name, build_log in build_logs.items():
        for line in build_log.splitlines():
            if "ptxas" in line or "Used" in line or "spill" in line:
                log(f"#   {name}: {line.strip()}")

    # ---- 3. main path at full width -----------------------------------
    n, nq, d, k = N, NQ, D, K
    t0 = time.perf_counter()
    vecs, centers, q, rng = sift_like(opts.seed)
    keys = np.arange(n, dtype=np.int64)
    log(f"# data: {n} x {d} base, {nq} queries, seed {opts.seed}: "
        f"{time.perf_counter() - t0:.1f} s")

    config = HNSWConfig()  # M=16, M0=32, ef_construction=128, ef_search=64
    torch.cuda.reset_peak_memory_stats()

    def zero_counts():
        fb.fused_beam_search.launches = fb.beam_search_plain.calls = 0
        fg.gather_scores_kernel.launches = fg.gather_scores_plain.calls = 0
        fd.fused_descent.launches = fd.fused_descent_plain.calls = 0
        port_graph.beam_search.steps = 0

    zero_counts()
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
    k3_launches = fd.fused_descent.launches
    k3_plain_calls = fd.fused_descent_plain.calls
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    phases = {p: round(s, 3) for p, s in idx.build_stats["phase_s"].items()}
    log(f"# build: {build_s:.2f} s ({n / build_s:.0f} vec/s) phases {phases}")
    log(f"# layout (first search, 64 queries): {layout_s:.2f} s")
    log(f"# search: {nq} queries in {search_s:.3f} s = {nq / search_s:.0f} "
        f"QPS (host arrays in and out, ef_search {config.ef_search})")
    log(f"# K1 launches on the main path: {k1_launches}; plain version "
        f"calls: {plain_calls}; K3 launches {k3_launches}, its plain "
        f"version's calls {k3_plain_calls}; peak device memory "
        f"{peak_gb:.2f} GiB")

    flat = FlatIndex(d, MetricKind.L2SQ, capacity=n, device=dev)
    flat.add(vecs, keys)
    t0 = time.perf_counter()
    _, want = flat.search(q, k)
    flat_s = time.perf_counter() - t0
    recall = recall_of(got, want, k)
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
    check(k3_launches > 0, "the main path never launched kernel K3")
    check(k3_plain_calls == 0, "the main path ran K3's plain version")
    qd = idx.store.prepare_queries(q[:TIMED_B])
    dev_s = device_time(lambda: idx.search_device(qd, k), iters=5)
    log(f"# search_device ({TIMED_B} queries on the card): {dev_s * 1e3:.2f} "
        f"ms = {TIMED_B / dev_s:.0f} QPS")
    profile_on_card(f"search_device through K1, {TIMED_B} queries",
                    lambda: idx.search_device(qd, k), smi)
    cpu_baseline_phase(idx, q, want)

    # ---- 4. kernel check and timing -------------------------------------
    kw = dict(ef=64, expand=4, m0=config.m0, d=idx.store.d_pad,
              max_steps=32, metric=MetricKind.L2SQ)
    err = compare_beam("1M-l2sq", path_beam_inputs(idx, q[:1024], 64), kw)
    kw128 = dict(kw, ef=128, expand=8, max_steps=64)
    err = max(err, compare_beam("1M-l2sq-ef128-e8",
                                path_beam_inputs(idx, q[:1024], 128), kw128))
    err = max(err, early_exit_checks(path_beam_inputs(idx, q[:1024], 64), kw))
    errs = kernel_checks_random(dev)
    args = path_beam_inputs(idx, q[:TIMED_B], 64)
    err = max([err, compare_beam("1M-l2sq-search-chunk", args, kw)]
              + list(errs.values()))

    k_ms, bound_ms, bound_by, tiles_ms, tail = time_beam(args, kw)
    p_ms = device_time(lambda: fb.beam_search_plain(*args, **kw), iters=3) * 1e3
    log(f"# K1 on {smi} at B={TIMED_B}, ef 64, expand 4, 32 steps: "
        f"{k_ms:.3f} ms; plain {p_ms:.3f} ms; {tail}")
    clocks, shares = k1_phases.phase_shares(args, kw)
    log(f"# K1 phases at that shape ({clocks:.0f} clocks resident a block): "
        + ", ".join(f"{name} {share:.1%}" for name, share in shares.items()))
    search_stages(idx, qd, args, kw, k, dev_s * 1e3, k_ms)
    args = path_beam_inputs(idx, q[:TIMED_B], 128)
    k128_ms, _, _, _, tail = time_beam(args, kw128)
    log(f"# K1 on {smi} at B={TIMED_B}, ef 128, expand 8, 64 steps: "
        f"{k128_ms:.3f} ms; {tail}")
    del args

    # ---- 4a. K3, the fused descent, at the main path's shapes -------------
    upper = idx.tables.upper()
    # a batch chunk, the last chunk of a 10,000-query call, a statement
    k3_err = max(compare_descent(f"1M-l2sq-B{b}", qd[:b], *upper,
                                 MetricKind.L2SQ)
                 for b in (TIMED_B, nq % TIMED_B, 1))
    w3 = fd.block_warps(d, 8)
    smem3 = fd.smem_bytes(w3, d)
    s3 = fd.n_slices(TIMED_B, upper[0].shape[0], w3,
                     fd.resident_blocks(dev, w3, 8, smem3))
    log(f"# K3's plan at D={d}: {w3} warps a block, {smem3} bytes of "
        f"dynamic shared memory, {s3} slices at B={TIMED_B}")
    k3 = {}
    for b in (TIMED_B, 1):
        ms3, p_ms3, bound3, by3 = time_descent(qd[:b], *upper,
                                               MetricKind.L2SQ)
        k3[b] = dict(ms=ms3, plain_ms=p_ms3, bound_ms=bound3, bound_by=by3)
        log(f"# K3 on {smi} at B={b}, U={upper[0].shape[0]} "
            f"({int((upper[2] >= 0).sum())} live), D={d}, k 8: {ms3:.4f} ms;"
            f" plain {p_ms3:.3f} ms; bound {bound3:.4f} ms ({by3}), the "
            f"kernel at {bound3 / ms3:.1%} of it")
    del upper

    # ---- 4b. one graph per seed: the same rows built a second time -------
    err_second, again = second_build(idx, vecs, keys, q, kw, smi)
    err = max(err, err_second)

    # ---- 4c. main path 6: the entry module, on path 1's index -----------
    zero_counts()
    t0 = time.perf_counter()
    p6 = path6(idx, q, want, smi, dev_s * 1e3)
    k1_launches_6 = fb.fused_beam_search.launches
    k2_launches_6 = fg.gather_scores_kernel.launches
    k3_launches_6 = fd.fused_descent.launches
    p6["s"] = time.perf_counter() - t0
    log(f"# path 6 on {smi}: {p6['s']:.1f} s; K1 launches {k1_launches_6} "
        f"(dryrun_multichip(4): {p6['c4_k1']}, (8): {p6['c8_k1']}; on the "
        f"grids {p6['c4grid_k1']} and {p6['c8grid_k1']}), plain "
        f"version calls {fb.beam_search_plain.calls}; K2 launches "
        f"{k2_launches_6}; K3 launches {k3_launches_6}; measured "
        + json.dumps({name: round(v, 4) for name, v in p6.items()}))
    check(p6["c4_k1"] > 0 and p6["c8_k1"] > 0,
          "a dry run never launched K1")
    # four searches a dry run, each on every slot of the grid
    check(p6["c4grid_k1"] == 4 * 4 and p6["c8grid_k1"] == 4 * 8,
          "a dry run on the grid did not launch K1 once per slot per search")
    check(fb.beam_search_plain.calls == 0, "path 6 ran K1's plain version")
    check(fd.fused_descent_plain.calls == 0, "path 6 ran K3's plain version")
    err = max(err, dryrun_kernel_checks())

    # ---- 5. main path 2: incremental insert, then both searches ---------
    new = (centers[rng.integers(0, len(centers), N_INSERT)]
           + 0.25 * rng.normal(size=(N_INSERT, d)).astype(np.float32))
    new_keys = np.arange(n, n + N_INSERT, dtype=np.int64)
    again_gb = sum(t.numel() * t.element_size() for t in (
        list(again.graph) + [again.store._vectors, again.store._vec_sq,
                             again.store._valid]
        + list(again.tables.built["nbr"]))
                   ) / 2**30
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    idx.add(new, new_keys)
    torch.cuda.synchronize()
    insert_s = time.perf_counter() - t0
    insert_steps = port_graph.beam_search.steps
    n_batches = N_INSERT // idx.build_batch
    check("nbr" in idx.tables.built,
          "the insert ran without the int8 layout")
    log(f"# insert on {smi}: {N_INSERT} rows into {n} in {n_batches} batches "
        f"of {idx.build_batch}: {insert_s:.2f} s = {N_INSERT / insert_s:.0f} "
        f"vec/s, {insert_s / n_batches * 1e3:.1f} ms per batch "
        f"({insert_steps} beam steps)")
    # (a) the fused search: the old queries and the inserted rows
    q_all = np.concatenate([q, new])
    scores_a, got_a = idx.search(q_all, k)
    k1_launches_2 = fb.fused_beam_search.launches
    check(port_graph.beam_search.steps == insert_steps,
          "search (a) left the fused beam")
    flat.add(new, new_keys)
    _, want_all = flat.search(q_all, k)
    recall_a = recall_of(got_a, want_all, k)
    self_a = float((got_a[nq:, 0] == new_keys).mean())
    log(f"# (a) fused search after the insert: recall@{k} {recall_a:.4f} "
        f"over {len(q_all)} queries against the flat scan of {len(flat)} "
        f"rows; inserted rows at rank 1: {self_a:.4f}")
    check(np.isfinite(scores_a).all(), "(a): non-finite scores")
    check(recall_a >= MIN_RECALL, f"(a): recall {recall_a} < {MIN_RECALL}")
    check(self_a >= MIN_SELF_RECALL,
          f"(a): self-recall@1 {self_a} < {MIN_SELF_RECALL}")
    check(k1_launches_2 > 0, "(a): the fused search never launched K1")
    # (b) the flat layout: the step-by-step beam, scored by kernel K2
    idx.layout, idx.traversal_dtype, idx.use_pallas = "flat", "f32", True
    fb.fused_beam_search.launches = 0
    t0 = time.perf_counter()
    scores_b, got_b = idx.search(q, k)
    search_b_s = time.perf_counter() - t0
    k2_launches = fg.gather_scores_kernel.launches
    steps_b = port_graph.beam_search.steps - insert_steps
    k2_plain_calls = fg.gather_scores_plain.calls
    k1_in_b = fb.fused_beam_search.launches
    plain_calls_2 = fb.beam_search_plain.calls
    peak2_gb = torch.cuda.max_memory_allocated() / 2**30
    recall_b = recall_of(got_b, want_all[:nq], k)
    log(f"# (b) flat-layout search on {smi}: {nq} queries in "
        f"{search_b_s:.3f} s = {nq / search_b_s:.0f} QPS, recall@{k} "
        f"{recall_b:.4f}; K2 launches {k2_launches} over {steps_b} beam "
        f"steps; K2 plain calls {k2_plain_calls}; K1 launches {k1_in_b}")
    check(np.isfinite(scores_b).all() and (got_b >= 0).all(),
          "(b): missing or non-finite results")
    exact = ((q[:50, None, :] - np.concatenate([vecs, new])[got_b[:50]]) ** 2
             ).sum(-1)
    check(np.allclose(scores_b[:50], exact, rtol=1e-4, atol=1e-4),
          "(b): emitted distances are not the exact l2sq values")
    check(recall_b >= MIN_RECALL, f"(b): recall {recall_b} < {MIN_RECALL}")
    check(steps_b > 0 and k2_launches == steps_b,
          f"(b): {k2_launches} K2 launches for {steps_b} beam steps")
    check(k2_plain_calls == 0, "the main path ran K2's plain version")
    check(k1_in_b == 0, "(b): the flat-layout search launched K1")
    check(plain_calls_2 == 0, "the main path ran K1's plain version")
    check(fd.fused_descent_plain.calls == 0,
          "path 2 ran K3's plain version")
    k3_launches_2 = fd.fused_descent.launches
    check(k3_launches_2 > 0, "path 2 never launched K3")
    # K3 at the insert's shape: one batch of the inserted rows against
    # the whole upper-slot table, as insert_batch's phase B passes it
    # (mostly dead rows, no multiple of 16,384 in general)
    g = idx.graph
    u_safe = g.upper_node.clamp_min(0).long()
    k3_err = max(k3_err, compare_descent(
        f"insert-l2sq-B{idx.build_batch}",
        idx.store.prepare_queries(new[:idx.build_batch]),
        idx.store._vectors[u_safe].to(torch.bfloat16),
        idx.store._vec_sq[u_safe] * (g.upper_node >= 0), g.upper_node,
        MetricKind.L2SQ))
    del g, u_safe
    dev_b_s = device_time(lambda: idx.search_device(qd, k), iters=3)
    log(f"# (b) search_device on {smi} ({TIMED_B} queries on the card): "
        f"{dev_b_s * 1e3:.2f} ms = {TIMED_B / dev_b_s:.0f} QPS")
    profile_on_card(f"(b) search_device, {TIMED_B} queries",
                    lambda: idx.search_device(qd, k), smi)
    log(f"# path 2 peak device memory on {smi}: {peak2_gb:.2f} GiB, of "
        f"which the second build's index of 4b, held through it, "
        f"{again_gb:.2f} GiB: {peak2_gb - again_gb:.2f} GiB without it")
    idx.layout, idx.traversal_dtype, idx.use_pallas = "auto", "bf16", False
    del flat
    # ---- 5b. one graph per seed: the same insert into the second build ----
    second_insert(idx, again, new, new_keys, q, kw, smi, insert_steps)
    del again
    torch.cuda.empty_cache()

    # ---- 6. K2 against its plain version, and its time --------------------
    store = idx.store._vectors
    step_ids = beam_step_ids(idx, qd)
    check(tuple(step_ids.shape) == (TIMED_B, 4 * config.m0)
          and bool((step_ids < 0).any()), "beam step ids")
    errs2 = {m.value: compare_gather(f"1M-{m.value}", store, step_ids, qd, m)
             for m in (MetricKind.L2SQ, MetricKind.IP, MetricKind.COSINE)}
    err2 = max(list(errs2.values())
               + list(gather_checks_random(dev).values()))
    gather_rejects(dev)
    qd_sq = (qd * qd).sum(-1)
    g_args = (store, step_ids, qd, qd_sq, MetricKind.L2SQ)
    k2_ms = device_time(lambda: fg.gather_scores_kernel(*g_args),
                        iters=20) * 1e3
    p2_ms = device_time(lambda: fg.gather_scores_plain(*g_args),
                        iters=5) * 1e3
    bound2_ms, bound2_by, live2 = gather_bound_ms(step_ids, store.shape[1])
    log(f"# K2 on {smi} at ids [{TIMED_B}, {step_ids.shape[1]}] x "
        f"D={store.shape[1]}: {k2_ms:.3f} ms; plain {p2_ms:.3f} ms; bound "
        f"{bound2_ms:.4f} ms ({bound2_by}, {live2} live candidates); "
        f"{bound2_ms / k2_ms:.1%} of the bound")
    bb = idx.build_batch
    extra = (centers[rng.integers(0, len(centers), bb)]
             + 0.25 * rng.normal(size=(bb, d)).astype(np.float32))
    extra_keys = np.arange(bb) + 10**9
    profile_on_card(f"one insert batch of {bb} rows",
                    lambda: idx.add(extra, extra_keys), smi)

    # ---- 8. main path 3: the rest of the index surface, persistence ------
    def make_rows(m):
        return (centers[rng.integers(0, len(centers), m)]
                + 0.25 * rng.normal(size=(m, d)).astype(np.float32))

    zero_counts()
    t0 = time.perf_counter()
    p3 = path3(idx, np.concatenate([vecs, new]), extra_keys, q, n, want,
               make_rows, smi)
    k1_launches_3 = fb.fused_beam_search.launches
    k2_launches_3 = fg.gather_scores_kernel.launches
    k3_launches_3 = fd.fused_descent.launches
    log(f"# path 3 on {smi}: {time.perf_counter() - t0:.1f} s; K1 launches "
        f"{k1_launches_3}, plain version calls {fb.beam_search_plain.calls}"
        f"; K2 launches {fg.gather_scores_kernel.launches}; measured "
        + json.dumps({name: round(v, 4) for name, v in p3.items()}))
    check(k1_launches_3 > 0, "path 3 never launched K1")
    check(fb.beam_search_plain.calls == 0,
          "path 3 ran K1's plain version")
    check(k3_launches_3 > 0, "path 3 never launched K3")
    check(fd.fused_descent_plain.calls == 0,
          "path 3 ran K3's plain version")

    # ---- 9. main path 4: the SQL layer on a database on the card --------
    del idx, store, step_ids, g_args  # path 4 builds its own index
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(here, "build")) as tmp:
        p4 = path4(dev, vecs, q, want, new, smi, tmp)
    k1_launches_4 = fb.fused_beam_search.launches
    k2_launches_4 = fg.gather_scores_kernel.launches
    k3_launches_4 = fd.fused_descent.launches
    log(f"# path 4 on {smi}: {time.perf_counter() - t0:.1f} s; K1 launches "
        f"{k1_launches_4}, plain version calls {fb.beam_search_plain.calls}"
        f"; K2 launches {fg.gather_scores_kernel.launches}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        "measured " + json.dumps({name: round(v, 4)
                                  for name, v in p4.items()}))
    check(k1_launches_4 > 0, "path 4 never launched K1")
    check(fb.beam_search_plain.calls == 0,
          "path 4 ran K1's plain version")
    check(k3_launches_4 > 0, "path 4 never launched K3")
    check(fd.fused_descent_plain.calls == 0,
          "path 4 ran K3's plain version")

    # ---- 10. main path 5: the sharded index on the one card -------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    p5, two = path5(dev, vecs, q, want, smi, opts.seed, nq / search_s)
    k1_launches_5 = fb.fused_beam_search.launches
    k2_launches_5 = fg.gather_scores_kernel.launches
    k3_launches_5 = fd.fused_descent.launches
    # search_memory reset the peak counters inside path 5
    peak5_gb = max(p5.pop("peak_before_gib"),
                   torch.cuda.max_memory_allocated() / 2**30)
    # each NCCL rank's launches in path 5 (e), counted in its process:
    # their sum is the seventh path, each rank's in ..._by_rank
    k1_ranks, k2_ranks = p5.pop("e_k1_launches"), p5.pop("e_k2_launches")
    k3_ranks = p5.pop("e_k3_launches")
    log(f"# path 5 on {smi}: {time.perf_counter() - t0:.1f} s; K1 launches "
        f"{k1_launches_5}, plain version calls {fb.beam_search_plain.calls}"
        f"; K2 launches {k2_launches_5}; peak device memory "
        f"{peak5_gb:.2f} GiB; measured "
        + json.dumps({name: round(v, 4) for name, v in p5.items()}))
    check(k1_launches_5 > 0, "path 5 never launched K1")
    check(fb.beam_search_plain.calls == 0, "path 5 ran K1's plain version")
    check(k3_launches_5 > 0, "path 5 never launched K3")
    check(fd.fused_descent_plain.calls == 0, "path 5 ran K3's plain version")
    # K1 at the sharded search's default shape, on shard 0's tables
    ef32 = dict(kw, ef=32, max_steps=16)
    err32 = compare_beam("shard0-l2sq-ef32", sharded_beam_inputs(
        two, q[:1024], 32), ef32)
    args = sharded_beam_inputs(two, q[:TIMED_B], 32)
    k32_ms, bound32_ms, bound32_by, _, tail = time_beam(args, ef32)
    p32_ms = device_time(lambda: fb.beam_search_plain(*args, **ef32),
                         iters=3) * 1e3
    log(f"# K1 on {smi} at B={TIMED_B} on shard 0's tables, ef 32, expand 4,"
        f" 16 steps: {k32_ms:.3f} ms; plain {p32_ms:.3f} ms; {tail}")
    del args, two
    log(f"# total {time.perf_counter() - t_start:.1f} s")

    kernels = [{
        "name": "fused_beam",
        "route": "cuda",
        "source": "duckdb_vss_tpu_torch/csrc/fused_beam.cu",
        "replaces": "duckdb_vss_tpu/ops/pallas_beam.py:133",
        "launches": (k1_launches + k1_launches_2 + k1_launches_3
                     + k1_launches_4 + k1_launches_5 + k1_launches_6
                     + sum(k1_ranks)),
        "launches_by_path": [k1_launches, k1_launches_2, k1_launches_3,
                             k1_launches_4, k1_launches_5, k1_launches_6,
                             sum(k1_ranks)],
        "launches_by_rank_5e": k1_ranks,
        "max_abs_err": max(err, err32, p5["e_k1_err"],
                           p5.get("r_k1_err", 0.0)),
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_whole_tiles_ms": tiles_ms,
        "library_ms": None,
        "sharded_ef32": {"ms": k32_ms, "plain_ms": p32_ms,
                         "bound_ms": bound32_ms, "bound_by": bound32_by,
                         "max_abs_err": err32},
    }, {
        "name": "gather_scores",
        "route": "cuda",
        "source": "duckdb_vss_tpu_torch/csrc/gather_scores.cu",
        "replaces": "duckdb_vss_tpu/ops/pallas_gather.py:40",
        "launches": (k2_launches + k2_launches_3 + k2_launches_4
                     + k2_launches_5 + k2_launches_6 + sum(k2_ranks)),
        "launches_by_path": [0, k2_launches, k2_launches_3, k2_launches_4,
                             k2_launches_5, k2_launches_6, sum(k2_ranks)],
        "launches_by_rank_5e": k2_ranks,
        "max_abs_err": err2,
        "ms": k2_ms,
        "plain_ms": p2_ms,
        "bound_ms": bound2_ms,
        "bound_by": bound2_by,
        "library_ms": None,
    }, {
        "name": "fused_descent",
        "route": "cuda",
        "source": "duckdb_vss_tpu_torch/csrc/fused_descent.cu",
        "replaces": None,
        "launches": (k3_launches + k3_launches_2 + k3_launches_3
                     + k3_launches_4 + k3_launches_5 + k3_launches_6
                     + sum(k3_ranks)),
        "launches_by_path": [k3_launches, k3_launches_2, k3_launches_3,
                             k3_launches_4, k3_launches_5, k3_launches_6,
                             sum(k3_ranks)],
        "launches_by_rank_5e": k3_ranks,
        "max_err_over_bound": k3_err,
        "ms": k3[TIMED_B]["ms"],
        "plain_ms": k3[TIMED_B]["plain_ms"],
        "bound_ms": k3[TIMED_B]["bound_ms"],
        "bound_by": k3[TIMED_B]["bound_by"],
        "b1": k3[1],
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
