"""portbench: the benchmark of duckdb_vss_tpu_torch, the PyTorch/CUDA port.

Run one cell from the root of a checkout:

    python3 -m portbench.run --workload sift1m.batch --seed 7 --seconds 10 --trace 0

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one metric is a file of its own, found by its name in
BENCHMARK.json: ``configs/<config>.json``, ``traffic/<mix>.json`` (read
by the loop in ``drivers/<driver>.py`` that the mix names),
``limits/<cell>.json`` and ``metrics/<metric>.py``. The plain reference
that decides ``correct`` is in ``reference/``; it imports nothing of the
port and nothing of JAX.
"""
