"""insert_launches_per_batch: device kernels launched per insert step
(models/build.py ``insert_batch`` and the int8 rows it refreshes,
``update_neighborhood_rows``), from the trace, over the steps traced."""

STEP, ROWS = "portbench.insert_batch", "portbench.insert_rows"
SPANS = [{"target": "duckdb_vss_tpu_torch.models.hnsw:insert_batch",
          "label": STEP, "annotate": True},
         {"target": "duckdb_vss_tpu_torch.models.hnsw:update_neighborhood_rows",
          "label": ROWS, "annotate": True}]


def read(run):
    prof = run.profile
    if prof is None or not prof.count(STEP) or not prof.in_window():
        return None
    n = (len(prof.launched_in(STEP, ("kernel",)))
         + len(prof.launched_in(ROWS, ("kernel",))))
    return n / prof.count(STEP)
