"""descent_ms: device ms of the search's descent (models/graph.py
``mxu_descent``) per 8,192 queries: the device operations launched
inside it over the traced calls, from the trace, over the queries it
descended, times 8,192."""

LABEL = "portbench.descent"
SPANS = [{"target": "duckdb_vss_tpu_torch.models.graph:mxu_descent",
          "label": LABEL, "annotate": True,
          "keep": lambda args, kwargs, result: int(args[4].shape[0])}]


def read(run):
    prof, rows = run.profile, sum(run.kept.get(LABEL, []))
    ops = prof.launched_in(LABEL) if prof is not None else []
    if not ops or not rows:
        return None
    return sum(o[1] - o[0] for o in ops) / 1e3 / rows * 8192
