"""sql_host_ms: the median per statement of its latency less its
``HNSWIndex.search``: the SQL layer (sql/ parser, frontend, engine) and
the fetch and projection around the index, host clock."""

import numpy as np

from portbench.spans import seconds_per_call

LABEL = "portbench.index_search"
SPANS = [{"target": "duckdb_vss_tpu_torch.models.hnsw:HNSWIndex.search",
          "label": LABEL, "clock": True}]


def read(run):
    per = seconds_per_call(run, LABEL)
    if not run.latencies or not per:
        return None
    return float(np.median([lat - per.get(i, 0.0)
                            for i, lat in enumerate(run.latencies)])) * 1e3
