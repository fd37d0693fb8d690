"""index_search_ms: the median per statement of ``HNSWIndex.search``
(models/hnsw.py), host clock, the card synchronized before the clock
stops."""

import numpy as np

from portbench.spans import seconds_per_call

LABEL = "portbench.index_search"
SPANS = [{"target": "duckdb_vss_tpu_torch.models.hnsw:HNSWIndex.search",
          "label": LABEL, "clock": True}]


def read(run):
    per = seconds_per_call(run, LABEL)
    return float(np.median(list(per.values()))) * 1e3 if per else None
