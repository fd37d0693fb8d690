"""sql_self_ms: the median per statement of the program's ``sql.execute``
span less its ``index.search`` child: the SQL layer's own time (parse,
plan, the operators around the index, the column batch) on the
profiler's clock, the in-program twin of sql_host_ms. None where the
program has no such span."""

import numpy as np

from portbench.program_spans import self_us


def read(run):
    prof = run.profile
    if prof is None:
        return None
    per = self_us(prof, "sql.execute", "index.search")
    return float(np.median(per)) / 1e3 if per else None
