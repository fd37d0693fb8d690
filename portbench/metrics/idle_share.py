"""idle_share: the share of the traced window, in %, in which rank 0's
card ran no operation (kernel, copy or set), from the trace. Its
variants (``idle_share.search``, ``.sharded``, ``.sql``, ``.insert``)
are this reading in the cells whose end-to-end metric each moves."""


def read(run):
    prof = run.profile
    if prof is None or prof.window_s <= 0 or not prof.in_window():
        return None
    return 100.0 * (1.0 - prof.busy_s() / prof.window_s)
