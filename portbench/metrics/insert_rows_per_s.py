"""insert_rows_per_s: rows of the calls completed in the window over the
window's seconds (host clock; the window ends at the first call
completed after --seconds)."""


def read(run):
    return run.units / run.window_s if run.window_s > 0 else None
