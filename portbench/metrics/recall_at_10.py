"""recall_at_10: the share of the exact top-10 among the keys returned,
over every query answered in the window (reference/judge.py)."""


def read(run):
    return run.numbers.get("recall_at_10")
