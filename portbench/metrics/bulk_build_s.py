"""bulk_build_s: seconds of the bulk build in set-up, the sum of the
program's own ``build_stats["phase_s"]`` (each phase ended by a device
sync), over the shards this process built."""


def read(run):
    stats = [s for s in run.extra.get("build_stats") or [] if s]
    if not stats:
        return None
    return sum(sum(s["phase_s"].values()) for s in stats)
