"""k1_roofline: kernel K1's share of its roofline, in %: the least time
its calls' work needs on the card (roofline.beam_bound_s, from each
call's own n_dist and expansion counts) over the time its kernels took
in the trace. Nothing when K1 did not run."""

from portbench.roofline import beam_bound_s

LABEL = "portbench.k1"
KERNEL = "fused_beam_kernel"


def _keep(args, kwargs, result):
    return (int(args[0].shape[0]), kwargs["ef"], kwargs["m0"], kwargs["d"],
            result[3], result[2])  # n_expanded, n_dist: device scalars


SPANS = [{"target": "duckdb_vss_tpu_torch.models.graph:fused_beam_search",
          "label": LABEL, "keep": _keep}]


def read(run):
    prof = run.profile
    calls = run.kept.get(LABEL, [])
    if prof is None or not calls:
        return None
    spent = sum(o[1] - o[0] for o in prof.in_window(("kernel",))
                if KERNEL in o[2]) / 1e6
    if spent <= 0:
        return None
    bound = sum(beam_bound_s(b, ef, m0, d, int(n_exp), int(n_dist))
                for b, ef, m0, d, n_exp, n_dist in calls)
    return 100.0 * bound / spent
