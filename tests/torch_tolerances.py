"""The f32 tolerances of the port's exact paths, derived in the
docstring of tests/test_torch_topk.py (which re-exports them): the score
bound of two correct f32 computations of one score, and the id
comparison within rounding ties. Imports neither JAX nor the JAX
package, so the card's tests can use them where JAX is not installed."""

import numpy as np

U = 2.0 ** -24  # f32 unit roundoff
BOUND_C = 5


def score_bound(q, v, metric):
    """Per query row, the largest difference two correct f32
    computations of its scores against any row of ``v`` may show (see
    the module docstring). [B] float64."""
    q = q.astype(np.float64)
    v = v.astype(np.float64)
    d = q.shape[1]
    q_sq = (q * q).sum(1)
    v_sq_max = (v * v).sum(1).max()
    if metric == "l2sq":
        scale = q_sq + v_sq_max
    elif metric == "cosine":
        scale = np.ones_like(q_sq)
    else:
        scale = np.sqrt(q_sq * v_sq_max) + 1.0
    return BOUND_C * d * U * scale


def assert_scores_within(got, want, bound, metric):
    """Every score within its row's bound; the message names the first
    row that misses it, the metric and both values."""
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    bad = diff > bound[:, None]
    if bad.any():
        r, c = map(int, np.argwhere(bad)[0])
        raise AssertionError(
            f"{metric}: row {r}, place {c}: port {got[r, c]!r} vs JAX "
            f"{want[r, c]!r}, difference {diff[r, c]:.3e} > bound "
            f"{bound[r]:.3e} ({int(bad.sum())} places miss it)")


def assert_same_ids_within_ties(got_i, want_i, want_s, tol, metric):
    """Row by row: split the reference's ascending scores into groups of
    neighbours closer than ``tol[row]`` (twice the score bound: a larger
    gap cannot be crossed by rounding). A group that ends before the
    k-th place must hold the same ids in both results, in any order; a
    group of one is an exact id. The last group may be cut by k, and two
    libraries may keep different members of it: there the ids must be
    distinct and new."""
    k = want_s.shape[1]
    for r, (g, w, s) in enumerate(zip(got_i.tolist(), want_i.tolist(),
                                      want_s.tolist())):
        start = 0
        while start < k:
            end = start + 1
            while end < k and abs(s[end] - s[end - 1]) <= tol[r]:
                end += 1
            if end < k:
                assert set(g[start:end]) == set(w[start:end]), (
                    f"{metric}: row {r}, places {start}-{end - 1}: port ids "
                    f"{g[start:end]} vs JAX {w[start:end]} (JAX scores "
                    f"{s[start:end]}, tie tolerance {tol[r]:.3e})")
            else:
                tail = g[start:]
                assert len(set(tail)) == len(tail), (
                    f"{metric}: row {r}: repeated ids in the last group "
                    f"{tail} (JAX {w[start:]})")
                assert not set(tail) & set(g[:start]), (
                    f"{metric}: row {r}: the last group {tail} repeats an "
                    f"earlier id of {g[:start]} (JAX {w})")
            start = end
