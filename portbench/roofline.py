"""Peaks of the card and the least time a kernel's work needs.

Frozen copy of chip_smoke.py's ``beam_bound_ms`` and its peaks, so a
later change to the program cannot move the yardstick. Peaks: one
NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at 700 W.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12


def beam_bound_s(b: int, ef: int, m0: int, d: int, n_expanded: int,
                 n_dist: int) -> float:
    """Least time for one call of kernel K1 (the fused beam search) on
    the card, from the call's own counts: every live selection reads its
    3*M0 meta ints once, every candidate the dedup keeps (n_dist of
    them, the only rows the function scores) its d int8 once; queries,
    seeds and outputs move once. Two operations per row byte (bf16
    products) against the dense bf16 peak; the larger time binds. The
    plain version of K1 returns the same counts, so the bound reads the
    same work whatever implements it."""
    io = (b * (d * 4 + 4 + ef * 8)  # queries, q_sq, seed beam
          + b * ef * 8 + b * 8)  # output beam, counts
    nbytes = n_expanded * 3 * m0 * 4 + n_dist * d + io
    ops = n_dist * d * 2
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S)
