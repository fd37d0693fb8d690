"""The control: the reference put in the program's place, in TF32.

The configurations state float32 storage and exact float32 scores with
TF32 off, so the step below is TF32: the exact top-k of every query the
program was asked, its products in TF32 (on the CPU, inputs rounded to
TF32's mantissa as the tensor cores round them). Judged as the
program's answers are (judge.judge), it has to come out not correct.
"""

from __future__ import annotations

import torch

from portbench.reference.exact import topk_l2sq
from portbench.reference.judge import Answers


def control_groups(groups: dict, rows: torch.Tensor, k: int) -> dict:
    """``groups`` with every call's keys and scores replaced by the TF32
    search's for the same queries."""
    out = {}
    for name, g in groups.items():
        s, i = topk_l2sq(rows, g.queries, k, tf32=True)
        if g.kind == "l2":
            s = s.clamp_min(0).sqrt()
        s, i = s.cpu().numpy(), i.cpu().numpy()
        out[name] = Answers(g.queries, [(q, i[q], s[q]) for q, _, _ in
                                        g.calls], g.kind, g.self_keys)
    return out
