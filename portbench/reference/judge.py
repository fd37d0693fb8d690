"""The comparison that decides ``correct``.

The program's answers to one group of queries are held to the exact
answers of reference/exact.py over every row the program holds (a row's
key is its index). The numbers compared:

- ``missing``: queries whose answer did not come or is malformed (a row
  missing, a key that is not held, a key twice in one answer, a score
  that is not finite or out of ascending order beyond the scores' own
  accuracy, the score_gap limit). Exact: limit 0.
- ``recall_at_10``: the share of the exact top-k among the keys
  returned, over every query asked (a missing answer finds nothing).
  Its floor is the one the configuration states.
- ``score_gap``: the widest gap between a returned score and the
  float64 distance of the row it names, over the median exact k-th
  score. Its limit lies between the program's readings and those of the
  control (reference/control.py).
- ``self_rank1``, where a group asks each query for itself (an appended
  row searched after the window): the share found at rank 1. Its floor
  is the one the configuration states.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.exact import l2sq_f64, topk_l2sq


@dataclasses.dataclass
class Answers:
    """What the program returned for one group of queries."""
    queries: torch.Tensor  # [Q, d] float32, the group's queries
    calls: list  # (query ids [b] int64, keys [b, k], scores [b, k])
    kind: str = "l2sq"  # the score's form: "l2sq", or "l2" (its root)
    self_keys: np.ndarray | None = None  # [Q]: the key each query must
    # find at rank 1; None: the group is judged against the exact top-k


def _as_kind(d2: torch.Tensor, kind: str) -> torch.Tensor:
    return d2.clamp_min(0).sqrt() if kind == "l2" else d2


def judge(groups: dict, rows: torch.Tensor, k: int,
          tie: float = 0.0) -> dict:
    """The numbers of ``groups`` ({name: Answers}) against ``rows``
    [n_held, d] on the judging device. Scores closer than ``tie`` (the
    score_gap limit, a share of the same scale) are ties: an answer
    whose scores fall back by less than that is still in order, since
    the index ranks by its own float32 expansion of the distance and
    the score it returns is the row's distance taken again."""
    dev, n = rows.device, rows.shape[0]
    out = {"answered": 0, "missing": 0}
    hits = asked = 0
    self_hits = self_asked = 0
    gap = 0.0
    exact = {name: topk_l2sq(rows, g.queries, k)
             for name, g in groups.items() if g.self_keys is None}
    kths = [_as_kind(s[:, -1].double(), groups[name].kind)
            for name, (s, _) in exact.items()]
    scale = float(torch.cat(kths).median()) if kths else 1.0
    for name, g in groups.items():
        ex_idx = exact[name][1] if name in exact else None
        for qids, keys, scores in g.calls:
            b = len(qids)
            out["answered"] += b
            if g.self_keys is None:
                asked += b
            else:
                self_asked += b
            keys, scores = np.asarray(keys), np.asarray(scores)
            if keys.shape != (b, k) or scores.shape != (b, k):
                out["missing"] += b
                out["missing_shape"] = out.get("missing_shape", 0) + b
                continue
            q_t = torch.as_tensor(np.asarray(qids), dtype=torch.int64,
                                  device=dev)
            kt = torch.as_tensor(keys.astype(np.int64), device=dev)
            st = torch.as_tensor(scores, device=dev).double()
            held = (kt >= 0) & (kt < n)
            srt = torch.sort(kt, 1).values
            dup = (srt[:, 1:] == srt[:, :-1]).any(1)
            ordered = (st[:, 1:] >= st[:, :-1] - tie * scale).all(1)
            finite = torch.isfinite(st).all(1)
            ok = held.all(1) & ~dup & finite & ordered
            out["missing"] += int((~ok).sum())
            for why, bad in (("not_held", ~held.all(1)), ("twice", dup),
                             ("not_finite", ~finite),
                             ("out_of_order", ~ordered)):
                out["missing_" + why] = (out.get("missing_" + why, 0)
                                         + int(bad.sum()))
            safe = kt.clamp(0, n - 1)
            truth = _as_kind(l2sq_f64(rows, g.queries[q_t], safe), g.kind)
            diff = torch.where(ok[:, None], (st - truth).abs(), 0.0)
            gap = max(gap, float(diff.max()) / scale if b else 0.0)
            if g.self_keys is None:
                found = (kt[:, :, None] == ex_idx[q_t][:, None, :]).any(-1)
                hits += int((found & ok[:, None]).sum())
            else:
                want = torch.as_tensor(g.self_keys, device=dev)[q_t]
                self_hits += int(((kt[:, 0] == want) & ok).sum())
    if asked:
        out["recall_at_10"] = hits / (asked * k)
    if self_asked:
        out["self_rank1"] = self_hits / self_asked
    out["score_gap"] = gap
    return out


def checks(numbers: dict, config: dict, limits: dict) -> dict:
    """Each number compared beside its limit: {name: {"value", "max"}}
    or {name: {"value", "min"}}. Floors come from the configuration's
    stated guarantees, the rest from limits/<cell>.json."""
    g = config["guarantees"]
    out = {"missing": {"value": numbers["missing"],
                       "max": limits["missing"]["max"]},
           "score_gap": {"value": numbers["score_gap"],
                         "max": limits["score_gap"]["max"]}}
    if "recall_at_10" in numbers:
        out["recall_at_10"] = {"value": numbers["recall_at_10"],
                               "min": g["recall_at_10_min"]}
    if "self_rank1" in numbers:
        out["self_rank1"] = {"value": numbers["self_rank1"],
                             "min": g["self_rank1_min"]}
    return out


def passed(chk: dict) -> bool:
    return all((c["value"] <= c["max"]) if "max" in c else
               (c["value"] >= c["min"]) for c in chk.values())
