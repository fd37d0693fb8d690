"""The plain reference against float64 NumPy, and the comparison."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.reference.control import control_groups
from portbench.reference.exact import l2sq_f64, round_tf32, topk_l2sq
from portbench.reference.judge import Answers, checks, judge, passed


def data(seed=0, n=3000, d=24, b=40):
    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(16, d))
    rows = (cents[rng.integers(0, 16, n)] + 0.25 * rng.normal(size=(n, d)))
    qs = (cents[rng.integers(0, 16, b)] + 0.25 * rng.normal(size=(b, d)))
    return rows.astype(np.float32), qs.astype(np.float32)


@pytest.mark.parametrize("block_n", [1 << 20, 700])
def test_topk_matches_float64_numpy(block_n):
    rows, qs = data()
    d2 = ((qs.astype(np.float64)[:, None, :] - rows[None]) ** 2).sum(-1)
    want = np.argsort(d2, 1, kind="stable")[:, :10]
    s, i = topk_l2sq(torch.from_numpy(rows), torch.from_numpy(qs), 10,
                     block_q=16, block_n=block_n)
    got = i.numpy()
    # equal ids wherever the float64 gap to the next row exceeds f32 rounding
    srt = np.sort(d2, 1)
    clear = (srt[:, 10] - srt[:, 9]) > 1e-3
    assert (np.sort(got[clear], 1) == np.sort(want[clear], 1)).all()
    np.testing.assert_allclose(s.numpy(), np.take_along_axis(d2, got, 1),
                               rtol=1e-5, atol=1e-4)
    f64 = l2sq_f64(torch.from_numpy(rows), torch.from_numpy(qs), i).numpy()
    np.testing.assert_allclose(f64, np.take_along_axis(d2, got, 1),
                               rtol=1e-12)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.14159265, 1e-3], dtype=torch.float32)
    y = round_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2 ** -10
    assert y[2] == 1.0  # a tie rounds to even
    assert y[3] == 1.0 + 2 ** -9
    assert ((y.view(torch.int32) & 0x1FFF) == 0).all()
    assert (abs(y - x) <= abs(x) * 2 ** -11).all()


def _groups(rows, qs, keys, scores):
    return {"queries": Answers(torch.from_numpy(qs),
                               [(np.arange(len(qs)), keys, scores)])}


def test_judge_exact_answers_read_zero():
    rows, qs = data()
    s, i = topk_l2sq(torch.from_numpy(rows), torch.from_numpy(qs), 10)
    nums = judge(_groups(rows, qs, i.numpy(), s.numpy()),
                 torch.from_numpy(rows), 10)
    assert nums["missing"] == 0 and nums["recall_at_10"] == 1.0
    assert nums["score_gap"] < 1e-5


def test_judge_counts_missing_and_altered_answers():
    rows, qs = data()
    s, i = topk_l2sq(torch.from_numpy(rows), torch.from_numpy(qs), 10)
    keys, scores = i.numpy().copy(), s.numpy().copy()
    keys[0, 3] = keys[0, 2]  # a key twice
    keys[1, 0] = len(rows)  # a key not held
    scores[2, 0] = np.nan
    keys[5, 9] = (keys[5, 9] + 1) % len(rows)  # another row, same score
    nums = judge(_groups(rows, qs, keys, scores), torch.from_numpy(rows), 10)
    assert nums["missing"] == 3
    assert nums["score_gap"] > 1e-3
    half = judge(_groups(rows, qs, keys[:20], scores[:20]),
                 torch.from_numpy(rows), 10)
    assert half["missing"] == len(qs) and half["recall_at_10"] == 0.0


def test_checks_hold_each_number_to_its_limit():
    cfg = {"guarantees": {"recall_at_10_min": 0.95, "self_rank1_min": 0.99}}
    lim = {"missing": {"max": 0}, "score_gap": {"max": 1e-4}}
    ok = checks({"missing": 0, "score_gap": 1e-5, "recall_at_10": 0.96,
                 "self_rank1": 1.0}, cfg, lim)
    assert passed(ok) and list(ok) == ["missing", "score_gap",
                                       "recall_at_10", "self_rank1"]
    for bad in ({"missing": 1}, {"score_gap": 2e-4}, {"recall_at_10": 0.9},
                {"self_rank1": 0.98}):
        nums = {"missing": 0, "score_gap": 1e-5, "recall_at_10": 0.96,
                "self_rank1": 1.0}
        nums.update(bad)
        assert not passed(checks(nums, cfg, lim))


@pytest.mark.parametrize("cell", ["sift1m.batch", "sift1m.point-sql",
                                  "sift1m.insert", "bigann-4m.batch"])
def test_control_fails_the_cells_limit(cell):
    """The control (TF32; on the CPU its inputs rounded to TF32) fails
    the cell's score_gap limit, which the exact search meets, on data of
    the configurations' shape (128-d, the clustered generator)."""
    from portbench.spec import find_cell

    c = find_cell(cell)
    limit = c.limits["score_gap"]["max"]
    rows, qs = data(seed=3, n=4000, d=128, b=64)
    rows_t = torch.from_numpy(rows)
    s, i = topk_l2sq(rows_t, torch.from_numpy(qs), 10)
    kind = "l2" if c.traffic["driver"] == "sql_point" else "l2sq"
    if kind == "l2":
        s = s.clamp_min(0).sqrt()
    g = {"queries": Answers(torch.from_numpy(qs),
                            [(np.arange(len(qs)), i.numpy(), s.numpy())],
                            kind)}
    exact = judge(g, rows_t, 10, limit)
    ctrl = judge(control_groups(g, rows_t, 10), rows_t, 10, limit)
    assert exact["score_gap"] < limit < ctrl["score_gap"]
    assert exact["missing"] == ctrl["missing"] == 0
    assert passed(checks(exact, c.config, c.limits))
    assert not passed(checks(ctrl, c.config, c.limits))
