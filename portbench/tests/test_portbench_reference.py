"""The plain reference against cases worked by hand."""

import math

import pytest
import torch

from portbench.reference import formulas as f
from portbench.reference.members import Data, reference

F64 = torch.float64


def test_auroc_counts_a_tie_as_one_half():
    s = torch.tensor([1.0, 2.0, 2.0, 3.0])
    y = torch.tensor([0.0, 1.0, 0.0, 1.0])
    # positives {2, 3} against negatives {1, 2}: 1 + 1/2 + 1 + 1 of 4 pairs
    assert float(f.binary_auroc(s, y, F64)) == 0.875


def test_auroc_of_all_tied_scores_is_one_half():
    s = torch.full((6,), 0.5)
    y = torch.tensor([0.0, 1.0, 0.0, 1.0, 1.0, 0.0])
    assert float(f.binary_auroc(s, y, F64)) == 0.5


def test_auroc_without_ties():
    s = torch.tensor([0.1, 0.4, 0.35, 0.8])
    y = torch.tensor([0.0, 0.0, 1.0, 1.0])
    assert float(f.binary_auroc(s, y, F64)) == 0.75


def test_auroc_rows_of_a_class_with_no_positives_is_undefined():
    scores = torch.tensor([[0.2, 0.6, 0.4], [0.9, 0.1, 0.5]])
    hits = torch.tensor([[True, False, True], [False, False, False]])
    out = f.auroc_rows(scores, hits, F64)
    assert float(out[0]) == 0.0  # both positives below the negative
    assert math.isnan(float(out[1]))


def test_control_rounds_scores_to_bfloat16_before_ranking():
    # 1.0 and 1.001 are one value in bfloat16: the pair becomes a tie
    s = torch.tensor([1.0, 1.001])
    y = torch.tensor([0.0, 1.0])
    assert float(f.binary_auroc(s, y, F64)) == 1.0
    assert float(f.binary_auroc(s, y, torch.bfloat16)) == 0.5


def test_topk_breaks_ties_toward_the_lower_class():
    scores = torch.tensor([[1.0, 1.0, 0.0], [0.0, 2.0, 2.0]])
    target = torch.tensor([1, 1])
    assert f.topk_correct(scores, target, 1, F64) == 1  # row 0 ties to class 0
    assert f.topk_correct(scores, target, 2, F64) == 2


def test_confusion_and_macro_f1_skip_an_absent_class():
    target = torch.tensor([0, 0, 1, 1])
    pred = torch.tensor([0, 1, 1, 1])
    cm = f.confusion(target, pred, 3)
    assert cm.tolist() == [[1, 1, 0], [0, 2, 0], [0, 0, 0]]
    # class 0: 2*1/(2+1); class 1: 2*2/(2+3); class 2 absent
    want = (2 / 3 + 4 / 5) / 2
    assert abs(float(f.macro_f1(cm)) - want) < 1e-15


def test_normalized_entropy_by_hand():
    p = torch.tensor([0.2, 0.7])
    y = torch.tensor([0.0, 1.0])
    stats = f.binary_stats(p, y, F64)
    p0, p1 = (float(v) for v in p)  # the float32 values
    ce = -(math.log(1 - p0) + math.log(p1)) / 2
    base = -(0.5 * math.log(0.5) * 2)
    assert abs(float(f.normalized_entropy(stats)) - ce / base) < 1e-12
    assert float(f.ctr(stats)) == 0.5
    assert abs(float(f.calibration(stats)) - (p0 + p1)) < 1e-12
    assert float(f.accuracy(stats)) == 1.0


def _pool():
    # three batches of two samples; sample i has probability (i + 1) / 10
    p = torch.arange(1, 7, dtype=torch.float32) / 10
    y = torch.tensor([0.0, 1.0, 1.0, 0.0, 1.0, 1.0])
    return Data({"input": p, "target": y}, batch=2, dtype=F64)


def test_a_window_that_has_wrapped_reads_the_pool_cycled():
    data = _pool()
    # after 5 updates the stream holds samples 0..9; the last four are
    # pool samples 0, 1, 2, 3 (the pool has six)
    d = data.sample_range(10 - 4, 10)
    assert d["input"].tolist() == pytest.approx([0.1, 0.2, 0.3, 0.4])
    # the window of the last 2 updates is batches 0 and 1 of the pool's
    # second cycle (updates 3 and 4 are pool batches 0 and 1)
    want = f.binary_stats(torch.tensor([0.1, 0.2, 0.3, 0.4]), torch.tensor([0.0, 1, 1, 0]), F64)
    assert torch.allclose(data.update_stats(3, 5), want)
    # lifetime over 5 updates: one whole cycle and two batches more
    whole = f.binary_stats(data.input, data.target, F64)
    assert torch.allclose(data.update_stats(0, 5), whole + want)


def test_windowed_members_answer_lifetime_and_window():
    data = _pool()
    lifetime, windowed = reference("WindowedClickThroughRate", {"max_num_updates": 2}, data, 5)
    assert float(lifetime) == pytest.approx(6 / 10)  # 4 of 6 once, then 2 of 4
    assert float(windowed) == pytest.approx(2 / 4)
    auroc = reference("WindowedBinaryAUROC", {"max_num_samples": 4}, data, 5)
    assert float(auroc) == pytest.approx(float(f.binary_auroc(
        torch.tensor([0.1, 0.2, 0.3, 0.4]), torch.tensor([0.0, 1, 1, 0]), F64)))


def test_gaps_by_kind():
    from portbench.judge import gap

    ref = torch.tensor([[5, 0], [1, 7]])
    assert gap("exact", ref.to(torch.int32), ref, 1) == 0.0
    assert gap("exact", torch.tensor([[5, 2], [1, 7]], dtype=torch.int32), ref, 1) == 2.0
    assert gap("samples", torch.tensor(0.5), torch.tensor(0.5, dtype=F64) + 1 / 1000, 1000) == pytest.approx(1.0)
    assert gap("rel", (torch.tensor([2.0]),), (torch.tensor([2.5], dtype=F64),), 1) == pytest.approx(0.2)
    assert gap("abs", torch.tensor(float("nan")), torch.tensor(0.5, dtype=F64), 1) == math.inf
    assert gap("abs", torch.zeros(2), torch.zeros(3, dtype=F64), 1) == math.inf
