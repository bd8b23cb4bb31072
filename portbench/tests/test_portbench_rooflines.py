"""Each roofline reader's bytes against the problem's shapes, and its
share from a trace with known kernel times."""

import pytest

from portbench.peaks import HBM_BYTES_PER_S
from portbench.profile import Event, Trace
from portbench.spec import HERE, load_reader

RANK = load_reader(HERE / "layer_metrics" / "rank_sum_roofline.py")
AUC = load_reader(HERE / "layer_metrics" / "auc_scan_roofline.py")


def _trace(ops, computes, config, suite):
    return Trace(device_ops=ops, runtime=[], ranges=[], cpu_ops=[], window=(0.0, 1e6),
                 batches=1, updates=1, computes=computes, config=config, suite=suite)


def test_rank_sum_bytes_are_the_problem_read_once():
    import importlib.util

    spec = importlib.util.spec_from_file_location("m", HERE / "layer_metrics" / "rank_sum_roofline.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    # 50 000 x 1000 float32 scores, 50 000 int64 targets, 1000 int64 counts
    assert m.problem_bytes(50_000, 1000) == 200_000_000 + 400_000 + 8000


def test_rank_sum_share_from_kernel_time():
    config = {"num_samples": 50_000, "num_classes": 1000}
    nbytes = 200_408_000
    least_us = nbytes / HBM_BYTES_PER_S * 1e6
    # two computes, each kernel taking four times the least time
    ops = [Event("void rank_sum_kernel<32, true, 9, false>(View, ...)", 0.0, 4 * least_us),
           Event("void rank_sum_kernel<32, true, 9, false>(View, ...)", 10.0, 10 + 4 * least_us),
           Event("Memset (Device)", 0.0, 1000.0)]
    assert RANK(_trace(ops, 2, config, {})) == pytest.approx(25.0)


def test_a_roofline_reads_nothing_when_its_kernel_did_not_run():
    config = {"num_samples": 50_000, "num_classes": 1000}
    ops = [Event("void at::native::radixSortKernel(...)", 0.0, 10.0)]
    assert RANK(_trace(ops, 1, config, {})) is None
    assert AUC(_trace(ops, 1, {"num_samples": 10}, {"suite": []})) is None


def test_auc_scan_counts_every_sample_of_the_member():
    whole = {"suite": [{"members": {"auroc": {"class": "BinaryAUROC"}}}]}
    window = {"suite": [{"members": {"auroc": {"class": "WindowedBinaryAUROC",
                                               "kwargs": {"max_num_samples": 1_250_000}}}}]}
    config = {"num_samples": 89_137_319}
    for suite, n in ((whole, 89_137_319), (window, 1_250_000)):
        least_us = (5 * n + 4) / HBM_BYTES_PER_S * 1e6
        ops = [Event("auc_chunk_kernel(...)", 0.0, least_us),
               Event("auc_combine_kernel(...)", 5.0, 5.0 + least_us)]
        assert AUC(_trace(ops, 1, config, suite)) == pytest.approx(50.0)


def test_a_roofline_fails_where_the_port_launched_a_kernel_the_trace_does_not_name():
    config = {"num_samples": 50_000, "num_classes": 1000}
    ops = [Event("void renamed_counting_kernel(...)", 0.0, 10.0)]
    trace = _trace(ops, 1, config, {})
    trace.launches = {"rank_sum_counts": 1}
    with pytest.raises(RuntimeError, match="rank_sum_counts"):
        RANK(trace)
    trace.launches = {"auc_from_sorted": 1}
    with pytest.raises(RuntimeError, match="auc_from_sorted"):
        AUC(trace)
