"""The frozen arithmetic on synthetic inputs."""

import math
import statistics

import pytest

from portbench import roofline, stats


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 100) == 100
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([3, 1, 2], 50) == 2


def test_percentile_counts_failures_as_slowest():
    xs = [1.0] * 90 + [math.inf] * 10
    assert stats.percentile(xs, 95) == math.inf
    assert stats.percentile(xs, 90) == 1.0


def test_percentile_of_nothing_raises():
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate_and_mean():
    assert stats.rate(300, 20.0) == 15.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    assert stats.mean([1.0, 2.0, 3.0]) == 2.0


def test_spread_is_statistics_quartiles():
    xs = [10.0, 10.5, 9.8, 10.2, 10.1, 9.9]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / q2)


def test_union_and_merge_of_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union_length(iv) == pytest.approx(3.0)
    assert stats.merged(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert stats.union_length([]) == 0.0


def test_roofline_share_in_percent():
    from portbench.metrics._launches import share

    class T:
        def kernel_s(self, *names):
            return (2e-3, 4)

    class C:
        devtrace = T()

    assert share(C(), 1e-3, ("k",)) == pytest.approx(50.0)

    class E:
        devtrace = None

    assert share(E(), 1e-3, ("k",)) is None


def test_setop_rows_bound_by_hand():
    import torch

    A = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    keep = torch.tensor([[1, 0, 0, 1], [0, 1, 0, 0]], dtype=torch.bool)
    # A's 8 words and 2 counts out, the mask and the 3 kept words in
    want = 4 * 8 + 4 * 2 + 8 + 4 * 3
    assert roofline.setop_rows_bound_s("compact_batch", (A, keep)) == pytest.approx(
        want / roofline.HBM_BYTES_PER_S)
    # one row of 4 against a range of 4 of B, all in one 32-byte sector:
    # A, its offsets (twice: in and out), rid, the range table, one
    # sector of B, and the 2 words held
    A = torch.tensor([1, 3, 5, 7], dtype=torch.int32)
    offs = torch.tensor([0, 4], dtype=torch.int32)
    rid = torch.tensor([0], dtype=torch.int32)
    B = torch.tensor([3, 4, 5, 6], dtype=torch.int32)
    ranges = torch.tensor([[0, 4]], dtype=torch.int32)
    want = 16 + 8 + 4 + 8 + 32 + 4 * 2 + 8
    assert roofline.setop_rows_bound_s("intersect_ragged", (A, offs, rid, B, ranges)) == \
        pytest.approx(want / roofline.HBM_BYTES_PER_S)


def test_spreads_reads_tagged_result_lines(tmp_path, capsys):
    from portbench import spreads

    p = tmp_path / "set.jsonl"
    p.write_text("".join(f'a{i} {{"metrics": {{"qps": {{"value": {v}, "unit": "reads/s"}}}}}}\n'
                         for i, v in enumerate([10.0, 10.5, 9.8, 10.2, 10.1, 9.9])))
    assert spreads.read_set(str(p)) == {"qps": [10.0, 10.5, 9.8, 10.2, 10.1, 9.9]}
    spreads.main([str(p), str(p)])
    out = capsys.readouterr().out
    assert out.startswith("qps: median 10.05") and "widest" in out
