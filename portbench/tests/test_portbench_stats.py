"""The metric arithmetic on hand-built records."""
import math

import pytest

from portbench.lib import stats
from portbench.lib.verdict import judge


def test_window_rate():
    assert stats.rate(300, 30.0) == 10.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_ttft_p95_times_from_the_due_time():
    due = [0.0, 1.0, 2.0, 3.0]
    first = [0.5, 1.25, 4.0, 3.1]
    # latencies 0.5, 0.25, 2.0, 0.1: the 95th percentile interpolates
    assert stats.ttft_p95(due, first) == pytest.approx(0.5 + 0.85 * 1.5)


def test_p95_counts_a_missing_request_above_every_finished_one():
    due = [float(i) for i in range(20)]
    first = [d + 0.1 for d in due]
    first[3] = None
    assert math.isinf(stats.ttft_p95(due, first))
    due = [float(i) for i in range(40)]
    first = [d + 0.1 for d in due]
    first[7] = None      # one missing of 40: the 95th percentile is finite
    assert stats.ttft_p95(due, first) == pytest.approx(0.1)


def test_tpot_over_tokens_after_the_first():
    assert stats.tpot(1.0, 2.0, 11) == pytest.approx(0.1)
    assert stats.tpot(1.0, 1.0, 1) is None


def test_seconds_a_layer_over_whole_sweeps():
    assert stats.s_per_layer([8.0, 8.4, 7.6], 4) == pytest.approx(2.0)


def test_spread_is_the_interquartile_range_over_the_median():
    v = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, q2, q3 = 1.75, 3.5, 5.25
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)


def test_verdict_needs_every_limited_number_under_its_limit():
    ok, table = judge({"a": 0.1, "b": 0.0}, {"a": 0.2, "b": 0})
    assert ok and table["a"] == {"value": 0.1, "limit": 0.2}
    assert not judge({"a": 0.3}, {"a": 0.2})[0]
    assert not judge({"a": 0.1}, {})[0]                 # nothing compared
    assert not judge({"a": math.inf}, {"a": 1.0})[0]
    assert not judge({"a": math.nan}, {"a": 1.0})[0]
    assert not judge({}, {"a": 1.0})[0]                 # a limited number not read
    ok, table = judge({"a": 0.1, "b": 9.0}, {"a": 0.2})  # b printed, not compared
    assert ok and table["b"] == {"value": 9.0, "limit": None}
