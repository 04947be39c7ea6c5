import statistics

import pytest

from portbench import stats


def test_rate_is_all_the_work_over_all_the_window():
    assert stats.rate_ms(10.0, 500) == pytest.approx(20.0)
    with pytest.raises(ValueError):
        stats.rate_ms(1.0, 0)


def test_p95_over_every_value():
    vals = list(range(1, 101))          # 1..100
    assert stats.p95(vals) == 95
    assert stats.p95([5.0]) == 5.0
    # one slow frame in twenty sets the tail
    assert stats.p95([1.0] * 19 + [50.0]) == 1.0
    assert stats.p95([1.0] * 18 + [50.0, 60.0]) == 50.0


def test_spread_uses_python_quartiles():
    vals = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / med)


def test_union_of_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 10)]
    assert stats.union_length(iv) == pytest.approx(4.0)
    assert stats.merged(iv) == [[0, 3], [5, 6], [10, 10]]
    assert stats.union_length([]) == 0.0
