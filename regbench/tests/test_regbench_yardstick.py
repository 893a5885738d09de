"""The yardstick's arithmetic on hand-made cases."""
import statistics

import pytest

from regbench import yardstick


def test_launch_work_counts_live_rows_only():
    # two pairs of a K2 launch: 3 x 4 and 5 x 2 live rows
    ops, nbytes = yardstick.launch_work("k2", [3, 5], [4, 2])
    assert ops == 8 * (3 * 4 + 5 * 2)
    assert nbytes == 12 * (3 + 4) + 8 * 3 + 12 * (5 + 2) + 8 * 5
    ops, nbytes = yardstick.launch_work("k1", [10], [20])
    assert ops == 13 * 200
    assert nbytes == 24 * 30 + 4 * 10


def test_least_seconds_takes_the_larger_bound():
    assert yardstick.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert yardstick.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert yardstick.least_seconds(67e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_union_counts_overlap_once():
    # two streams overlapping on [2, 3], a third interval apart
    assert yardstick.union_length([(0, 3), (2, 5), (7, 8)]) == 6
    assert yardstick.union_length([(1, 4), (1, 2), (2, 3)]) == 3
    assert yardstick.union_length([]) == 0


def test_gaps_are_the_uncovered_stretches():
    assert yardstick.gaps([(1, 2), (1.5, 3), (5, 6)], 0, 8) == [
        (0, 1), (3, 5), (6, 8)]
    assert yardstick.gaps([(0, 10)], 2, 8) == []


def test_percentile_interpolates_like_numpy():
    np = pytest.importorskip("numpy")
    xs = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0]
    for q in (0, 10, 50, 90, 100):
        assert yardstick.percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)))


def test_spread_is_quartile_distance_over_median():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert yardstick.spread(xs) == (q3 - q1) / q2

