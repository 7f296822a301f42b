"""The statistics of the end-to-end metrics, held to their definitions."""
import pytest

from vbs_bench import stats


def test_window_rate_counts_a_stall_inside_the_window():
    # Ten units of 0.1 s, back to back: 10 units a second.
    assert stats.window_rate(10, 0.0, 1.0) == pytest.approx(10.0)
    # The same units with a 0.5 s stall between two of them: the window
    # is longer, so the rate falls.
    assert stats.window_rate(10, 0.0, 1.5) == pytest.approx(10.0 / 1.5)
    with pytest.raises(ValueError):
        stats.window_rate(1, 2.0, 2.0)
