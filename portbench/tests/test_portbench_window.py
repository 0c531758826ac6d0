"""The window's arithmetic on synthetic batch completions, taken the
way the harness takes them: the window ends at a completion, counts no
partial batch, and takes all of its time."""

import pytest

from harness import window


def _window(t0, completions, seconds):
    """The harness's loop over completion times."""
    taken = []
    for t in completions:
        taken.append(t)
        if window.closes(t0, t, seconds):
            return taken
    return None


def test_window_closes_at_the_first_completion_past_its_length():
    t0 = 100.0
    done = [100.0 + 3.7 * k for k in range(1, 20)]
    taken = _window(t0, done, 45.0)
    assert taken == done[:13]
    assert taken[-1] - t0 >= 45.0 > taken[-2] - t0


def test_rate_counts_whole_batches_over_all_the_time():
    t0 = 0.0
    taken = _window(t0, [1.0, 2.5, 4.0, 5.2, 6.0], 4.5)
    assert taken == [1.0, 2.5, 4.0, 5.2]
    ms = window.intervals_ms(t0, taken)
    # every millisecond of the window is in some batch's interval
    assert sum(ms) == pytest.approx((taken[-1] - t0) * 1e3)
    assert len(ms) == len(taken)


def test_no_completion_past_the_length_no_window():
    assert _window(0.0, [1.0, 2.0], 5.0) is None
