"""The measured window: whole batches only.

The window opens at a batch completion (the last of the warm-up) and
closes at the first completion at or after `seconds` later.  The rate is
the items of every batch completed inside it over all of its time, so no
batch is counted in part and no time is left out.
"""

from __future__ import annotations


def closes(t0: float, t: float, seconds: float) -> bool:
    """Whether a batch completed at `t` closes a window opened at `t0`."""
    return t - t0 >= seconds


def intervals_ms(t0: float, completions) -> list[float]:
    """Milliseconds from each completion (the first: from `t0`) to the
    next."""
    out, last = [], t0
    for t in completions:
        out.append((t - last) * 1e3)
        last = t
    return out
