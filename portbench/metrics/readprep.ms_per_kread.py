"""Milliseconds a thousand reads of read prep (`pipeline/candidates.py`):
stage `readparse`, from the program's `Mapper.tel` timers over the
window."""

STAGES = ('readparse',)


def read(r):
    secs = sum(r["stages"].get(s, 0.0) for s in STAGES)
    return 1e6 * secs / r["reads"]
