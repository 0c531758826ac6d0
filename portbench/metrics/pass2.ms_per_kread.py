"""Milliseconds a thousand reads of pass 2 and its host finish
(`ops/sw_full*.py`, `ops/post_sw.py`, `Mapper._pass2_finish`,
`duplicate_removal` inside it): stage `pass2`, from the program's
`Mapper.tel` timers over the window."""

STAGES = ('pass2',)


def read(r):
    secs = sum(r["stages"].get(s, 0.0) for s in STAGES)
    return 1e6 * secs / r["reads"]
