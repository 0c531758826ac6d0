"""Milliseconds a thousand reads of pass 2's host finish
(`Mapper._pass2_finish`: the blocking reads of the stats and traceback
ops, colour space's rendering and posterior, the selection per read):
stage `pass2_finish`, inside `pass2`, from the program's `Mapper.tel`
timers over the window; None where the program has no such stage."""

STAGE = 'pass2_finish'


def read(r):
    secs = r["stages"].get(STAGE)
    return None if secs is None else 1e6 * secs / r["reads"]
