"""Milliseconds a thousand reads of pass 2's dispatch
(`Mapper._pass2_dispatch`: the window gathers, the bands, colour space's
read rows, the copies to the card and the launch of K3+K4 or K7+K8):
stage `pass2_dispatch`, inside `pass2`, from the program's `Mapper.tel`
timers over the window; None where the program has no such stage."""

STAGE = 'pass2_dispatch'


def read(r):
    secs = r["stages"].get(STAGE)
    return None if secs is None else 1e6 * secs / r["reads"]
