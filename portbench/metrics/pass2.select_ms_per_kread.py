"""Milliseconds a thousand reads of pass 2's selection per read
(`Mapper._pass2_select`: each row's FinalHit, then dedup, sort and MQV in
`_select_hits`): stage `pass2_select`, inside `pass2_finish`, from the
program's `Mapper.tel` timers over the window; None where the program has
no such stage."""

STAGE = 'pass2_select'


def read(r):
    secs = r["stages"].get(STAGE)
    return None if secs is None else 1e6 * secs / r["reads"]
