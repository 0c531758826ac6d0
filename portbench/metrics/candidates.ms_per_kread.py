"""Milliseconds a thousand reads of candidates (host native C, or K10 on
the card): stages `anchor_list` + `hit_list`, from the program's
`Mapper.tel` timers over the window."""

STAGES = ('anchor_list', 'hit_list')


def read(r):
    secs = sum(r["stages"].get(s, 0.0) for s in STAGES)
    return 1e6 * secs / r["reads"]
