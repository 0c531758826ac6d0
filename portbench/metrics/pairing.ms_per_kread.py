"""Milliseconds a thousand reads of pairing (`pipeline/paired.py`): stages
`pair_up`, `get_vector_hits`, `mp_region_counts`, `hp_pass1`,
`hp_pass2`, `paired_mqv`, summed over the paired stream's two worker
threads (thread-seconds), from the program's `Mapper.tel` timers over
the window."""

STAGES = ('pair_up', 'get_vector_hits', 'mp_region_counts', 'hp_pass1',
          'hp_pass2', 'paired_mqv')


def read(r):
    secs = sum(r["stages"].get(s, 0.0) for s in STAGES)
    return 1e6 * secs / r["reads"]
