"""Milliseconds a thousand reads of colour space's posterior
(`ops/post_sw.py::post_sw_batch`, float64 NumPy): stage `post_sw`, inside
`pass2_finish`, from the program's `Mapper.tel` timers over the window;
None where the program has no such stage (letter space never enters
it)."""

STAGE = 'post_sw'


def read(r):
    secs = r["stages"].get(STAGE)
    return None if secs is None else 1e6 * secs / r["reads"]
