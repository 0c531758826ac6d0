"""Milliseconds a thousand reads the host blocks on the card's results:
stage `device_fetch`, each blocking read of a device result in the
unpaired path (pass 1's scores, pass 2's stats and ops, K10's columns),
which includes the wait for their kernels, from the program's
`Mapper.tel` timers over the window; None where the program has no such
stage."""

STAGE = 'device_fetch'


def read(r):
    secs = r["stages"].get(STAGE)
    return None if secs is None else 1e6 * secs / r["reads"]
