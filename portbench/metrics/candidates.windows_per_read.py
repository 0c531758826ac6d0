"""Candidate windows a read sends to pass 1: the program's
`stats["pass1_windows"]` over `stats["reads"]`, counted over the
window (a pair's two mates are two reads)."""


def read(r):
    s = r["stats"]
    return s["pass1_windows"] / s["reads"] if s.get("reads") else None
