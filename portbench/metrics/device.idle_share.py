"""Share of the traced window in which no operation ran on the card:
100 x (1 - busy / window), busy being the union of the profiler's
device events (kernels and copies) inside the window."""


def read(r):
    d = r.get("device")
    if not d or d["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
