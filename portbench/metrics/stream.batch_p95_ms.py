"""95th percentile of the milliseconds between consecutive batch
completions in the window (the first from the window's opening), on the
harness's clock at each batch the stream completes."""

import numpy as np


def read(r):
    ms = r["batch_ms"]
    return float(np.percentile(ms, 95)) if ms else None
