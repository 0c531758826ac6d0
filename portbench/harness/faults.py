"""Faults planted under the timed path, for the readings that set a
cell's limits (`readings.py --faults`) and for the tests.  Each makes
the colour-space pass-2 kernels (K7+K8) choose their paths by wrong
arithmetic; everything after the kernels works the records out from
those paths as it should, so only a check of the paths' optimality can
see them."""

from __future__ import annotations

import contextlib

FAULTS = ("k7_crossover", "k7_gap")


@contextlib.contextmanager
def planted(name: str):
    """`k7_crossover`: every crossover scored the flat -x (-20) in the
    DP, not from its colour's quality; `k7_gap`: gaps opened at -25, not
    -33."""
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r} (have {FAULTS})")
    from shrimp_tpu_torch.ops import sw_full_cs
    orig = sw_full_cs.sw_full_cs_and_traceback_packed

    def call(genome, qr4, xover_row, revcmpl, band_xmin, band_xmax,
             params, *args, **kw):
        if name == "k7_crossover":
            xover_row = xover_row.clone().fill_(params.crossover)
        else:
            params = params.with_(a_gap_open=-25, b_gap_open=-25)
        return orig(genome, qr4, xover_row, revcmpl, band_xmin, band_xmax,
                    params, *args, **kw)

    sw_full_cs.sw_full_cs_and_traceback_packed = call
    try:
        yield
    finally:
        sw_full_cs.sw_full_cs_and_traceback_packed = orig
