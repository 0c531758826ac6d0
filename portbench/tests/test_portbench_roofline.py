"""Each roofline's frozen count against a launch counted by hand."""

import pytest
import torch

from harness import cell

P1 = cell.load_metric("pass1.roofline")
P2 = cell.load_metric("pass2.roofline")


def test_pass1_count_letter_space():
    # two reads of 5 and 3 bases (R = 6, strand 1 of read 1 is 4 long)
    reads2 = torch.full((2, 2, 6), -2, dtype=torch.int8)
    reads2[0, 0, :5] = 1
    reads2[1, 0, :3] = 2
    reads2[1, 1, :4] = 3
    lo = torch.tensor([0, 10, 20], dtype=torch.int64)
    wlen = torch.tensor([7, 9, 12], dtype=torch.int32)   # 12 > G: 10
    rid = torch.tensor([0, 1, 1], dtype=torch.int32)
    st = torch.tensor([0, 0, 1], dtype=torch.int32)
    c = P1.count_ls(None, lo, wlen, rid, st, reads2, 10, None)
    assert int(c["cells"]) == 7 * 5 + 9 * 3 + 10 * 4
    assert int(c["window_bytes"]) == 7 + 9 + 10
    # reads 24 B; a window: start 8, length / read / strand 12, score 4
    assert c["fixed_bytes"] == 24 + 3 * 24
    least = P1.least_seconds({k: float(v) for k, v in c.items()})
    ops = 12 * (35 + 27 + 40)
    assert least == pytest.approx(max(ops / (132 * 64 * 1.98e9),
                                      (26 + 96) / 3.35e12))


def test_pass1_count_colour_space_reads_two_planes():
    reads2 = torch.full((1, 2, 4), -2, dtype=torch.int8)
    reads2[0, 1, :4] = 0
    lo = torch.tensor([5], dtype=torch.int64)
    one = torch.tensor([1], dtype=torch.int32)
    c = P1.count_cs(None, None, lo, torch.tensor([6], dtype=torch.int32),
                    torch.tensor([0], dtype=torch.int32), one,
                    torch.tensor([3], dtype=torch.int8), reads2, 8, None)
    assert int(c["cells"]) == 6 * 4
    assert int(c["window_bytes"]) == 2 * 6
    assert c["fixed_bytes"] == 8 + 1 * (8 + 12 + 1 + 4)


def test_pass2_band_cells_letter_space():
    B, G, R = 2, 16, 4
    genome = torch.zeros((B, G), dtype=torch.int8)
    read = torch.full((B, R), -2, dtype=torch.int8)
    read[0, :3] = 1                      # 3 rows
    read[1, :4] = 2                      # 4 rows
    bxmin = torch.tensor([[0, 1, 2, 3], [0, 0, 5, 5]], dtype=torch.int32)
    bxmax = torch.tensor([[4, 5, 6, 7], [2, 1, 4, 9]], dtype=torch.int32)
    c = P2.count_ls(genome, read, torch.zeros(B, dtype=torch.bool), bxmin,
                    bxmax, None, False, 32)
    # read 0: 5 + 5 + 5 (row 3 is past the read); read 1: 3 + 2 + 0 + 5
    assert int(c["cells"]) == 15 + 10
    assert c["ops_per_cell"] == 24
    assert c["bytes"] == (B * G + B * R + B + 8 * B * R + 40 * B
                          + B * (R + G))


def test_pass2_band_cells_colour_space():
    B, G, R = 1, 8, 3
    qr4 = torch.full((B, 4, R), -2, dtype=torch.int8)
    qr4[0, :, :2] = 0
    bxmin = torch.zeros((B, R), dtype=torch.int32)
    bxmax = torch.full((B, R), 3, dtype=torch.int32)
    c = P2.count_cs(torch.zeros((B, G), dtype=torch.int8), qr4,
                    torch.zeros((B, R), dtype=torch.int32),
                    torch.zeros(B, dtype=torch.bool), bxmin, bxmax, None,
                    True, 0, 32)
    assert int(c["cells"]) == 2 * 4
    assert c["ops_per_cell"] == 144


def test_roofline_reads_device_time_of_its_kernels_only():
    r = {"launches": {"pass1.roofline": [
            {"cells": 1e9, "window_bytes": 0, "fixed_bytes": 0}]},
         "device": {"all_by_name": {
             "void sw_vector_kernel<signed char>(...)": 1e-3,
             "void (anonymous namespace)::sw_full_kernel<16>": 5.0}}}
    assert P1.read(r) == pytest.approx(
        100 * 12e9 / (132 * 64 * 1.98e9) / 1e-3)
    assert P2.read(r) is None            # no pass-2 launch: nothing read
