"""Gapless pass 1 (L2b), the counterpart of `shrimp_tpu/ops/sw_gapless.py`:
the -U / -M mirna pass-1 engine, `common/sw-gapless.c:sw_gapless`.

An optimal ungapped alignment score along ONE genome diagonal fixed by
the hit's anchor.  The diagonals are gathered on the host (int8 [N, R]
genome codes and read codes side by side); per row the score is Kadane's
max-subarray sum of the column scores, floored at 0, written as

    max(0, max_i (prefix_i - min(0, min_{j<i} prefix_j))).

Colour space overrides column 0 with `s0` (the forced first colour,
sw-gapless.c:85-95); letter space scores column 0 like any other.

Two versions of `gapless_score_batch`:
  * the plain PyTorch version (`gapless_score_batch_plain`), cumsum and
    cummin as in the JAX function; CPU tensors only;
  * the CUDA kernel `csrc/sw_gapless.cu` (K6), through
    `gapless_score_batch_cuda`.
`gapless_score_batch` picks by the device of its tensors.
"""

from __future__ import annotations

import ctypes

import torch

from shrimp_tpu_torch.ops.params import SWParams
from shrimp_tpu_torch import _build

GENOME_PAD = -1          # beyond-contig genome positions
READ_PAD = -2            # beyond-read positions (never equal to genome pad)

# launches of the sw_gapless kernel
LAUNCHES = _build.LaunchCounter()


def gapless_score_batch_plain(diag: torch.Tensor, reads: torch.Tensor,
                              params: SWParams,
                              s0: torch.Tensor | None = None) -> torch.Tensor:
    """Ungapped diagonal scores, plain version (CPU tensors): diag and
    reads int8 [N, R], s0 None or int32 [N].  Returns int32 [N]."""
    _build.require_cpu(diag, reads, s0)
    valid = (diag != GENOME_PAD) & (reads != READ_PAD)
    s = torch.where(diag == reads, params.match, params.mismatch)
    s = torch.where(valid, s, 0).to(torch.int32)
    N, R = s.shape
    if N == 0 or R == 0:
        return torch.zeros(N, dtype=torch.int32)
    if s0 is not None:
        s[:, 0] = s0.to(torch.int32)
    prefix = torch.cumsum(s, dim=1, dtype=torch.int32)
    runmin = torch.cummin(prefix, dim=1).values
    runmin = torch.cat([torch.zeros((N, 1), dtype=torch.int32),
                        runmin[:, :-1]], dim=1).clamp_max(0)
    return (prefix - runmin).amax(dim=1).clamp_min(0).to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("sw_gapless")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.sw_gapless_launch.restype = ctypes.c_int
        lib.sw_gapless_launch.argtypes = [vp, vp, vp, i, i, i, i, vp, vp]
        _LIB = lib
    return _LIB


def gapless_score_batch_cuda(diag: torch.Tensor, reads: torch.Tensor,
                             params: SWParams,
                             s0: torch.Tensor | None = None) -> torch.Tensor:
    """`gapless_score_batch` on the card, one launch: diag and reads int8
    [N, R], s0 None or int32 [N].  Returns int32 [N] on the same device."""
    dev = diag.device
    if dev.type != "cuda":
        raise ValueError(f"the sw_gapless kernel needs CUDA tensors; got {dev}")
    _build.check_tensor("diag", diag, torch.int8, 2, dev)
    _build.check_tensor("reads", reads, torch.int8, 2, dev)
    N, R = diag.shape
    if tuple(reads.shape) != (N, R):
        raise ValueError(f"reads is {tuple(reads.shape)}, expected {(N, R)}")
    if s0 is not None:
        _build.check_tensor("s0", s0, torch.int32, 1, dev)
        if s0.shape[0] != N:
            raise ValueError(f"s0 has {s0.shape[0]} rows, expected {N}")
    out = torch.zeros(N, dtype=torch.int32, device=dev)
    if N == 0 or R == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sw_gapless_launch(
            diag.data_ptr(), reads.data_ptr(),
            None if s0 is None else s0.data_ptr(), N, R, params.match,
            params.mismatch, out.data_ptr(), stream)
    _build.check_launch(lib, "sw_gapless", rc)
    LAUNCHES.add()
    return out


def gapless_score_batch(diag: torch.Tensor, reads: torch.Tensor,
                        params: SWParams,
                        s0: torch.Tensor | None = None) -> torch.Tensor:
    """Counterpart of `shrimp_tpu.ops.sw_gapless.gapless_score_batch`: the
    kernel for CUDA tensors, the plain version for CPU ones."""
    if diag.device.type == "cuda":
        return gapless_score_batch_cuda(diag, reads, params, s0)
    return gapless_score_batch_plain(diag, reads, params, s0)
