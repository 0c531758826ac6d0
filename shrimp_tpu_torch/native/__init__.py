"""Native (C) runtime components, loaded via ctypes.

The host runtime around the device kernels mirrors the reference's C
layer where it matters — here the bulk FASTQ/FASTA record indexer
(common/fasta.c's role), the CSR index builder and the host candidate
loops.  Each shared object is built on first use with the system compiler
into `build/shrimp_tpu_torch/native/` under the repository root (never
next to the sources); everything falls back to the pure-Python
implementations when no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastx_native.c")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "shrimp_tpu_torch", "native")
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _compile(src: str, so_name: str, extra: tuple = ()) -> str | None:
    """Build `src` into BUILD_DIR/so_name unless a build newer than the
    source is there.  The compiler writes a file of its own, renamed into
    place, so processes building side by side never load a half-written
    library."""
    so_path = os.path.join(BUILD_DIR, so_name)
    if os.path.exists(so_path) and \
       os.path.getmtime(so_path) >= os.path.getmtime(src):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    for cc in ("cc", "gcc", "clang"):
        try:
            r = subprocess.run(
                [cc, "-O3", "-fPIC", "-shared", *extra, "-o", tmp, src],
                capture_output=True, timeout=120)
            if r.returncode == 0:
                os.replace(tmp, so_path)
                return so_path
        except (OSError, subprocess.TimeoutExpired):
            continue
    if os.path.exists(tmp):
        os.remove(tmp)
    return None


def _build() -> str | None:
    return _compile(_SRC, "_fastx_native.so")


def load() -> ctypes.CDLL | None:
    """Return the native library, building it on first use (None if no
    toolchain is available)."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    c_ll = ctypes.c_longlong
    lib.fastx_count_records.restype = c_ll
    lib.fastx_count_records.argtypes = [ctypes.c_char_p, c_ll, ctypes.c_int]
    lib.fastx_index_fastq.restype = c_ll
    lib.fastx_index_fastq.argtypes = [
        ctypes.c_char_p, c_ll, ctypes.POINTER(c_ll), c_ll]
    lib.fastx_index_fasta.restype = c_ll
    lib.fastx_index_fasta.argtypes = [
        ctypes.c_char_p, c_ll, ctypes.POINTER(c_ll), c_ll]
    lib.fastx_translate.restype = c_ll
    lib.fastx_translate.argtypes = [
        ctypes.c_char_p, c_ll, ctypes.c_char_p, ctypes.c_char_p]
    _LIB = lib
    return lib


def available() -> bool:
    return load() is not None


_IDX_LIB: ctypes.CDLL | None = None
_IDX_TRIED = False


def load_index() -> ctypes.CDLL | None:
    """The native CSR index-builder kernels (index_native.c)."""
    global _IDX_LIB, _IDX_TRIED
    if _IDX_LIB is not None or _IDX_TRIED:
        return _IDX_LIB
    _IDX_TRIED = True
    src = os.path.join(_HERE, "index_native.c")
    so_name = "_index_native.so"
    # -march=native vectorizes the blocked mapidx accumulation (AVX2)
    so = _compile(src, so_name, extra=("-fopenmp", "-march=native")) or \
        _compile(src, so_name, extra=("-fopenmp",)) or \
        _compile(src, so_name)
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    c_ll = ctypes.c_longlong
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i8p = ctypes.POINTER(ctypes.c_int8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    llp = ctypes.POINTER(c_ll)
    lib.index_mapidx.restype = None
    lib.index_mapidx.argtypes = [i8p, c_ll, i32p, ctypes.c_int32, u8p, u32p]
    lib.index_mix64.restype = None
    lib.index_mix64.argtypes = [u32p, c_ll, ctypes.c_int32, u8p]
    lib.index_valid.restype = None
    lib.index_valid.argtypes = [i8p, c_ll, ctypes.c_int32, llp,
                                ctypes.c_int32, u8p]
    lib.index_count.restype = None
    lib.index_count.argtypes = [u32p, c_ll, llp]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    try:                            # absent only in a stale prebuilt .so
        lib.index_partition_sort.restype = c_ll
        lib.index_partition_sort.argtypes = [u32p, c_ll, c_ll, llp, u64p,
                                             u32p]
        lib.index_trim.restype = c_ll
        lib.index_trim.argtypes = [llp, c_ll, u32p, u32p, c_ll]
    except AttributeError:
        pass
    lib.index_place.restype = None
    lib.index_place.argtypes = [u32p, c_ll, llp, u32p]
    _IDX_LIB = lib
    return lib


_CAND_LIB: ctypes.CDLL | None = None
_CAND_TRIED = False


def load_candidates() -> ctypes.CDLL | None:
    """Host-side L3 hot loops (candidates_native.c)."""
    global _CAND_LIB, _CAND_TRIED
    if _CAND_LIB is not None or _CAND_TRIED:
        return _CAND_LIB
    _CAND_TRIED = True
    src_c = os.path.join(_HERE, "candidates_native.c")
    so = _compile(src_c, "_candidates_native.so")
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    c_ll = ctypes.c_longlong
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(c_ll)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p2 = ctypes.POINTER(ctypes.c_uint32)
    lib.region_has2_filter.restype = c_ll
    lib.region_has2_filter.argtypes = [
        i32p, i64p, c_ll, ctypes.c_int, ctypes.c_int, c_ll, c_ll,
        u8p, u8p]
    lib.expand_postings.restype = c_ll
    lib.expand_postings.argtypes = [i64p, i64p, c_ll, i64p, i64p]
    lib.expand_postings_fused.restype = c_ll
    lib.expand_postings_fused.argtypes = [
        i64p, i64p, i32p, i32p, i64p, c_ll, u32p2, i64p, i32p, i32p]
    i8p2 = ctypes.POINTER(ctypes.c_int8)
    lib.pass1_suppress.restype = None
    lib.pass1_suppress.argtypes = [
        i64p, c_ll, i32p, i8p2, i32p, i64p, i64p, i64p, i64p, i64p, u8p]
    try:                            # absent only in a stale prebuilt .so
        lib.pass1_suppress_flags.restype = None
        lib.pass1_suppress_flags.argtypes = [
            i64p, c_ll, i32p, i8p2, i32p, i64p, i64p, i64p, i64p, i64p,
            u8p, u8p, u8p]
    except AttributeError:
        pass
    lib.topk_select_batch.restype = c_ll
    lib.topk_select_batch.argtypes = [
        i64p, i64p, c_ll, i64p, c_ll, i64p, i64p]
    lib.anchors_from_postings.restype = c_ll
    lib.anchors_from_postings.argtypes = [
        i32p, i64p, i32p, i32p, u8p, c_ll,      # rid, x, y, ln, keep, n
        i64p, c_ll,                             # rlen, max_rlen
        i64p, c_ll,                             # contig_offsets, n_contigs
        ctypes.c_int,                           # collapse
        i32p, i64p, i32p, i32p, i32p, i32p]     # out rid,x,y,ln,wt,cn
    lib.anchors_from_csr.restype = c_ll
    lib.anchors_from_csr.argtypes = [
        i64p, i64p, i32p, i32p, i32p, i32p,     # fl, base, rows, kcols,
        c_ll, c_ll,                             #   spans, seedno; n_lists,
        i64p,                                   #   total; minpos
        ctypes.POINTER(u32p2),                  # positions (per seed)
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # use_region, bits, ovl
        i64p, c_ll,                             # rlen, max_rlen
        i64p, c_ll,                             # contig_offsets, n_contigs
        ctypes.c_int, ctypes.c_int,             # collapse, shift
        i32p, i64p, i32p, i32p, i32p, i32p]     # out rid,x,y,ln,wt,cn
    lib.anchors_from_csr_rm.restype = c_ll
    lib.anchors_from_csr_rm.argtypes = [
        i64p, i64p, i32p, i32p, i32p, i32p,     # fl, base, rows, kcols,
        c_ll, c_ll,                             #   spans, seedno; n_lists,
        i64p,                                   #   max_read_total; minpos
        ctypes.POINTER(u32p2),                  # positions (per seed)
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # use_region, bits, ovl
        i64p, c_ll,                             # rlen, max_rlen
        i64p, c_ll,                             # contig_offsets, n_contigs
        ctypes.c_int,                           # collapse
        i32p, i64p, i32p, i32p, i32p, i32p]     # out rid,x,y,ln,wt,cn
    lib.hit_list_from_anchors.restype = c_ll
    lib.hit_list_from_anchors.argtypes = [
        i32p, i8p2, i64p, i32p, i32p, i32p, i32p, u8p, c_ll,
        i64p, i64p,                             # rlen, wlen per read
        i64p, i64p,                             # contig offsets, lens
        ctypes.c_int, ctypes.c_int, ctypes.c_int,   # match, bgo, bge
        ctypes.c_double, ctypes.c_int, ctypes.c_int,  # thr, gapless, mm
        i32p, i8p2, i32p, i64p, i32p, i32p, i32p, i32p,
        i64p, i64p, i32p, i32p]
    _CAND_LIB = lib
    return lib
