"""DNA/colour-space codecs — the L0 data model.

Sequences are stored as **unpacked int8 arrays of 4-bit base codes** (one code
per element).  The reference packs 8 bases per uint32 word to save RAM
(`common/util.h:40-42` EXTRACT/BPTO32BW); on TPU an int8 plane is the natural
layout: it gathers and compares vectorially and XLA lays it out tiled in HBM.

Base-code table (matches `common/fasta.h:26-48`):
    0..3   A C G T          (2-bit proper bases; colour space reuses 0..3)
    4      U                (RNA)
    5..14  IUPAC ambiguity  M R W S Y K V H D B
    15     N / X            (any base)

Colour-space: colour(a, b) = a XOR b for proper bases (the colourmat in
`common/util.h:184-209` is exactly 2-bit XOR); anything non-ACGT maps to N.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Base codes (common/fasta.h:26-48)
# ---------------------------------------------------------------------------
BASE_A, BASE_C, BASE_G, BASE_T = 0, 1, 2, 3
BASE_U = 4
BASE_M, BASE_R, BASE_W, BASE_S, BASE_Y, BASE_K = 5, 6, 7, 8, 9, 10
BASE_V, BASE_H, BASE_D, BASE_B = 11, 12, 13, 14
BASE_X = 15
BASE_N = 15

BASE_0, BASE_1, BASE_2, BASE_3 = 0, 1, 2, 3  # colour space

LETTER_SPACE = 1
COLOUR_SPACE = 2

# int→char render tables (common/fasta.c:45-58, base_translate cstrans/lstrans)
LS_CHARS = np.frombuffer(b"ACGTUMRWSYKVHDBN", dtype=np.uint8)
CS_CHARS = np.frombuffer(b"0123!@#$%^&*?~;.", dtype=np.uint8)

# char→int translate table (common/fasta.c:28-43).  -1 = invalid.
CHAR_TO_CODE = np.full(256, -1, dtype=np.int8)


def _fill_char_table() -> None:
    for ch, code in [
        ("A", BASE_A), ("B", BASE_B), ("C", BASE_C), ("D", BASE_D),
        ("G", BASE_G), ("H", BASE_H), ("K", BASE_K), ("M", BASE_M),
        ("N", BASE_N), ("R", BASE_R), ("S", BASE_S), ("T", BASE_T),
        ("U", BASE_U), ("V", BASE_V), ("W", BASE_W), ("X", BASE_X),
        ("Y", BASE_Y),
    ]:
        CHAR_TO_CODE[ord(ch)] = code
        CHAR_TO_CODE[ord(ch.lower())] = code
    for ch, code in [("0", BASE_0), ("1", BASE_1), ("2", BASE_2), ("3", BASE_3)]:
        CHAR_TO_CODE[ord(ch)] = code
    CHAR_TO_CODE[ord(".")] = BASE_N   # skipped colour cycle
    CHAR_TO_CODE[ord("4")] = BASE_N   # '4' == missing colour read-out


_fill_char_table()

# complement table (common/util.h:129-146); DNA (not RNA) variant
COMPLEMENT = np.array(
    [BASE_T, BASE_G, BASE_C, BASE_A,   # A C G T
     BASE_A,                           # U -> A
     BASE_K, BASE_Y, BASE_W, BASE_S, BASE_R, BASE_M,   # M R W S Y K
     BASE_B, BASE_D, BASE_H, BASE_V,   # V H D B
     BASE_N],
    dtype=np.int8,
)


def encode(seq: str | bytes) -> np.ndarray:
    """Translate an ASCII sequence into int8 base codes.

    Raises ValueError on characters outside the IUPAC/colour alphabet
    (the reference exits with an error — `common/fasta.c:649-662`).
    """
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    codes = CHAR_TO_CODE[raw]
    if np.any(codes < 0):
        bad = chr(int(raw[np.argmax(codes < 0)]))
        raise ValueError(f"invalid sequence character {bad!r}")
    return codes


def decode(codes: np.ndarray, space: int = LETTER_SPACE) -> str:
    """Render int8 base codes back to an ASCII string."""
    table = LS_CHARS if space == LETTER_SPACE else CS_CHARS
    return table[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a letter-space sequence (common/util.h:127-152)."""
    return COMPLEMENT[np.asarray(codes)][::-1].copy()


def letters_to_colours(codes: np.ndarray, init_base: int = BASE_T) -> np.ndarray:
    """Translate letter space to colour space.

    colour[i] = letters[i-1] XOR letters[i] with letters[-1] = init_base; any
    non-ACGT participant yields N (mirrors `bitfield_to_colourspace`,
    `common/fasta.c:590-610`, whose initial `lastbp` is BASE_T).
    """
    codes = np.asarray(codes, dtype=np.int8)
    prev = np.concatenate(([np.int8(init_base)], codes[:-1]))
    col = (prev ^ codes).astype(np.int8)
    bad = (prev > BASE_T) | (codes > BASE_T)
    return np.where(bad, np.int8(BASE_N), col)


def colours_to_letters(colours: np.ndarray, init_base: int) -> np.ndarray:
    """Decode a colour sequence given its initial letter (cstols chain,
    `common/util.h:159-181`).  N colours poison the rest of the read to N."""
    out = np.empty(len(colours), dtype=np.int8)
    last = init_base
    for i, c in enumerate(np.asarray(colours)):
        if last == BASE_N or not (0 <= c <= 3):
            last = BASE_N
        else:
            last = last ^ int(c)
        out[i] = last
    return out


def lstocs(a: int | np.ndarray, b: int | np.ndarray) -> np.ndarray:
    """Colour between two letters: XOR for proper bases, else N
    (`common/util.h` lstocs / colourmat)."""
    a = np.asarray(a, dtype=np.int8)
    b = np.asarray(b, dtype=np.int8)
    return np.where((a > BASE_T) | (b > BASE_T), np.int8(BASE_N),
                    (a ^ b).astype(np.int8))


def complement_base(a: int) -> int:
    """Complement of one proper base (A<->T, C<->G)."""
    return int(COMPLEMENT[a])


def reverse_complement_read_cs(colours: np.ndarray, initbp: int,
                               initbp_rc: int) -> np.ndarray:
    """Reverse complement of a colour-space read
    (`common/util.c:615-632` reverse_complement_read_cs).

    Interior colours are strand-symmetric, so colours 1..n-1 simply reverse;
    colour 0 of the RC read is the colour between the read's final decoded
    letter and the complement of the RC primer base."""
    colours = np.asarray(colours, dtype=np.int8)
    n = len(colours)
    if n and (((colours < 0) | (colours > 3)).any()):
        last = BASE_N
    elif n:
        last = initbp ^ int(np.bitwise_xor.reduce(colours))
    else:
        last = initbp
    rc = np.empty(n, dtype=np.int8)
    rc[1:] = colours[1:][::-1]
    rc[0] = lstocs(last, complement_base(initbp_rc))
    return rc


def reverse_complement_cs(colours: np.ndarray) -> np.ndarray:
    """Reverse a colour-space sequence (interior colours only — use
    reverse_complement_read_cs for whole reads with a primer base)."""
    return np.asarray(colours)[::-1].copy()


def is_proper(codes: np.ndarray) -> np.ndarray:
    """Boolean mask of proper (unambiguous ACGT / 0-3) positions."""
    return np.asarray(codes) <= BASE_T
