"""Spaced seeds — parsing, validation, default seed sets.

A spaced seed is a 0/1 pattern; the '1' positions ("weight" of them, spread
over "span" characters) are the sampled bases of each k-mer.  Semantics mirror
`gmapper/seeds.c:12-49` (parser) and `gmapper/gmapper-defaults.h:194-238`
(default sets), but the representation is an index array ready for vectorized
gathers instead of a bitmask walked bit-by-bit.

Optionally a seed carries a position list ("1101:0|3|7") restricting which
read offsets the seed fires at (`gmapper/seeds.c:21-47`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MAX_SEED_SPAN = 64           # gmapper/gmapper-definitions.h:50-53
MAX_SEED_WEIGHT = 14         # above this, hashing (-H) is required
MAX_HASH_SEED_SPAN = 64
HASH_TABLE_POWER = 24        # 2^24 buckets in -H mode (gmapper/gmapper.h:324-337)


@dataclass(frozen=True)
class Seed:
    """One spaced seed: pattern + derived gather indices."""

    pattern: str                      # e.g. "111100110001111"
    span: int
    weight: int
    ones_idx: np.ndarray              # int32[weight]: offsets of '1's in pattern
    positions: np.ndarray | None = field(default=None)  # allowed read offsets

    def __str__(self) -> str:  # seed_to_string (gmapper/seeds.c:139)
        return self.pattern


def parse_seed(seed_string: str) -> Seed:
    """Parse "110101..." or "110101...:p0|p1|..." into a Seed.

    Raises ValueError on malformed/oversized patterns (the reference returns
    false from `parse_spaced_seed` and the caller aborts).
    """
    positions = None
    pattern = seed_string
    if ":" in seed_string:
        pattern, pos_part = seed_string.split(":", 1)
        positions = np.array(sorted(int(p) for p in pos_part.split("|")),
                             dtype=np.int32)
    span = len(pattern)
    weight = pattern.count("1")
    if span < 1 or span > MAX_SEED_SPAN:
        raise ValueError(f"seed span {span} out of range [1,{MAX_SEED_SPAN}]")
    if weight < 1:
        raise ValueError("seed must contain at least one '1'")
    if pattern.count("0") != span - weight:
        raise ValueError(f"invalid characters in seed pattern {pattern!r}")
    ones_idx = np.array([i for i, ch in enumerate(pattern) if ch == "1"],
                        dtype=np.int32)
    return Seed(pattern=pattern, span=span, weight=weight, ones_idx=ones_idx,
                positions=positions)


# ---------------------------------------------------------------------------
# Default seed sets (gmapper/gmapper-defaults.h:194-238).  The same sets are
# used for letter and colour space in v2.2.x.
# ---------------------------------------------------------------------------
DEFAULT_SEEDS_MIN_WEIGHT = 10
DEFAULT_SEEDS_MAX_WEIGHT = 18
DEFAULT_SEEDS_WEIGHT = 12

_DEFAULT_SEED_SETS: dict[int, list[str]] = {
    10: ["111110011111", "111100110001111", "111100100100100111",
         "111001000100001001111"],
    11: ["1111001111111", "1111100110001111", "11110010010001001111",
         "11100110010000100100111"],
    12: ["11110111101111", "1111011100100001111", "1111000011001101111"],
    16: ["111111101110111111", "1111100101101101011111",
         "11110011001010100011011111", "111101001100000100110011010111"],
    18: ["11111011111110111111", "11110111011010111011111",
         "11111100110101101001011111", "11111010101100100010011101111"],
}

MIRNA_SEEDS = [
    "00111111001111111100",
    "00111111110011111100",
    "00111111111100111100",
    "00111111111111001100",
    "00111111111111110000",
]


def default_seeds(weight: int = 0) -> list[Seed]:
    """Load the default seed set for a given weight (0 = framework default).

    Mirrors `load_default_seeds` (gmapper/seeds.c:87-115).
    """
    if weight == 0:
        weight = DEFAULT_SEEDS_WEIGHT
    if not DEFAULT_SEEDS_MIN_WEIGHT <= weight <= DEFAULT_SEEDS_MAX_WEIGHT:
        raise ValueError(
            f"no default seeds of weight {weight}; available range: "
            f"[{DEFAULT_SEEDS_MIN_WEIGHT}, {DEFAULT_SEEDS_MAX_WEIGHT}]")
    # in-range weights with no table entry add NO seeds (the reference's
    # cnt==0 rows, gmapper-defaults.h:197); the caller then falls back to
    # the default-weight set when it ends up with zero seeds
    specs = _DEFAULT_SEED_SETS.get(weight, [])
    if not specs:
        specs = _DEFAULT_SEED_SETS[DEFAULT_SEEDS_WEIGHT]
    return [parse_seed(s) for s in specs]


def mirna_seeds() -> list[Seed]:
    """Seed set used by `-M mirna` (gmapper/seeds.c:79-85)."""
    return [parse_seed(s) for s in MIRNA_SEEDS]


@dataclass(frozen=True)
class SeedSet:
    """A validated collection of seeds plus aggregate geometry."""

    seeds: tuple[Seed, ...]
    use_hashing: bool = False         # -H mode: 24-bit hashed buckets

    @property
    def n_seeds(self) -> int:
        return len(self.seeds)

    @property
    def max_span(self) -> int:
        return max(s.span for s in self.seeds)

    @property
    def min_span(self) -> int:
        return min(s.span for s in self.seeds)

    def table_sizes(self) -> list[int]:
        """Posting-table bucket count per seed (4^weight, or 2^24 hashed)."""
        if self.use_hashing:
            return [1 << HASH_TABLE_POWER] * len(self.seeds)
        return [1 << (2 * s.weight) for s in self.seeds]

    def validate(self) -> None:
        """valid_spaced_seeds (gmapper/seeds.c:160-173): unhashed seeds are
        capped at weight 14 (table 4^w), hashed at span 64."""
        for s in self.seeds:
            if not self.use_hashing and s.weight > MAX_SEED_WEIGHT:
                raise ValueError(
                    f"seed {s.pattern} weight {s.weight} > {MAX_SEED_WEIGHT}; "
                    f"use hashing")
            if self.use_hashing and s.span > MAX_HASH_SEED_SPAN:
                raise ValueError(f"seed {s.pattern} span too large for hashing")


def make_seed_set(specs: list[str] | None = None, weight: int = 0,
                  use_hashing: bool = False) -> SeedSet:
    seeds = ([parse_seed(s) for s in specs] if specs
             else default_seeds(weight))
    ss = SeedSet(seeds=tuple(seeds), use_hashing=use_hashing)
    ss.validate()
    return ss
