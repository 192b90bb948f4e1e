"""Configuration for the SpMV engine.

The reference (DASP, SC'23) exposes its tunables as compile-time macros and
hard-coded locals (``block_longest=256``, ``threshold=0.75`` in
``main_f64.cu:121-125``; ``BlockSize 8`` / MMA tile shape in ``common.h:28-33``).
Here they are a runtime config.  The packed plan is built from (8 x 128)
tiles: 128 rows side by side, up to 8 elements of each row stacked along
the short axis, instead of the reference's 8-row x K=4 MMA fragment.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


# Tile geometry of the packed plan: every structure is a stack of
# (SUBLANES, LANES) tiles, LANES rows wide.  It is the layout the XLA
# executor reduces over, not a property of any device.
SUBLANES = 8
LANES = 128


@dataclasses.dataclass(frozen=True)
class DaspConfig:
    """Tunables for analysis + packing + kernels.

    Attributes:
      block_longest: rows with ``nnz >= block_longest`` take the long-row
        (chunk + segmented reduction) strategy.  Mirrors the reference default
        (``main_f64.cu:124``).
      threshold: target occupancy of the regular (dense) region of a medium
        SELL slice; the packer picks the widest bucket whose regular region
        stays at least this full, and spills row tails beyond that width.
        Mirrors ``threshold=0.75`` (``main_f64.cu:125``).
      slice_rows: rows per medium SELL slice (the LANES axis of a tile);
        the reference's analog is BlockSize=8 rows per row-block
        (``common.h:29``).
      width_buckets: allowed regular widths of a medium slice, ascending.
        Quantizing widths keeps the number of distinct compiled shapes
        small.  Must be multiples of SUBLANES (whole tiles).
      long_chunk: elements per long-row chunk (a multiple of LANES).  The
        reference chops long rows into 64-nnz warp chunks (``dasp_f64.h:1005``).
      pair_13: enable DASP's trick of pairing 1-nnz with 3-nnz rows into full
        K=4 slots (``dasp_f64.h:597-607``).
      pair_13_min_slots: minimum number of (1,3) pairs, in units of packed
        slots, before pairing is worthwhile.  The reference requires 16 blocks
        of 8 slots (``dasp_f64.h:598``): 128 slots.
    """

    block_longest: int = 256
    threshold: float = 0.75
    slice_rows: int = LANES
    width_buckets: Tuple[int, ...] = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256)
    long_chunk: int = LANES
    pair_13: bool = True
    pair_13_min_slots: int = 128

    def __post_init__(self):
        if self.block_longest < 5:
            raise ValueError("block_longest must be >= 5 (rows with 1..4 nnz "
                             "are handled by the short strategies)")
        if not (0.0 < self.threshold <= 1.0):
            raise ValueError("threshold must be in (0, 1]")
        for w in self.width_buckets:
            if w % SUBLANES != 0:
                raise ValueError(f"width bucket {w} not a multiple of {SUBLANES}")
        if tuple(sorted(self.width_buckets)) != tuple(self.width_buckets):
            raise ValueError("width_buckets must be ascending")
        if self.width_buckets[-1] < self.block_longest:
            raise ValueError(
                "largest width bucket must cover block_longest-1 so any "
                "medium row fits a slice")
        if self.long_chunk % LANES != 0:
            raise ValueError(f"long_chunk must be a multiple of {LANES}")


DEFAULT_CONFIG = DaspConfig()
