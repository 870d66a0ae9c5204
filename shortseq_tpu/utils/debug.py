"""Debug helpers: binary dumps of packed words.

The device-layout analog of the reference's printbin/pext-chunk visualizers
(reference util.pxd:73-85, tests/util.py:6-25): render packed lanes or
blocks as grouped binary so bit-layout bugs are visible at a glance."""

from __future__ import annotations

import numpy as np


def printbin(value: int, bits: int = 64, group: int = 2) -> str:
    """One word as binary, LSB-first groups of `group` bits (2 bits = one
    nucleotide), matching how the packing actually fills the word."""
    raw = format(value & ((1 << bits) - 1), f"0{bits}b")[::-1]
    chunks = [raw[i:i + group] for i in range(0, bits, group)]
    return " ".join(c[::-1] for c in chunks)


def dump_lanes(words, lengths=None, max_rows: int = 8) -> str:
    """Render a `[N, W]` uint32 lane matrix row by row; each lane shown as
    16 nucleotide codes (2-bit groups, LSB-first)."""
    words = np.asarray(words)
    out = []
    for i, row in enumerate(words[:max_rows]):
        parts = [printbin(int(lane), bits=32) for lane in row]
        suffix = f"  len={int(lengths[i])}" if lengths is not None else ""
        out.append(f"row {i}: " + " | ".join(parts) + suffix)
    if len(words) > max_rows:
        out.append(f"... ({len(words) - max_rows} more rows)")
    return "\n".join(out)
