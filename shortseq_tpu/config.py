"""Runtime configuration (SURVEY.md section 5: the reference has no runtime
config - compile-time CPU flags only - so this dataclass is this build's
single knob surface).

Domain constants (32/96/1024 widths) are NOT configurable: they are part of
the bit-exact parity contract (constants.py).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PipelineConfig:
    """Knobs for the FASTQ -> pack -> count pipelines."""

    # Reads per device batch in streaming pipelines.  Batches are padded to
    # this size so every chunk reuses one compiled program.
    batch_size: int = 1 << 18

    # Width-class bucket edges in nts (parity-fixed; here for introspection).
    bucket_widths: tuple = (32, 96, 1024)

    # Pad row counts to powers of two (>= min_batch_pad) in the object-API
    # count path, trading a little sort work for compile-cache hits.
    min_batch_pad: int = 256

    # Directory for count-table checkpoints (None disables spilling).
    checkpoint_dir: str | None = None


DEFAULT_CONFIG = PipelineConfig()
