"""Cross-cutting utilities: profiling scopes, debug dumps."""

from .profiling import phase_timer, named_scope, trace
from .debug import printbin, dump_lanes

__all__ = [
    "phase_timer", "named_scope", "trace",
    "printbin", "dump_lanes",
]
