"""Tracing / profiling hooks (SURVEY.md section 5).

The reference's observability is compile-time line tracing plus ad-hoc
phase prints (reference setup.py:36-37, counter.pyx:62-70).  The equivalents
here: jax.profiler trace contexts around pipeline phases,
jax.named_scope on kernels so they are identifiable in XLA traces, and a
lightweight phase timer whose output feeds the bench metrics."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class PhaseTimings:
    """Accumulated wall times per phase, in seconds."""

    phases: dict = field(default_factory=dict)

    def add(self, name: str, seconds: float) -> None:
        self.phases[name] = self.phases.get(name, 0.0) + seconds

    def report(self) -> str:
        return ", ".join(f"{k}: {v:.2f}s" for k, v in self.phases.items())


@contextlib.contextmanager
def phase_timer(name: str, timings: PhaseTimings | None = None,
                echo: bool = False):
    """Wall-time a pipeline phase; optionally accumulate and/or print
    (the reference's phase prints, counter.pyx:70)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if timings is not None:
            timings.add(name, dt)
        if echo:
            print(f"{name}: {dt:.2f}s")


@contextlib.contextmanager
def named_scope(name: str):
    """jax.named_scope passthrough that degrades to a no-op when jax is
    unavailable (host-only tooling contexts).  Only the jax import is
    guarded - an ImportError raised by the caller's own block must
    propagate, not re-enter the generator."""
    try:
        import jax
    except ImportError:
        yield
        return
    with jax.named_scope(name):
        yield


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context around a pipeline run; view the result
    with TensorBoard or xprof."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
