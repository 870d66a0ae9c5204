"""All-pairs Hamming: the formulations and the measured choice among them.

Two bit-exact formulations of `[N, W] x [M, W] -> [N, M]`:

* ``jnp`` - broadcast XOR + collapse + popcount + sum over W
  (ops.hamming.hamming_pairwise).  XLA fuses the chain, so the [N, M, W]
  intermediate is never written, and inside umi/dedup._adjacency_score
  the threshold, masks and score fuse into the same kernel.
* ``mxu`` - one-hot codes through one bf16 matrix product
  (ops.hamming.hamming_pairwise_mxu).

pairwise_hamming_auto picks one per (device kind, lane width) from a
one-time measurement (calibrate_pairwise).  Nothing here falls back: a
formulation that fails raises.  A tiled XOR+popcount Pallas kernel
(Triton route) was measured against both on the H100 and deleted: it
cannot fuse with its consumer and won at no lane width (docs/PERF.md).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .hamming import hamming_pairwise, hamming_pairwise_mxu

#: The formulations by name (the calibration's candidates).
_FORMULATIONS = {"mxu": hamming_pairwise_mxu, "jnp": hamming_pairwise}

#: Which formulation the last pairwise_hamming_auto call used.
LAST_PAIRWISE_PATH: str | None = None


#: Calibrated winner per (platform, device_kind, lane width); see
#: _calibrated_choice.  Exposed for tests/benches.
_CALIBRATION: dict[str, str] = {}
_CALIB_VERSION = "v3"
# Calibration problem shape: [rows, w] x [cols, w], mimicking the UMI
# neighbour-extraction slabs (a small row block against the full unique
# table) rather than a square toy problem.
_CALIB_ROWS, _CALIB_COLS = 512, 16384


def _calib_file():
    import os

    return os.path.join(
        os.path.expanduser("~/.cache/shortseq_tpu"),
        f"pairwise_calib_{_CALIB_VERSION}.json")


def _measure_pairwise(fn, a, b, repeats: int = 3,
                      k_lo: int = 2, k_hi: int = 128) -> float:
    """Per-call seconds via slope timing: k iterations run inside one
    compiled fori_loop (the operand XORed with the loop index defeats
    hoisting, the result folded into a carried scalar defeats dead-code
    elimination), and the reported time is the slope between a k_lo- and
    a k_hi-iteration dispatch.  Launch, the scalar fetch that waits for
    the result, and the host's timer jitter are fixed costs per dispatch
    and cancel; at calibration sizes they are of the order of the
    per-iteration kernel time itself.
    """
    import time

    @jax.jit
    def loop(a, b, k):
        def body(i, acc):
            x = a ^ i.astype(jnp.uint32)
            # XOR fold, never a sum: consuming a dot through a plain sum
            # lets XLA's algebraic simplifier rewrite reduce(dot) into
            # dot(reduce) and skip the matmul entirely.  XOR blocks the
            # rewrite for every formulation while still allowing the
            # elementwise fusion the production consumers
            # (umi._adjacency_score) get.
            return acc ^ jnp.bitwise_xor.reduce(fn(x, b).ravel())
        return jax.lax.fori_loop(0, k, body, jnp.int32(0))

    lo, hi = jnp.int32(k_lo), jnp.int32(k_hi)
    jax.device_get(loop(a, b, hi))  # compile + warm outside the timer
    t_lo = t_hi = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.device_get(loop(a, b, lo))
        t1 = time.perf_counter()
        jax.device_get(loop(a, b, hi))
        t_lo = min(t_lo, t1 - t0)
        t_hi = min(t_hi, time.perf_counter() - t1)
    slope = (t_hi - t_lo) / (k_hi - k_lo)
    # Jitter can still invert a span on a loaded host; an inverted sample
    # is a corrupted measurement, so it must lose to every honest one
    # (clamping small-positive would instead make it the guaranteed
    # winner) - calibrate_pairwise drops non-finite entries.
    return slope if slope > 0 else float("inf")


def calibrate_pairwise(width: int, platform: str | None = None,
                       force: bool = False):
    """Measure every pairwise-hamming formulation at this lane width on
    the current backend and return {name: seconds}; the winner is cached
    in memory and on disk (keyed by platform/device kind/width) so one
    process per machine pays the measurement.  A formulation that fails
    to compile or run raises: it is never silently dropped."""
    import json
    import math
    import os

    import numpy as np

    if platform is None:
        platform = jax.devices()[0].platform
    kind = getattr(jax.devices()[0], "device_kind", platform)
    key = f"{platform}/{kind}/w{width}"
    path = _calib_file()
    if not force:
        if key in _CALIBRATION:
            return None
        try:
            with open(path) as f:
                disk = json.load(f)
            if key in disk:
                _CALIBRATION[key] = disk[key]["winner"]
                return disk[key]["times"]
        except (OSError, ValueError):
            pass

    # The measurement below costs seconds of synchronous wall time hidden
    # inside the first pairwise call - say so once instead of looking
    # like a hang.
    import logging

    logging.getLogger(__name__).info(
        "shortseq_tpu: one-time pairwise-hamming calibration for %s "
        "(a few seconds; cached at %s; pre-warm explicitly with "
        "calibrate_pairwise(width), or pin a path with "
        "SHORTSEQ_TPU_PAIRWISE)", key, path)

    rng = np.random.default_rng(0)
    # On the CPU (CI, dev laptops) the full-size calibration costs a
    # minute+ of first-call latency per width; a 16x-smaller problem with
    # short loops still ranks the formulations there.  Accelerators
    # calibrate at the production slab shape.  k_hi keeps the slope span
    # well above the host's timer jitter in both cases.
    on_cpu = platform == "cpu"
    rows, cols = ((_CALIB_ROWS // 4, _CALIB_COLS // 4) if on_cpu
                  else (_CALIB_ROWS, _CALIB_COLS))
    k_hi = 48 if on_cpu else 128
    a = jnp.asarray(rng.integers(0, 2**32, size=(rows, width),
                                 dtype=np.uint64).astype(np.uint32))
    b = jnp.asarray(rng.integers(0, 2**32, size=(cols, width),
                                 dtype=np.uint64).astype(np.uint32))
    times = {}
    for name, fn in _FORMULATIONS.items():
        t = _measure_pairwise(fn, a, b, k_hi=k_hi)
        if math.isfinite(t):
            times[name] = t  # inverted (jitter-corrupted) samples dropped
    if not times:
        raise RuntimeError(
            f"pairwise calibration for {key}: every timing sample was "
            "inverted by host jitter; no formulation could be ranked")
    winner = min(times, key=times.get)
    # Multi-controller runs: timing jitter could pick DIFFERENT winners
    # per process (bit-exact either way, but latency skews and collective
    # programs built around the choice would diverge).  Process 0's
    # winner is broadcast so every process agrees.
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        order = sorted(_FORMULATIONS)
        idx = np.int32(order.index(winner))
        idx = int(multihost_utils.broadcast_one_to_all(idx))
        winner = order[idx]
    _CALIBRATION[key] = winner
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # O_EXCL lock around the read-modify-write: concurrent first-run
        # processes calibrating different widths would otherwise drop
        # each other's entries (last writer wins) and force a later
        # re-calibration.  A stale lock (killed process) is ignored after
        # 30 s - the cache is an optimization, never a correctness
        # requirement.
        lock = f"{path}.lock"
        import time as _time

        got_lock = False
        for _ in range(100):
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
                got_lock = True
                break
            except FileExistsError:
                try:
                    if _time.time() - os.path.getmtime(lock) > 30:
                        os.unlink(lock)
                        continue
                except OSError:
                    pass
                _time.sleep(0.05)
        try:
            try:
                with open(path) as f:
                    disk = json.load(f)
            except (OSError, ValueError):
                disk = {}
            disk[key] = {"winner": winner, "times": times}
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(disk, f)
            os.replace(tmp, path)
        finally:
            if got_lock:
                try:
                    os.unlink(lock)
                except OSError:
                    pass
    except OSError:
        pass  # disk cache is an optimization, never a requirement
    return times


def _calibrated_choice(width: int, platform: str) -> str:
    kind = getattr(jax.devices()[0], "device_kind", platform)
    key = f"{platform}/{kind}/w{width}"
    if key not in _CALIBRATION:
        calibrate_pairwise(width, platform)
    return _CALIBRATION[key]


def pairwise_formulation(width: int) -> str:
    """The formulation pairwise_hamming_auto uses at this lane width: the
    SHORTSEQ_TPU_PAIRWISE override (mxu|jnp) if set, else the
    calibrated winner, calibrating now if needed.  Calibration times
    compiled programs, so it cannot run inside a trace: callers that use
    pairwise_hamming_auto inside jit resolve the width here first."""
    import os

    choice = os.environ.get("SHORTSEQ_TPU_PAIRWISE", "")
    if choice in _FORMULATIONS:
        return choice
    return _calibrated_choice(width, jax.devices()[0].platform)


def pairwise_hamming_auto(a: jax.Array, b: jax.Array) -> jax.Array:
    """The measured-fastest pairwise formulation for this backend and lane
    width (see the module docstring and pairwise_formulation).  All are
    bit-exact.  The chosen formulation runs as it is: an error
    propagates."""
    global LAST_PAIRWISE_PATH
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    choice = pairwise_formulation(a.shape[1])
    LAST_PAIRWISE_PATH = choice
    return _FORMULATIONS[choice](a, b)
