"""Device mesh construction and multi-host bring-up.

One mesh axis is all this domain needs (SURVEY.md section 2): reads are
independent, blocks of one read live in the lane axis on a single device,
so `data` is the only distributed dimension.  The cards of one host are
joined all to all by NVLink, so a flat 1-D mesh in device order is as
good as any other; across hosts XLA (NCCL) routes the collectives.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh


def initialize_distributed(**kwargs) -> None:
    """Multi-controller bring-up (`jax.distributed.initialize`).

    Must run before any JAX computation, so the decision cannot consult
    jax.process_count() (which itself initializes the backend).  The call
    happens when the caller passes explicit kwargs (coordinator_address
    etc.) or when a coordinator address is present in the environment
    (COORDINATOR_ADDRESS or JAX_COORDINATOR_ADDRESS); single-process runs
    are a no-op.  Safe to call twice - an already-initialized runtime is
    left alone.

    The reference has no equivalent - it is single-process by construction.
    """
    import os

    env_addr = os.environ.get("COORDINATOR_ADDRESS") or None
    want = bool(kwargs) or env_addr is not None \
        or bool(os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if not want:
        return
    # Idempotency without message matching: jax's double-init errors say
    # "should only be called once" / "must be called before any JAX
    # calls", neither containing a stable keyword, so consult the runtime
    # state directly (with the message check as a fallback if the private
    # attribute moves).
    try:
        from jax._src import distributed as _dist

        if getattr(_dist.global_state, "client", None) is not None:
            return
    except Exception:
        pass
    # jax reads JAX_COORDINATOR_ADDRESS itself; the other marker vars must
    # be forwarded explicitly or initialize() would auto-detect nothing.
    if env_addr is not None and "coordinator_address" not in kwargs:
        kwargs = dict(kwargs, coordinator_address=env_addr)
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        msg = str(e).lower()
        if "already" not in msg and "once" not in msg:
            raise


def data_mesh(devices=None) -> Mesh:
    """A 1-D `data` mesh over the given (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    import numpy as np

    return Mesh(np.asarray(devices), axis_names=("data",))
