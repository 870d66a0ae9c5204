"""On-demand build + load of the _native C extension
(csrc/shortseq_native.cpp).

No pip/pybind11 in the target image, so the extension compiles with plain
g++ against the running interpreter's headers (sysconfig) into a cache
directory and loads via importlib's extension loader.  Any failure makes
the package fall back to the pure-Python object layer with identical
semantics (api/seq.py) - the build is an optimization, never a
requirement.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "shortseq_native.cpp"
_CACHE_DIR = Path(os.environ.get(
    "SHORTSEQ_TPU_CACHE", Path.home() / ".cache" / "shortseq_tpu"))

_lock = threading.Lock()
_module = None
_tried = False


def isa_token() -> str:
    """Host-ISA component of the cache key.  Builds use -march=native, so
    a cache directory shared between heterogeneous hosts (NFS $HOME on a
    multi-host cluster) must not serve one host's library to another - the
    CPU flag set identifies the ISA exactly."""
    import hashlib
    import platform

    probe = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    probe += line
                    break
    except OSError:
        pass
    return hashlib.sha256(probe.encode()).hexdigest()[:8]


def _so_path() -> Path:
    # Content-hashed cache key, not mtime: timestamp-preserving deploys
    # (tar -x, rsync -a) would otherwise revive a stale build whose symbol
    # table no longer matches this source.
    import hashlib

    tag = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _CACHE_DIR / f"_native_{digest}_{isa_token()}{tag}"


def _build() -> Path | None:
    if not _SRC.exists():
        # Installed wheel without csrc/ and without the compiled _native
        # extension (no compiler at install time): pure-Python fallback.
        return None
    so = _so_path()
    if so.exists():
        return so
    _CACHE_DIR.mkdir(parents=True, exist_ok=True)
    include = sysconfig.get_paths()["include"]
    # Compile to a private temp name and publish with an atomic rename so
    # a concurrent process never loads a half-written extension and a
    # killed g++ never poisons the cache path.
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        f"-I{include}", str(_SRC), "-o", str(tmp),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=180)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    return so


def load():
    """The _native module, or None when it cannot be built/loaded."""
    global _module, _tried
    with _lock:
        if _tried:
            return _module
        _tried = True
        if os.environ.get("SHORTSEQ_TPU_FORCE_PYTHON", "") == "1":
            return None
        # Prefer an installed/in-place extension (setup.py build_ext).
        try:
            from shortseq_tpu import _native as mod  # type: ignore

            _module = mod
            return _module
        except ImportError:
            pass
        so = _build()
        if so is None:
            return None
        try:
            loader = importlib.machinery.ExtensionFileLoader(
                "shortseq_tpu._native", str(so))
            spec = importlib.util.spec_from_loader(
                "shortseq_tpu._native", loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
        except Exception:
            # A corrupt cached extension must degrade to the pure-Python
            # layer, and dropping it lets the next run rebuild cleanly.
            so.unlink(missing_ok=True)
            return None
        _module = mod
        return _module
