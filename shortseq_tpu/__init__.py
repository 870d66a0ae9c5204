"""shortseq_tpu - a short-sequence encoding engine on JAX.

A from-scratch JAX/XLA framework with the capabilities of the
reference ShortSeq library (see SURVEY.md): 2-bit packing of A/C/T/G reads
into 64/192/variable-width words, lazy decoding, validated input, XOR +
popcount hamming distance, Counter-style exact deduplication, a FASTQ
pipeline, and UMI deduplication - plus what the reference does not have:
batched device ops and multi-device data-parallel dedup with
collective merges over a jax.sharding.Mesh.

Public surface matches the reference package (reference
shortseq/__init__.py:1-14) and adds the batch/device APIs.
"""

import os as _os


def compile_cache_dir(environ=_os.environ):
    """The directory this package points JAX's persistent compilation
    cache at, or None when it sets nothing: JAX_COMPILATION_CACHE_DIR is
    set (JAX reads it itself), SHORTSEQ_TPU_NO_CACHE=1, or the package is
    not running from a source checkout.  In a checkout the cache is the
    fixed directory `<checkout>/.jax_cache` - the path is part of the
    cache key, so it never varies between runs."""
    if environ.get("JAX_COMPILATION_CACHE_DIR") \
            or environ.get("SHORTSEQ_TPU_NO_CACHE") == "1":
        return None
    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    if not _os.path.exists(_os.path.join(root, "pyproject.toml")):
        return None
    return _os.path.join(root, ".jax_cache")


def _configure_compile_cache():
    import jax

    # Respect an application that already configured the process-wide
    # cache: an import must not repoint another library's cache.
    path = compile_cache_dir()
    if path is None or jax.config.jax_compilation_cache_dir:
        return
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


_configure_compile_cache()

from .api import (
    pack,
    from_str,
    from_bytes,
    empty,
    ShortSeq64,
    ShortSeq192,
    ShortSeqVar,
    ShortSeqCounter,
    read_and_count_fastq,
    read_and_count_fastq_table,
    get_domain_64,
    get_domain_192,
    get_domain_var,
    BACKEND,
)

from .batch import PackedBatch, pack_batch
from .count import CountTable

MIN_VAR_NT, MAX_VAR_NT = get_domain_var()
MIN_192_NT, MAX_192_NT = get_domain_192()
MIN_64_NT, MAX_64_NT = get_domain_64()

__version__ = "0.1.0"

__all__ = [
    "pack", "from_str", "from_bytes", "empty",
    "ShortSeq64", "ShortSeq192", "ShortSeqVar",
    "ShortSeqCounter", "read_and_count_fastq",
    "read_and_count_fastq_table", "CountTable",
    "MIN_64_NT", "MAX_64_NT", "MIN_192_NT", "MAX_192_NT",
    "MIN_VAR_NT", "MAX_VAR_NT", "BACKEND",
    "PackedBatch", "pack_batch",
]
