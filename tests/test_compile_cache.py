"""Where the package points JAX's persistent compilation cache."""

import os

import shortseq_tpu
from tests.conftest import REPO_ROOT


def test_variable_set_means_nothing_is_set_in_code():
    assert shortseq_tpu.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}) is None


def test_variable_unset_means_the_checkout_cache():
    assert shortseq_tpu.compile_cache_dir({}) == os.path.join(
        REPO_ROOT, ".jax_cache")


def test_opt_out_sets_nothing():
    assert shortseq_tpu.compile_cache_dir({"SHORTSEQ_TPU_NO_CACHE": "1"}) \
        is None


def test_this_process_uses_the_rule():
    import jax

    want = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or shortseq_tpu.compile_cache_dir())
    assert jax.config.jax_compilation_cache_dir == want
