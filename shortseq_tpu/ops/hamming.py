"""Batched hamming distance over packed uint32 lanes.

Reference semantics (short_seq_64.pyx:77-84, short_seq_192.pyx:74-91,
short_seq_var.pyx:64-81): per 64-bit block, c = a ^ b;
c = ((c >> 1) | c) & 0x5555...; popcount; summed over blocks.  Complementary
codes XOR to 0b11 and must count once, hence the collapse.

On the device the same math runs on uint32 lanes with
jax.lax.population_count - the collapse never crosses a 2-bit field, so
splitting each block into two lanes is bit-exact.  Lanes past a read's
length are zero in both operands (the pack path zero-fills), so no masking
is needed when lengths match - and the API requires equal lengths, as the
reference does.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .bitpack import collapse_xor
from ..utils.profiling import named_scope


@jax.jit
def hamming_rows(a_words: jax.Array, b_words: jax.Array) -> jax.Array:
    """Row-wise hamming: `[N, W] x [N, W] -> [N]` int32."""
    with named_scope("ssq.hamming_rows"):
        c = collapse_xor(a_words ^ b_words)
        return jnp.sum(jax.lax.population_count(c), axis=-1) \
            .astype(jnp.int32)


@jax.jit
def hamming_pairwise(a_words: jax.Array, b_words: jax.Array) -> jax.Array:
    """All-pairs hamming: `[N, W] x [M, W] -> [N, M]` int32.

    The batched building block for UMI clustering (SURVEY section 2 row 15).
    Broadcasts the XOR; XLA fuses broadcast, XOR, collapse, popcount and
    the lane sum into one kernel, so the [N, M, W] intermediate is never
    written to device memory.
    """
    with named_scope("ssq.pairwise_jnp"):
        c = collapse_xor(a_words[:, None, :] ^ b_words[None, :, :])
        return jnp.sum(jax.lax.population_count(c), axis=-1) \
            .astype(jnp.int32)


def one_hot_codes(words: jax.Array) -> jax.Array:
    """`[N, W]` packed uint32 lanes -> `[N, W*64]` bf16 one-hot of the
    2-bit codes (16 codes per lane x 4 classes), LSB-first to match the
    reference bit layout.  Zero padding past a read's length one-hots as
    code 00 ('A'), exactly as the XOR formulation treats it."""
    n, w = words.shape
    shifts = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, None, :]
    codes = ((words[:, :, None] >> shifts) & 3).astype(jnp.int32)
    oh = codes[..., None] == jnp.arange(4, dtype=jnp.int32)
    return oh.reshape(n, w * 64).astype(jnp.bfloat16)


@jax.jit
def hamming_pairwise_mxu(a_words: jax.Array, b_words: jax.Array) -> jax.Array:
    """All-pairs hamming as one matrix product: `dist = nt_width -
    matches`, with matches = one_hot(a) @ one_hot(b).T.

    Bit-exact vs hamming_pairwise: operands are 0/1 bf16 (exactly
    representable), the contraction accumulates in f32, and per-pair sums
    are <= 1024 < 2^24 - no rounding anywhere.  Rationale: the XOR
    formulation costs ~6 integer ops per lane pair; this one runs on the
    matrix units at 4*nt MACs/pair, which can win despite the 64x operand
    expansion because pairwise work is O(N*M) while operands are
    O(N+M)."""
    w = a_words.shape[1]
    with named_scope("ssq.pairwise_mxu"):
        matches = jax.lax.dot_general(
            one_hot_codes(a_words), one_hot_codes(b_words),
            (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32)
        return (w * 16 - matches).astype(jnp.int32)
