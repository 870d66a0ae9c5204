"""Batched 2-bit pack / unpack / validate as jnp ops (XLA compute path).

Design (not a translation of the reference's BMI2 pext tricks):

* Unit of work is a batch `[N, L]` of ASCII bytes, padded with 0 to a static
  L that is a multiple of 16 nts.  Output is `[N, L // 16]` uint32 lanes,
  nucleotide i of a row in lane i // 16 at bits 2 * (i % 16) - the exact
  little-endian split of the reference's LSB-first uint64 blocks
  (reference util.pyx:100-140).

* The device-native input layout is `[N, L // 4]` uint32 - the same bytes
  the host already holds, viewed 4 chars per lane (numpy `.view(uint32)`,
  zero copy).  Taking the input as u32 keeps every device op on 32-bit
  lanes and needs no u8->u32 bitcast on the device.

* The encode is pure lane arithmetic: code = (ascii >> 1) & 3, which equals
  the reference's table_91 lookup / pext-mask trick for every byte the
  bloom filter accepts.  16 codes per output lane are assembled in two
  steps:
    1. within-lane SWAR: 4 codes at bits {0,8,16,24} compact into the low
       byte ((c | c>>6 | c>>12 | c>>18) & 0xFF) - elementwise work;
    2. 4:1 cross-lane combine out = b0 | b1<<8 | b2<<16 | b3<<24.  This is
       a *linear* function of the lanes, so it runs as two bf16 matrix
       products against constant banded {1, 256} matrices (exact: every
       product is an 8-bit integer times a power of two, accumulated in
       f32, results <= 65535 < 2^24), then lo | hi << 16.  No gathers;
       XLA fuses step 1 into the dot operand read.

* Validation is a mask, not an exception (SURVEY.md section 7 decision 3),
  and implements the reference's EXACT 64-bit bloom semantics
  (util.pxd:88-127, constant 0xFFFFFFFFFFEFFF75): byte c passes iff
  (c & 63) is one of {1, 3, 7, 20}.  That accepts exactly uppercase
  A/C/G/T among printable ASCII, and also the reference's false-pass
  aliases (0x01, 0x03, 0x07, 0x14, 0x41|0x80, ...) which then encode via
  (c >> 1) & 3 exactly as the reference's table does - so the scalar
  object layer (oracle.is_base, csrc encode_into) and this device path
  agree on all 256 byte values.

* Row folding: `pack_and_validate_rows` folds F consecutive rows into
  one ([N/F, F*W4], a free host-side reshape) so a narrow operand
  (W4 = 8 for the 32-nt bucket) fills 128- or 512-lane rows; the
  compaction matrix becomes block-diagonal (still one dot).  The fold
  targets were chosen on another chip and are not measured on the H100
  (ROADMAP queue 1 items 2 and 4; queue 3 item 2 asks whether a plain
  elementwise shift-or pack can replace all of this).  Each DISTINCT big
  dot operand costs one full read of the input (operands fuse into
  reads; outputs materialize), so formulations with one big operand are
  preferred.

* Fused pack + validate is ONE dot: the operand is the codes byte
  POISONED to 2^20 on bloom-failing lanes, and the block-diagonal matrix
  gains `fold` ok-columns whose sums reveal poisoned rows while clean
  rows' pack columns stay integer-exact (pack_and_validate_folded
  docstring has the full argument).  Under the PAD_BYTE builder contract
  (pad_valid=True: tail bytes pass the bloom and encode to 0) the kernel
  skips per-byte length masking, so validation rides the pack's own
  input read.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Low 32 bits of ~BLOOM: the pass-set {1, 3, 7, 20} of (byte & 63).  The
# high 32 bits of the reference bloom are all ones, so (c & 32) != 0 is
# always invalid (constants.BLOOM = 0xFFFFFFFFFFEFFF75).
_BLOOM_PASS_LO = 0x0010008A


def _u8_to_u32(x: jax.Array) -> jax.Array:
    """[N, 4k] uint8 -> [N, k] uint32, little-endian within each group of 4."""
    n, l = x.shape
    return jax.lax.bitcast_convert_type(x.reshape(n, l // 4, 4), jnp.uint32)


def _u32_to_u8(x: jax.Array) -> jax.Array:
    """[N, k] uint32 -> [N, 4k] uint8, little-endian."""
    n, k = x.shape
    return jax.lax.bitcast_convert_type(x, jnp.uint8).reshape(n, 4 * k)


def _codes_byte(x_u32: jax.Array) -> jax.Array:
    """u32 lane of 4 ASCII chars -> u32 lane with their 4 2-bit codes in
    the low byte (LSB-first)."""
    c = (x_u32 >> 1) & jnp.uint32(0x03030303)
    return (c | (c >> 6) | (c >> 12) | (c >> 18)) & jnp.uint32(0xFF)


@functools.lru_cache(maxsize=None)
def _compact_mats(w4: int):
    """Constant banded matrices for the 4:1 lane combine as matmuls:
    out16lo[:, j] = b[:, 4j] + 256 * b[:, 4j+1], out16hi likewise from
    lanes 4j+2, 4j+3."""
    w = w4 // 4
    p_lo = np.zeros((w4, w), np.float32)
    p_hi = np.zeros((w4, w), np.float32)
    for j in range(w):
        p_lo[4 * j + 0, j] = 1.0
        p_lo[4 * j + 1, j] = 256.0
        p_hi[4 * j + 2, j] = 1.0
        p_hi[4 * j + 3, j] = 256.0
    return p_lo, p_hi


def pack_words_u32(x_u32: jax.Array) -> jax.Array:
    """Pack `[N, W4]` uint32 (4 ASCII chars per lane, W4 % 4 == 0, zero
    padded) to `[N, W4 // 4]` uint32 packed lanes.

    Padding bytes (0) encode to code 0, matching the reference's
    zero-filled tail blocks (util.pyx:94, calloc in short_seq_var.pyx:126).
    """
    n, w4 = x_u32.shape
    if w4 % 4:
        # _compact_mats floors w4 // 4: the last lanes would be silently
        # dropped from every packed word (corrupt keys, no error).
        raise ValueError(
            f"pack input lane count {w4} is not a multiple of 4 "
            "(pad the byte matrix to a multiple of 16 columns)")
    b = _codes_byte(x_u32).astype(jnp.bfloat16)     # exact: values 0..255
    p_lo, p_hi = _compact_mats(w4)
    dn = (((1,), (0,)), ((), ()))
    lo = jax.lax.dot_general(b, jnp.asarray(p_lo, jnp.bfloat16), dn,
                             preferred_element_type=jnp.float32)
    hi = jax.lax.dot_general(b, jnp.asarray(p_hi, jnp.bfloat16), dn,
                             preferred_element_type=jnp.float32)
    return lo.astype(jnp.uint32) | (hi.astype(jnp.uint32) << 16)


def pack_words(ascii_u8: jax.Array) -> jax.Array:
    """Pack `[N, L]` ASCII uint8 (L % 16 == 0, zero padded) to
    `[N, L//16]` uint32.  Compatibility wrapper: prefer handing the device
    the uint32 view directly (host `.view(uint32)` is free; the u8->u32
    bitcast here is an extra pass on device)."""
    return pack_words_u32(_u8_to_u32(ascii_u8))


def unpack_ascii(words: jax.Array, out_len: int | None = None) -> jax.Array:
    """Inverse of pack_words: `[N, W]` uint32 -> `[N, W*16]` ASCII uint8.

    Codes decode through the reference charmap A,C,T,G (util.pyx:52); bases
    past a row's true length decode to 'A' (code 0) and must be sliced off
    by the caller.
    """
    from ..utils.profiling import named_scope

    with named_scope("ssq.unpack"):
        b8 = _u32_to_u8(words)                     # [N, 4W], 4 codes per byte
        z = b8.astype(jnp.uint32)
        spread = (z | (z << 6) | (z << 12) | (z << 18)) \
            & jnp.uint32(0x03030303)
        codes = _u32_to_u8(spread)                 # [N, 16W] one code per byte
        # code -> ascii: 0->A(65) 1->C(67) 2->T(84) 3->G(71)
        ascii_out = jnp.where(
            codes == 0, jnp.uint8(65),
            jnp.where(codes == 1, jnp.uint8(67),
                      jnp.where(codes == 2, jnp.uint8(84), jnp.uint8(71))))
    if out_len is not None:
        ascii_out = ascii_out[:, :out_len]
    return ascii_out


def _byte_ok(c: jax.Array) -> jax.Array:
    """Reference bloom test on u32 lanes holding one byte value each:
    pass iff bit (c & 63) of ~BLOOM is set, i.e. (c & 32) == 0 and bit
    (c & 31) of _BLOOM_PASS_LO is set (util.pxd:98-99)."""
    hit = (jnp.uint32(_BLOOM_PASS_LO) >> (c & jnp.uint32(31))) & jnp.uint32(1)
    return (hit == 1) & ((c & jnp.uint32(32)) == 0)


def _bloom_fail_bits(x_u32: jax.Array) -> jax.Array:
    """0x80 bit per byte that fails the reference bloom (is not one of
    the 4 pass values of (c & 63)).

    Code-reconstruction formulation (round 4): a byte passes the bloom
    iff (c & 63) equals the canonical byte RECONSTRUCTED from its own
    2-bit code (c >> 1) & 3 - the pass set {1, 3, 7, 20} maps to codes
    {0, 1, 3, 2} bijectively, so one per-byte compare replaces four
    per-value zero tests.  exp = 1 + 2*code, except code 2 ('T' & 63 =
    20) which needs +15: is2 = (code & ~(code << 1)) & 2 isolates code 2
    (value 2 per byte), and (is2 << 3) - (is2 >> 1) adds 16 - 1 = 15.
    All arithmetic stays within each byte (code <= 3, exp <= 20, is2 has
    only bit 1 -> no cross-byte carries or shifts).  ~16 integer ops/lane
    vs ~29 for the four-way zero-test SWAR, and the `c` here CSEs with
    the pack's own code computation in a fused program.  Verified
    equal to the reference bloom on all 256 byte values in
    tests/test_validation_parity.py (incl. the false-pass aliases
    {1,3,7,20} + 64/128/192 offsets with bit 5 clear)."""
    c = (x_u32 >> 1) & jnp.uint32(0x03030303)      # shared with the pack
    t = c << 1
    is2 = (c & ~t) & jnp.uint32(0x02020202)
    exp = (jnp.uint32(0x01010101) + t + (is2 << 3)) - (is2 >> 1)
    diff = (x_u32 & jnp.uint32(0x3F3F3F3F)) ^ exp
    return ((((diff & jnp.uint32(0x7F7F7F7F)) + jnp.uint32(0x7F7F7F7F))
             | diff) & jnp.uint32(0x80808080))


def _tail_mask(rem: jax.Array) -> jax.Array:
    """0x80 bit per byte slot that is before the row's length, from the
    per-lane remaining-byte count rem = clip(length - 4*lane, 0, 4)."""
    return jnp.where(
        rem >= 4, jnp.uint32(0x80808080),
        jnp.where(rem == 3, jnp.uint32(0x00808080),
                  jnp.where(rem == 2, jnp.uint32(0x00008080),
                            jnp.where(rem == 1, jnp.uint32(0x00000080),
                                      jnp.uint32(0)))))


def validate_u32(x_u32: jax.Array, lengths: jax.Array) -> jax.Array:
    """Per-row validity mask: True iff every byte before the row's length
    passes the reference bloom filter (bytes at and past the length are
    padding and are ignored, like the reference's marshalling loops that
    never read them, util.pyx:78-94)."""
    n, w4 = x_u32.shape
    lane = jax.lax.broadcasted_iota(jnp.int32, (n, w4), 1)
    rem = jnp.clip(lengths[:, None] - 4 * lane, 0, 4)  # bytes in range
    bad = _bloom_fail_bits(x_u32) & _tail_mask(rem)
    return ~jnp.any(bad != 0, axis=1)


def first_bad_byte_u32(x_u32: jax.Array, lengths: jax.Array) -> jax.Array:
    """Per-row index of the first bloom-failing byte before the row's
    length (or 4*W4 if none).  Lets the host raise the reference's exact
    per-character message (short_seq_64.pyx:105) from batched
    validation."""
    n, w4 = x_u32.shape
    big = jnp.int32(4 * w4)
    first = jnp.full((n,), big, jnp.int32)
    lane_pos = jax.lax.broadcasted_iota(jnp.int32, (n, w4), 1)
    for k in range(4):
        c = (x_u32 >> jnp.uint32(8 * k)) & jnp.uint32(0xFF)
        pos = 4 * lane_pos + k
        bad = ~_byte_ok(c) & (pos < lengths[:, None])
        first = jnp.minimum(first, jnp.min(jnp.where(bad, pos, big), axis=1))
    return first


def validate(ascii_u8: jax.Array, lengths: jax.Array) -> jax.Array:
    """u8-matrix wrapper over validate_u32."""
    return validate_u32(_u8_to_u32(ascii_u8), lengths)


def first_bad_byte(ascii_u8: jax.Array, lengths: jax.Array) -> jax.Array:
    """u8-matrix wrapper over first_bad_byte_u32."""
    return first_bad_byte_u32(_u8_to_u32(ascii_u8), lengths)


def collapse_xor(c: jax.Array) -> jax.Array:
    """((c >> 1) | c) & 0x5555... on uint32 lanes.  The 2-bit fields never
    straddle a lane boundary, so the per-uint32 collapse is bit-identical to
    the reference's per-uint64 collapse (short_seq_64.pyx:83)."""
    return ((c >> 1) | c) & jnp.uint32(0x55555555)


@functools.lru_cache(maxsize=None)
def _folded_mats(w4: int, fold: int):
    """Constants for the folded one-dot pack and the per-row validity:

    * pack `[fold*w4, 2*fold*w]` block-diagonal: columns [0, fw) carry the
      low 16 bits of each output lane (b0 + 256*b1), columns [fw, 2fw) the
      high (b2 + 256*b3);
    * spread `[fold, fold*w4]`: 0/1 broadcasting per-logical-row lengths
      to each row's lanes;
    * lane_in_row `[fold*w4]`: each lane's index within its logical row;
    * pe `[fold*w4, 2*fold*w + fold]`: the EXTENDED one-dot matrix - the
      pack block-diagonal plus `fold` ok-columns (= spread.T, weight 1 on
      each logical row's lanes) that sum the poisoned operand per row,
      so pack AND validity ride ONE dot / one input read (see
      pack_and_validate_folded).
    """
    w = w4 // 4
    fw = fold * w
    p = np.zeros((fold * w4, 2 * fw), np.float32)
    spread = np.zeros((fold, fold * w4), np.float32)
    for f in range(fold):
        for j in range(w):
            p[f * w4 + 4 * j + 0, f * w + j] = 1.0
            p[f * w4 + 4 * j + 1, f * w + j] = 256.0
            p[f * w4 + 4 * j + 2, fw + f * w + j] = 1.0
            p[f * w4 + 4 * j + 3, fw + f * w + j] = 256.0
        spread[f, f * w4:(f + 1) * w4] = 1.0
    lane_in_row = np.tile(np.arange(w4, dtype=np.float32), fold)
    pe = np.concatenate([p, spread.T], axis=1)
    return p, spread, lane_in_row, pe


def fold_for(w4: int, n: int, target_lanes: int = 128) -> int:
    """Row-fold factor for a `[n, w4]` host batch: enough folded lanes to
    reach `target_lanes`, a power of two so the pow2-padded batch dims
    of every production caller divide evenly.  The targets (128 for the
    fused pack+validate, 512 for pack-only) were chosen on another chip
    and are not measured on the H100 (ROADMAP queue 1 items 2 and 4).
    """
    if w4 >= target_lanes or n <= 0:
        return 1
    fold = 1
    while fold * w4 < target_lanes and fold < 64:
        fold *= 2
    while fold > 1 and n % fold:
        fold //= 2
    return fold


# Poison constant for the one-dot fused pack+validate: a bloom-failing
# lane's operand value becomes 2^20 (bf16-exact) instead of its 0..255
# codes byte, so any column that sums it exceeds _POISON_THRESH while
# clean ok-columns stay <= 255 * w4 <= 65280 and clean pack columns stay
# exact (<= 65535 < 2^24, f32-accumulated).  The threshold sits 8x above
# the max clean value and 2x below the min poisoned one.
_POISON = 2.0 ** 20
_POISON_THRESH = 2.0 ** 19


@functools.partial(jax.jit, static_argnames=("w4", "unfold", "pad_valid"))
def pack_and_validate_folded(x_f: jax.Array, lengths_f: jax.Array,
                             w4: int, unfold: bool = True,
                             pad_valid: bool = False):
    """Fused pack + validate on a row-folded batch - ONE dot, ONE input
    read.

    Args:
      x_f:       `[N/F, F*w4]` uint32 - F consecutive logical rows per
                 physical row (host-side `mat.reshape(n // F, F * w4)` of
                 the `[N, w4]` uint32 view; free).
      lengths_f: `[N/F, F]` int32 logical row lengths.
      w4:        lanes per logical row (static).
      unfold:    return `[N, w4/4]` words and `[N]` ok (reshape inside the
                 same program) instead of the folded layouts.
      pad_valid: the caller guarantees every byte at or past a row's
                 length passes the reference bloom AND encodes to code 0
                 (bytes 0x01/'A'/0x81/0xC1; constants.PAD_BYTE) - the
                 contract all in-repo matrix builders satisfy.  Skips the
                 length-masking work entirely.

    How one dot carries both results: the operand is the codes byte
    (0..255, bf16-exact) per lane, POISONED to 2^20 where the lane holds
    a bloom-failing in-range byte.  The extended constant matrix `pe`
    (_folded_mats) appends `fold` ok-columns (weight 1 on each logical
    row's lanes) to the pack block-diagonal, so:
      * clean logical rows: their pack columns see only exact 0..255
        values (the block-diagonal isolates rows) -> bit-exact words;
        their ok-column sums <= 255 * w4 < 2^19 -> ok.
      * poisoned rows: ok-column >= 2^20 > threshold -> not ok; their
        pack columns are garbage, but the contract (api layers, ingest)
        raises/filters those rows, matching the reference, whose
        marshalling also writes garbage for rejected bytes before the
        caller sees the raised error (util.pyx:100-119 encodes; the
        bloom check at util.pxd:116-127 gates).
    Validation cost thus rides the same matrix product and the same
    input read as the pack.  Detection is exact: f32 accumulation is
    exact for the clean range, and a poisoned sum is >= 2^20 - |rounding|
    >> 2^19.
    """
    from ..utils.profiling import named_scope

    nf, lanes = x_f.shape
    fold = lanes // w4
    w = w4 // 4
    fw = fold * w
    _, spread, lane_in_row, pe = _folded_mats(w4, fold)
    dn = (((1,), (0,)), ((), ()))
    with named_scope("ssq.pack_validate"):
        fail = _bloom_fail_bits(x_f)
        if pad_valid:
            badlane = fail != 0
        else:
            # Mask tail bytes (at/past each row's length) out of the fail
            # bits: lengths broadcast to lanes via a tiny constant f32 dot
            # (f32: lengths up to 1024 exceed bf16's mantissa).  HIGHEST
            # precision: at the default a GPU may run f32 products in
            # TF32, whose 10-bit mantissa happens to hold lengths <= 1024
            # exactly - correctness must not rest on that.
            len_lane = jax.lax.dot_general(
                lengths_f.astype(jnp.float32),
                jnp.asarray(spread, jnp.float32),
                dn, precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32)
            rem = jnp.clip(len_lane - 4.0 * jnp.asarray(lane_in_row)[None, :],
                           0.0, 4.0).astype(jnp.int32)
            badlane = (fail & _tail_mask(rem)) != 0
        b = jnp.where(badlane, jnp.bfloat16(_POISON),
                      _codes_byte(x_f).astype(jnp.bfloat16))
        r = jax.lax.dot_general(b, jnp.asarray(pe, jnp.bfloat16), dn,
                                preferred_element_type=jnp.float32)
        lo = r[:, :fw].astype(jnp.uint32)
        hi = r[:, fw:2 * fw].astype(jnp.uint32)
        words = lo | (hi << 16)
        ok = r[:, 2 * fw:] < _POISON_THRESH
    if unfold:
        return words.reshape(nf * fold, w4 // 4), ok.reshape(nf * fold)
    return words, ok


def _pack_folded_raw(x_f: jax.Array, w4: int) -> jax.Array:
    """Folded one-dot pack body: `[N/F, F*w4]` uint32 -> `[N/F, F*w4/4]`
    packed lanes (low 16-bit halves from the first fw dot columns, high
    from the rest)."""
    nf, lanes = x_f.shape
    if w4 % 4:
        raise ValueError(
            f"pack input lane count {w4} is not a multiple of 4 "
            "(pad the byte matrix to a multiple of 16 columns)")
    from ..utils.profiling import named_scope

    fold = lanes // w4
    fw = fold * (w4 // 4)
    p = _folded_mats(w4, fold)[0]
    dn = (((1,), (0,)), ((), ()))
    with named_scope("ssq.pack"):
        b = _codes_byte(x_f).astype(jnp.bfloat16)
        r = jax.lax.dot_general(b, jnp.asarray(p, jnp.bfloat16), dn,
                                preferred_element_type=jnp.float32)
        return (r[:, :fw].astype(jnp.uint32)
                | (r[:, fw:].astype(jnp.uint32) << 16))


@functools.partial(jax.jit, static_argnames=("w4", "unfold"))
def pack_folded(x_f: jax.Array, w4: int, unfold: bool = True):
    """Pack without validation on a row-folded batch (the from_matrix /
    pre-validated construction path).  One big dot operand, so larger
    folds keep winning - pair with fold_for(w4, n, target_lanes=512)."""
    nf, lanes = x_f.shape
    fold = lanes // w4
    words = _pack_folded_raw(x_f, w4)
    if unfold:
        return words.reshape(nf * fold, w4 // 4)
    return words


def pack_rows(mat_u32: np.ndarray) -> jax.Array:
    """Host entry for unvalidated construction: numpy `[N, w4]` uint32
    view -> device `[N, w4/4]` packed lanes, row-folded to ~512 lanes
    (the reshapes are free host views)."""
    n, w4 = mat_u32.shape
    fold = fold_for(w4, n, target_lanes=512)
    if fold == 1:
        return pack_words_u32(jnp.asarray(mat_u32))
    return pack_folded(
        jnp.asarray(mat_u32.reshape(n // fold, fold * w4)), w4)


def pack_and_validate_rows(mat_u32: np.ndarray, lengths: np.ndarray,
                           pad_valid: bool = False):
    """Host entry for the hot construction path (SURVEY 3.1): numpy
    `[N, w4]` uint32 view + `[N]` lengths -> device (`[N, w4/4]` words,
    `[N]` ok), row-folded for full-tile HBM traffic when the batch shape
    allows it.  The reshapes here are free host views.  pad_valid: see
    pack_and_validate_folded - pass True only when the byte matrix was
    built by an in-repo builder (pad bytes are PAD_BYTE)."""
    n, w4 = mat_u32.shape
    fold = fold_for(w4, n)
    if fold == 1:
        return pack_and_validate_u32(jnp.asarray(mat_u32),
                                     jnp.asarray(lengths),
                                     pad_valid=pad_valid)
    lengths = np.ascontiguousarray(lengths, np.int32)
    return pack_and_validate_folded(
        jnp.asarray(mat_u32.reshape(n // fold, fold * w4)),
        jnp.asarray(lengths.reshape(n // fold, fold)), w4,
        pad_valid=pad_valid)


@functools.partial(jax.jit, static_argnames=("pad_valid",))
def pack_and_validate_u32(x_u32: jax.Array, lengths: jax.Array,
                          pad_valid: bool = False):
    """Fused pack + validity mask on the u32-viewed byte matrix (the hot
    construction path, SURVEY 3.1) - the fold=1 case of the one-dot
    pack_and_validate_folded."""
    return pack_and_validate_folded(x_u32, lengths[:, None], x_u32.shape[1],
                                    unfold=True, pad_valid=pad_valid)


@jax.jit
def pack_and_validate(ascii_u8: jax.Array, lengths: jax.Array):
    """Fused pack + validity mask from a u8 matrix (compatibility path;
    pays one u8->u32 bitcast pass that pack_and_validate_u32 avoids)."""
    x = _u8_to_u32(ascii_u8)
    return pack_and_validate_u32(x, lengths)
