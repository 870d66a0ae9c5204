"""Domain constants shared by every layer of shortseq_tpu.

Semantics mirror the reference library's constants (see reference
shortseq/util.pyx:39-75 and the per-width domain getters in
short_seq_64.pyx:27-28, short_seq_192.pyx:21-22, short_seq_var.pyx:8-10),
but the representation here is device-first: one reference 64-bit block is
a little-endian pair of uint32 lanes, because accelerator vector units
operate on 32-bit lanes.
"""

# --- Width-class domains (reference short_seq_64.pyx:27-28 etc.) -----------
MIN_64_NT = 0
MAX_64_NT = 32
MIN_192_NT = 33
MAX_192_NT = 96
MIN_VAR_NT = 97
MAX_VAR_NT = 1024
MAX_REPR_LEN = 75  # reference short_seq_var.pyx:10

# --- Bit layout -------------------------------------------------------------
# 2-bit codes, LSB-first: nucleotide i of a read lives in 64-bit block
# (i // 32) at bit offset 2 * (i % 32).  On the device we store uint32 lanes:
# nucleotide i -> lane (i // 16), bits 2 * (i % 16).  Reference block b is
# exactly lanes[2b] | lanes[2b+1] << 32.
NT_PER_BLOCK = 32          # nts per reference uint64 block (util.pyx:42)
NT_PER_LANE = 16           # nts per uint32 lane
LANES_PER_BLOCK = 2

# Lane counts per width bucket.
LANES_64 = 2               # 1 block
LANES_192 = 6              # 3 blocks
LANES_VAR = 64             # 32 blocks = 1024 nt

BLOCKS_64 = 1
BLOCKS_192 = 3
BLOCKS_VAR = 32

# --- Encoding ---------------------------------------------------------------
# code = (ascii >> 1) & 3 reproduces the reference's table_91 / pext-mask
# encoding exactly for A, C, G, T (and U):  A=00, C=01, T=10, G=11
# (reference util.pyx:44-52, README "Encoding" table).
CODE_A, CODE_C, CODE_T, CODE_G = 0, 1, 2, 3
CHARMAP = ("A", "C", "T", "G")                 # code -> char (util.pyx:52)
CHARMAP_BYTES = (65, 67, 84, 71)               # ord() of the above

# --- Validation -------------------------------------------------------------
# 64-bit bloom filter; bit (char & 63) SET means the char is rejected
# (reference util.pyx:75, util.pxd:98-99).  Of printable ASCII only the
# uppercase bases A, C, G, T pass.  The reference's filter also FALSE-PASSES
# control bytes 1, 3, 7, 20 and the >=128 aliases 129/131/135/148/193/195/
# 199/212 (for which it then encodes garbage).  CONTRACT: all four
# implementations here - oracle.py, the device kernels in ops/bitpack.py,
# and both native paths (csrc/shortseq_native.cpp all_acgt8,
# csrc/fastq_index.cpp) - deliberately ACCEPT those same aliases so the
# 256-byte accept/reject behavior is byte-for-byte identical to the
# reference; tests/test_validation_parity.py asserts the full-range
# agreement.  Do not "fix" any path to reject them - that would be a
# parity break, not a bug fix.
BLOOM = 0xFFFFFFFFFFEFFF75
VALID_BYTES = frozenset(b"ACGT")

# Padding byte for in-repo ASCII matrices (io.read_fastq_matrix,
# batch._ascii_matrix, count/ingest builders): 0x01 both PASSES the bloom
# (1 is a false-pass alias, see above) and ENCODES to code 0 ((1>>1)&3),
# so packed word tails stay zero (the reference's zero-filled tail
# convention, util.pyx:94) while the device fused pack+validate can skip
# per-byte length masking entirely (ops.bitpack pad_valid=True - the
# one-dot kernel's fast contract; bytes 'A'/0x41/0x81/0xC1 would satisfy
# it too).  Matrices from OUTSIDE the repo may pad with anything; they
# take the length-masked path (pad_valid=False, the default).
PAD_BYTE = 0x01

UNSUPPORTED_BASE_MSG = "Unsupported base character"
TOO_LONG_MSG = f"Sequences longer than {MAX_VAR_NT} bases are not supported."
LENGTH_MISMATCH_MSG = "Hamming distance requires sequences of equal length"


def lanes_for_length(length: int) -> int:
    """Number of uint32 lanes needed for `length` nucleotides."""
    return -(-length // NT_PER_LANE)


def blocks_for_length(length: int) -> int:
    """Number of reference 64-bit blocks for `length` nucleotides
    (reference util.pyx:30-33)."""
    return -(-length // NT_PER_BLOCK)


def bucket_lanes(length: int) -> int:
    """Lane count of the width bucket a read of `length` nts belongs to."""
    if length <= MAX_64_NT:
        return LANES_64
    if length <= MAX_192_NT:
        return LANES_192
    if length <= MAX_VAR_NT:
        return LANES_VAR
    raise ValueError(TOO_LONG_MSG)
