from .bitpack import (
    pack_words,
    pack_words_u32,
    unpack_ascii,
    validate,
    validate_u32,
    first_bad_byte,
    first_bad_byte_u32,
    pack_and_validate,
    pack_and_validate_u32,
    pack_and_validate_folded,
    pack_and_validate_rows,
    pack_folded,
    pack_rows,
    fold_for,
    collapse_xor,
)
from .hamming import hamming_rows, hamming_pairwise, hamming_pairwise_mxu
from .pallas_kernels import pairwise_formulation, pairwise_hamming_auto
