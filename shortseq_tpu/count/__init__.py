"""Device-side exact deduplication (the replacement for the reference's
CPython known-hash dict counting, reference counter.pyx:41-54).

Counting is sort-unique, not a hash table (SURVEY.md section 7 decision 5):
lexicographic sort of packed lane tuples -> segment boundaries -> segment
sums.  The operation is associative, so the multi-host merge in
shortseq_tpu.dist is all_gather of per-shard uniques + one more
sort-unique-sum.
"""

from .device import unique_count, count_batch, counts_to_host
from .table import CountTable

__all__ = ["unique_count", "count_batch", "counts_to_host", "CountTable"]
