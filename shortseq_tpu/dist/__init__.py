"""Multi-device / multi-host data parallelism.

The reference is single-process (SURVEY.md section 2, "Parallelism: none").
This package supplies the scaling story mandated by BASELINE.json:
FASTQ shards -> per-host batches -> per-device shard_map over a 1-D `data`
mesh axis, with per-shard sort-unique count tables merged by an
`all_gather` + re-unique reduction (counting is associative).
"""

from .mesh import data_mesh, initialize_distributed
from .count import (ShardedCountTable, count_sharded, count_sharded_auto,
                    count_sharded_bucketed, make_sharded_counter)
from .pipeline import (count_fastq_sharded, read_and_count_fastq_distributed,
                       table_to_counter, table_to_host_rows)
from .table import DistributedCountTable, distributed_count_table
from .umi import neighbors_sharded_step

__all__ = [
    "data_mesh", "initialize_distributed",
    "ShardedCountTable", "count_sharded", "count_sharded_auto",
    "count_sharded_bucketed", "make_sharded_counter",
    "count_fastq_sharded", "read_and_count_fastq_distributed",
    "table_to_counter", "table_to_host_rows",
    "DistributedCountTable", "distributed_count_table",
    "neighbors_sharded_step",
]
