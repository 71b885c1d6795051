"""Sharded MSM on torch.distributed: one process a rank, the EC group law
as the all-reduce's combiner (sharded.py), and the spawner of the ranks
(ranks.py)."""

from .ranks import run_ranks  # noqa: F401
from .sharded import (  # noqa: F401
    ShardedQuery,
    breakdown,
    ec_allreduce_xyzz,
    make_2d_mesh,
    make_points_mesh,
    make_windows_mesh,
    sharded_msm_ches,
    sharded_msm_ches_2d,
    sharded_msm_ches_windows,
    sharded_msm_bgmw,
    sharded_msm_bgmw_windows,
    shard_plan_tables,
    shard_plan_tables_jmajor,
)
