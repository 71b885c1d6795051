"""The MSM algorithms over G1 and G2 (CHES, BGMW95, stock Pippenger) and the
precompute they read."""

from . import params, recode  # noqa: F401
from .engine import (MsmPlan, msm_bgmw_device,  # noqa: F401
                     msm_ches_device, msm_ches_host_recode,
                     msm_stock_pippenger, pippenger_window_size)
from .precompute import (build_bgmw_table, build_ches_table,  # noqa: F401
                         build_plan, fixed_base_mult, fixed_point_list)
