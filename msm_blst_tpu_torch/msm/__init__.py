"""The MSM algorithms over G1 and G2 (CHES, BGMW95, stock Pippenger), the
big-n ranged query, the precompute they read and its cache."""

from . import cache, params, recode  # noqa: F401
from .cache import load_plan, save_plan  # noqa: F401
from .engine import (MsmPlan, integrate_gapped,  # noqa: F401
                     msm_bgmw_device, msm_bign, msm_ches_device,
                     msm_ches_host_recode, msm_stock_pippenger,
                     pippenger_window_size)
from .precompute import (build_bgmw_table,  # noqa: F401
                         build_bgmw_table_rows_streamed, build_ches_table,
                         build_ches_table_rows_streamed, build_plan,
                         fixed_base_mult, fixed_point_list)
