"""The CHES 'nh + 0.21q' MSM query and the precompute it reads."""

from . import params, recode  # noqa: F401
from .engine import MsmPlan, msm_ches_device  # noqa: F401
from .precompute import (build_ches_table, build_plan,  # noqa: F401
                         fixed_base_mult, fixed_point_list)
