"""The flagship query as a callable (the counterpart of the JAX package's
__graft_entry__.entry).

entry(device=None) -> (fn, example_args): fn(*example_args) runs the G1
CHES "nh + 0.21q" query (device-side integral scalar conversion -> sort ->
prefix-level bucket accumulation -> d-gap integration) on a 64-point plan
with make_config(6, c=8, h=32, c_bgmw=8, h_bgmw=32) and returns a Jacobian
batch of 1. The example scalars are recode.random_scalars(64, seed=7), the
JAX entry's. The device defaults to the card.

The sharded multi-chip dry run (dryrun_multichip) is not ported yet.
"""

from __future__ import annotations

from .curves import G1
from .device import resolve
from .msm import build_plan, fixed_point_list, msm_ches_device, params, recode


def _small_setup(n_points: int, device):
    cfg = params.make_config(max(n_points.bit_length() - 1, 1), c=8, h=32,
                             c_bgmw=8, h_bgmw=32)
    points = fixed_point_list(G1, n_points, device=device)
    plan = build_plan(G1, points, cfg, bgmw=False, stock=False)
    scalars = recode.to_device(recode.random_scalars(n_points, seed=7), device)
    return plan, scalars


def entry(device=None):
    """Returns (fn, example_args): the G1 CHES query on a 64-point plan
    and its example scalars, on `device` (default: the card)."""
    plan, scalars = _small_setup(64, resolve(device))

    def fn(scalars):
        return msm_ches_device(plan, scalars)

    return fn, (scalars,)
