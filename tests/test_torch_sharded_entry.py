"""The port's sharded dry run on the CPU: entry.dryrun_multichip(4,
device="cpu") spawns four gloo ranks that run the points-sharded CHES
query at 32 points and the window-sharded CHES query of a "j" plan with h
= 33 (padded to 36), each against the oracle on every rank (it raises
otherwise).
"""

from __future__ import annotations

from msm_blst_tpu_torch.entry import dryrun_multichip


def test_dryrun_multichip_on_four_cpu_ranks():
    dryrun_multichip(4, device="cpu")
