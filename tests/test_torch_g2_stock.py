"""The port's stock Pippenger over G2 against the pure-integer G2 oracle,
with both bucket strategies.

n = 16 with tests/test_msm.py test_g2_agreement's scalars (0, r-1 and a
repeated pair). Window 4: 64 windows of 9 buckets, the cheapest window for
the plain G2 formulas on the CPU (window 8 takes half again as long; the
weighted integration's bucket-grid branch runs over G2 in the BGMW tests of
tests/test_torch_g2_msm.py). Exact equality in affine.
"""

import pytest
import torch

from msm_blst_tpu.constants import R_ORDER
from msm_blst_tpu_torch.curves import G2
from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list,
                                    msm_stock_pippenger, params, recode)
from msm_blst_tpu_torch.refimpl import G2 as ref

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

N = 16


def _query_ints():
    """tests/test_msm.py test_g2_agreement's scalars."""
    ints = recode.scalars_to_ints(recode.random_scalars(N, seed=21))
    ints[0], ints[1] = 0, R_ORDER - 1
    ints[2] = ints[3]
    return ints


@pytest.fixture(scope="module")
def plan():
    return build_plan(G2, fixed_point_list(G2, N, device=CPU),
                      params.make_config(4, c=8, h=32), ches=False,
                      bgmw=False)


@pytest.mark.parametrize("impl", ["prefix", "segmented"])
def test_g2_msm_stock_pippenger_matches_oracle(plan, impl):
    ints = _query_ints()
    jac = msm_stock_pippenger(plan, recode.to_device(
        recode.scalars_from_ints(ints), CPU), window=4, bucket_impl=impl)
    want = ref.mult(sum(s * pow(2, i + 1, R_ORDER)
                        for i, s in enumerate(ints)) % R_ORDER)
    assert G2.affine_to_ints(G2.jac_to_affine(jac))[0] == want
