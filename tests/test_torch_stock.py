"""The port's stock Pippenger against the pure-integer oracle (against JAX's
msm_stock_pippenger: tests/test_torch_stock_jax.py).

* msm_stock_pippenger with window=8 at n = 16 (32 windows of 129 buckets:
  the bucket-grid integration) and with blst's default window at n = 32
  (c = 3: 86 windows of 5 buckets), each with both bucket strategies, on
  scalars 0, r-1 and a repeated scalar: the affine result equals the
  oracle.
* pippenger_window_size equals JAX's.
"""

import pytest
import torch

from msm_blst_tpu.constants import R_ORDER
from msm_blst_tpu.msm import engine as jengine
from msm_blst_tpu.refimpl import G1_REF
from msm_blst_tpu_torch.curves import G1
from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list,
                                    msm_stock_pippenger, params,
                                    pippenger_window_size, recode)

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

CFG = dict(c=8, h=32, c_bgmw=8, h_bgmw=32)  # stock reads no table


def _query_ints(n):
    """test_e2e_fast.py's scalars: 0, r-1 and a repeated scalar."""
    ints = recode.scalars_to_ints(recode.random_scalars(n, seed=51))
    ints[0], ints[1] = 0, R_ORDER - 1
    ints[2] = ints[3]
    return ints


def _oracle(ints):
    total = sum(s * pow(2, i + 1, R_ORDER) for i, s in enumerate(ints)) % R_ORDER
    x, y = G1_REF.to_affine(G1_REF.jac_mult(total, G1_REF.generator_jac()))
    return (x.v, y.v)


@pytest.fixture(scope="module")
def plans():
    return {n: build_plan(G1, fixed_point_list(G1, n, device=CPU),
                          params.make_config(n.bit_length() - 1, **CFG),
                          ches=False, bgmw=False)
            for n in (16, 32)}


@pytest.mark.parametrize("impl", ["prefix", "segmented"])
@pytest.mark.parametrize("n,window", [(16, 8), (32, None)],
                         ids=["n16-window8", "n32-default"])
def test_msm_stock_pippenger_matches_oracle(plans, n, window, impl):
    ints = _query_ints(n)
    jac = msm_stock_pippenger(plans[n], recode.to_device(
        recode.scalars_from_ints(ints), CPU), window=window, bucket_impl=impl)
    assert G1.affine_to_ints(G1.jac_to_affine(jac))[0] == _oracle(ints)


def test_pippenger_window_size_matches_jax():
    sizes = [0, 1, 2, 3, 16, 17, 31, 32, 4096, 8191, 8192, 1 << 16, 1 << 21]
    assert ([pippenger_window_size(n) for n in sizes]
            == [jengine.pippenger_window_size(n) for n in sizes])
    assert pippenger_window_size(1 << 16) == 13
