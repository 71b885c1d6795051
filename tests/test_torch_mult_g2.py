"""The port's curves/mult.py on G2 on the CPU, against the pure-integer
oracle (JAX's G2 graphs compile for minutes on a CPU): point_mult (w = 4),
ladder_mult, msm_wbits (w = 4), points_add and in_group_device on four
lanes holding the edge cases of tests/test_mult.py: the scalars 0, 1 and
r - 1, and the point at infinity.
"""

import pytest
import torch

from msm_blst_tpu_torch import refimpl
from msm_blst_tpu_torch.constants import R_ORDER
from msm_blst_tpu_torch.curves import (G2, AffinePoint, in_group_device,
                                       ladder_mult, msm_wbits, point_mult,
                                       points_add)
from msm_blst_tpu_torch.msm import fixed_point_list, recode

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

REF = refimpl.G2
N = 4
INF_LANE = 3
KS = [0, 1, R_ORDER - 1, 5]


@pytest.fixture(scope="module")
def pts():
    """Fixed points P_i = 2^(i+1) G, lane INF_LANE the point at infinity."""
    p = fixed_point_list(G2, N, device=CPU)
    inf = torch.arange(N) == INF_LANE
    return AffinePoint(*(torch.where(inf, 0, c) for c in p))


def _fixed(i):
    return REF.INF if i == INF_LANE else REF.mult(pow(2, i + 1, R_ORDER))


def _affine(jac):
    return G2.affine_to_ints(G2.jac_to_affine(jac))


def _scalars():
    return recode.to_device(recode.scalars_from_ints(KS), CPU)


@pytest.mark.parametrize("fn", ["point_mult", "ladder_mult"])
def test_single_mults(pts, fn):
    if fn == "point_mult":
        out = point_mult(G2, _scalars(), pts, w=4)
    else:
        out = ladder_mult(G2, _scalars(), pts)
    assert _affine(out) == [REF.mult(k, _fixed(i)) if i != INF_LANE
                            else REF.INF for i, k in enumerate(KS)]


def test_msm_wbits(pts):
    total = sum(k * pow(2, i + 1, R_ORDER) for i, k in enumerate(KS)
                if i != INF_LANE) % R_ORDER
    assert _affine(msm_wbits(G2, _scalars(), pts, w=4))[0] == REF.mult(total)


def test_points_add(pts):
    total = sum(pow(2, i + 1, R_ORDER) for i in range(N)
                if i != INF_LANE) % R_ORDER
    assert _affine(points_add(G2, pts))[0] == REF.mult(total)


def test_in_group(pts):
    assert in_group_device(G2, pts, w=4).tolist() == [True] * N
