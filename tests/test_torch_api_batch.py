"""The port's facade batch ops on the CPU (device="cpu"), G1 and G2: stock
Pippenger and its tile at window 4, wbits with a precomputed table (and
the engine's msm_wbits building its own, the same words), the bulk add
and the batch to-affine with points at infinity among the lanes, each
against the oracle. On the CPU a window of stock costs a bucket pass of
plain formulas, so the full-width scalars run on G1's tile only and
p1s_mult_pippenger / p2s_mult_pippenger take 32-bit scalars with
nbits = 32 (9 windows); p2s_tile_pippenger's routing is held to
p2s_mult_pippenger's with the engine spied on.
"""

import numpy as np
import pytest
import torch

from msm_blst_tpu_torch import api
from msm_blst_tpu_torch.constants import P, R_ORDER
from msm_blst_tpu_torch.curves import G1, G2, msm_wbits
from msm_blst_tpu_torch.msm import engine, fixed_point_list, recode
from msm_blst_tpu_torch.refimpl import CURVES

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card
CURVE = {"p1": G1, "p2": G2}
INF = {"p1": (0, 0), "p2": ((0, 0), (0, 0))}


@pytest.fixture(scope="module")
def points():
    """P_i = 2^(i+1) G as host int tuples, 64 of G1 and 16 of G2."""
    return {"p1": G1.affine_to_ints(fixed_point_list(G1, 64, device=CPU)),
            "p2": G2.affine_to_ints(fixed_point_list(G2, 16, device=CPU))}


def _oracle(g, ints, n):
    ref = CURVES["G1" if g == "p1" else "G2"]
    return ref.mult(sum(s * pow(2, i + 1, R_ORDER)
                        for i, s in enumerate(ints[:n])) % R_ORDER)


def _scalars(n, seed, bits=256):
    ints = recode.scalars_to_ints(recode.random_scalars(n, seed))
    ints = [k % (1 << bits) for k in ints]
    ints[:2] = [0, 1]
    return ints


def test_g1_tile_at_window_4(points):
    pts = points["p1"][:16]
    ints = _scalars(16, 21)
    ints[2] = R_ORDER - 1
    jac = api.p1s_tile_pippenger(pts, ints, 4, device=CPU)
    assert api.p1_to_affine(jac) == _oracle("p1", ints, 16)


@pytest.mark.parametrize("g", ["p1", "p2"])
def test_mult_pippenger_nbits_32(points, g):
    """The default window at n = 64 (G1) is 4 (engine.pippenger_window_size);
    G2's 16 points take 2, so G2 runs at n = 16 with 17 windows."""
    pts = points[g]
    ints = _scalars(len(pts), 22, bits=32)
    jac = getattr(api, f"{g}s_mult_pippenger")(pts, ints, 32, device=CPU)
    to_affine = getattr(api, f"{g}_to_affine")
    assert to_affine(jac) == _oracle(g, ints, len(pts))


def test_p2s_tile_routes_its_window(points, monkeypatch):
    """p2s_tile_pippenger runs p2s_mult_pippenger's stock path with its
    window and nbits 255: the engine call, spied on, sees the G2 curve,
    the points' rows and those arguments."""
    seen = []

    def spy(plan, scalars, window=None, nbits=255, bucket_impl="prefix"):
        seen.append((plan.curve.name, tuple(plan.points_rows.XY.shape),
                     plan.table3nh, window, nbits, scalars.shape))
        return G2.jac_inf((1,), CPU)
    monkeypatch.setattr(engine, "msm_stock_pippenger", spy)
    pts = points["p2"][:4]
    jac = api.p2s_tile_pippenger(pts, [5, 6, 7, 8], 7, device=CPU)
    assert api.p2_is_inf(jac)
    assert seen == [("G2", (4, 48), None, 7, 255, (8, 4))]


@pytest.mark.parametrize("g, n, w", [("p1", 16, 4), ("p2", 8, 4)])
def test_wbits_with_a_precomputed_table(points, g, n, w):
    pts = points[g][:n]
    ints = _scalars(n, 23)
    ints[2] = R_ORDER - 1
    table = getattr(api, f"{g}s_mult_wbits_precompute")(pts, w, device=CPU)
    assert tuple(table.X.shape[-2:]) == ((1 << (w - 1)) + 1, n)
    jac = getattr(api, f"{g}s_mult_wbits")(table, ints, w, device=CPU)
    assert getattr(api, f"{g}_to_affine")(jac) == _oracle(g, ints, n)
    if g == "p1":  # the engine building its own table: the same words
        curve = CURVE[g]
        own = msm_wbits(curve, recode.to_device(
            recode.scalars_from_ints(ints), CPU),
            curve.affine_from_ints(pts, device=CPU), w=w)
        assert api._jac_ints(curve, own) == jac
    size = getattr(api, f"{g}s_mult_wbits_precompute_sizeof")(w, n)
    assert size == (96 if g == "p1" else 192) * n << (w - 1)


@pytest.mark.parametrize("g", ["p1", "p2"])
def test_add_with_infinity_lanes(points, g):
    pts = list(points[g])
    e = [pow(2, i + 1, R_ORDER) for i in range(len(pts))]
    for i in (0, 5, len(pts) - 1):
        pts[i], e[i] = INF[g], 0
    jac = getattr(api, f"{g}s_add")(pts, device=CPU)
    ref = CURVES["G1" if g == "p1" else "G2"]
    assert getattr(api, f"{g}_to_affine")(jac) == ref.mult(sum(e) % R_ORDER)
    one = getattr(api, f"{g}s_add")([INF[g]], device=CPU)
    assert getattr(api, f"{g}_is_inf")(one)


@pytest.mark.parametrize("g", ["p1", "p2"])
def test_to_affine_with_infinity_lanes(points, g):
    """Jacobian points with random Z (and Z = 0 lanes, at infinity) back to
    affine in one batch inversion: Z = 0 gives (0, 0), as JAX's."""
    rng = np.random.default_rng(24)
    pts = list(points[g])
    mult = api.fp_mul if g == "p1" else api.fp2_mul
    jacs = []
    for pt in pts:
        if g == "p1":
            z = int.from_bytes(rng.bytes(48), "little") % P
        else:
            z = tuple(int.from_bytes(rng.bytes(48), "little") % P
                      for _ in range(2))
        z2 = mult(z, z)
        jacs.append((mult(pt[0], z2), mult(pt[1], mult(z2, z)), z))
    for i in (1, 7):
        one = 1 if g == "p1" else (1, 0)
        zero = 0 if g == "p1" else (0, 0)
        jacs[i], pts[i] = (one, one, zero), INF[g]
    got = getattr(api, f"{g}s_to_affine")(jacs, device=CPU)
    assert got == pts
    host = getattr(api, f"{g}_to_affine")
    assert [host(j) for j in jacs] == pts
