"""The port's Fp2 arithmetic, G2 constants, G2 oracle, G2 row layout and
G2 precompute (fixed points, a BGMW table carried over with
convert.plan_from_jax) against the JAX package's, bit for bit.

Fp2 elements are made from a numpy seed, with 0 and p-1 in either
component. The JAX functions run jitted on their CPU path; the port's run on
CPU tensors, where every base-field multiply takes K1's plain version.
Components are canonical on both sides, so words compare exactly (no
tolerance) through convert.py. The table is a small one (c' = 1, h' = 3):
its rows come from the doubling chain and the batched to-affine, and the
point formulas under them are held word for word in
tests/test_torch_g2_point.py.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from msm_blst_tpu import constants as jc
from msm_blst_tpu.curves import G2 as JG2
from msm_blst_tpu.fields.fp2 import FP2 as JFP2
from msm_blst_tpu.msm import precompute as jprecompute
from msm_blst_tpu.refimpl import G2_REF
from msm_blst_tpu_torch import constants as tc
from msm_blst_tpu_torch.convert import fp2_from_jax, fp2_to_jax, plan_from_jax
from msm_blst_tpu_torch.curves import G2
from msm_blst_tpu_torch.fields import FP2
from msm_blst_tpu_torch.msm import build_bgmw_table, fixed_point_list, params
from msm_blst_tpu_torch.refimpl import G2 as ref

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

P = jc.P
B = 64


def _pairs(seed):
    """B Fp2 values: every combination of 0, 1 and p-1 in the components,
    then random ones."""
    rng = np.random.default_rng(seed)
    edges = [0, 1, P - 1]
    out = [(a, b) for a in edges for b in edges]
    while len(out) < B:
        out.append(tuple(int.from_bytes(rng.bytes(48), "little") % P
                         for _ in range(2)))
    return out


def _both(pairs):
    """The same Montgomery batch: (jax uint32[2, 24, B], port int32[2, 12, B])."""
    return JFP2.from_int_pairs(pairs), FP2.from_int_pairs(pairs, device=CPU)


def _jax_point(pts):
    """Affine oracle points as the JAX package's Fp2 ref objects' ints."""
    return [((x.c0.v, x.c1.v), (y.c0.v, y.c1.v)) for x, y in pts]


def test_g2_constants_match_jax():
    for name in ("B_G2", "G2_X", "G2_Y"):
        assert tuple(getattr(tc, name)) == tuple(getattr(jc, name)), name


@pytest.mark.parametrize("case", ["add", "double", "cancel", "inf", "mult"])
def test_g2_oracle_matches_jax(case):
    """msm_blst_tpu_torch.refimpl.G2 (affine int pairs) against the JAX
    package's Jacobian oracle G2_REF, in affine."""
    def jref(k):
        return _jax_point([G2_REF.to_affine(
            G2_REF.jac_mult(k, G2_REF.generator_jac()))])[0]

    rng = np.random.default_rng(10)
    k1, k2 = (int.from_bytes(rng.bytes(32), "little") for _ in range(2))
    p1, p2 = ref.mult(k1), ref.mult(k2)
    assert ref.is_on_curve(p1) and p1 == jref(k1)
    neg = (p1[0], tuple(-v % P for v in p1[1]))
    got, want = {
        "add": (ref.add(p1, p2), jref(k1 + k2)),
        "double": (ref.add(p1, p1), jref(2 * k1)),
        "cancel": (ref.add(p1, neg), ref.INF),
        "inf": (ref.add(ref.INF, p2), p2),
        "mult": (ref.mult(0), jref(0)),
    }[case]
    assert got == want


def test_fp2_converters_roundtrip():
    pairs = _pairs(1)
    for mont in (True, False):
        j = np.asarray(JFP2.from_int_pairs(pairs, mont=mont))
        t = FP2.from_int_pairs(pairs, mont=mont, device=CPU)
        assert torch.equal(fp2_from_jax(j, CPU), t)
        assert np.array_equal(fp2_to_jax(t), j)
    assert FP2.to_int_pairs(FP2.from_int_pairs(pairs, device=CPU)) == pairs


@pytest.mark.parametrize("op", ["add", "sub", "neg", "mul3", "mul", "sqr",
                                "inv", "batch_inv"])
def test_fp2_op_matches_jax(op):
    ja, ta = _both(_pairs(2))
    jb, tb = _both(_pairs(3)[::-1])
    if op in ("add", "sub", "mul"):
        want = jax.jit(getattr(JFP2, op))(ja, jb)
        got = getattr(FP2, op)(ta, tb)
    else:
        want = jax.jit(getattr(JFP2, op))(ja)
        got = getattr(FP2, op)(ta)
    assert np.array_equal(fp2_to_jax(got), np.asarray(want))


def test_fp2_predicates_match_jax():
    ja, ta = _both(_pairs(2))
    jb, tb = _both(_pairs(2)[:B // 2] + _pairs(3)[B // 2:])
    assert np.array_equal(FP2.eq(ta, tb).numpy(), np.asarray(JFP2.eq(ja, jb)))
    assert np.array_equal(FP2.is_zero(ta).numpy(),
                          np.asarray(JFP2.is_zero(ja)))
    assert FP2.is_zero(ta)[0] and not FP2.is_zero(ta)[1:].any()


def test_fp2_mul_many_and_inverse_match_the_oracle():
    """Karatsuba over several pairs in one call, and the inverses, equal
    the int-pair field of refimpl."""
    from msm_blst_tpu_torch.refimpl import _Fp2

    xs, ys = _pairs(4), _pairs(5)[::-1]
    a = FP2.from_int_pairs(xs, device=CPU)
    b = FP2.from_int_pairs(ys, device=CPU)
    ab, aa = FP2.mul_many([(a, b), (a, a)])
    assert FP2.to_int_pairs(ab) == [_Fp2.mul(x, y) for x, y in zip(xs, ys)]
    assert FP2.to_int_pairs(aa) == [_Fp2.mul(x, x) for x in xs]
    inv = FP2.to_int_pairs(FP2.batch_inv(a))
    assert [_Fp2.mul(v, x) for v, x in zip(inv, xs)][1:] == [(1, 0)] * (B - 1)
    assert inv[0] == (0, 0)  # inv(0) = 0


def test_g2_rows32_match_jax():
    """to_rows32 gives JAX's to_rows + to_rows32 rows bit for bit: 48 words,
    X.c0 | X.c1 | Y.c0 | Y.c1; from_rows inverts it."""
    pts = _jax_point(G2_REF.fixed_points(8)) + [((0, 0), (0, 0))]
    want = np.asarray(JG2.to_rows32(JG2.affine_from_ints(pts)).XY)
    tp = G2.affine_from_ints(pts, device=CPU)
    rows = G2.to_rows32(tp)
    assert rows.XY.shape == (9, 48)
    assert np.array_equal(rows.XY.numpy().view(np.uint32), want)
    back = G2.from_rows(rows)
    assert all(torch.equal(a, b) for a, b in zip(back, tp))
    assert G2.affine_to_ints(back) == pts


@pytest.fixture(scope="module")
def jax_points():
    return jprecompute.fixed_point_list(JG2, 16)


@pytest.fixture(scope="module")
def points():
    return fixed_point_list(G2, 16, device=CPU)


def test_g2_fixed_points_match_jax(jax_points, points):
    for g, w in zip(points, jax_points):
        assert np.array_equal(fp2_to_jax(g), np.asarray(w))


def test_g2_bgmw_table_carries_over_from_jax(jax_points, points):
    """The JAX nh table (slot i*h'+j holds q'^j P_i) and points, carried
    into a port plan by plan_from_jax, equal the port's own table rows and
    fixed points word for word."""
    small = SimpleNamespace(c_bgmw=1, h_bgmw=3)
    jrows = np.asarray(JG2.to_rows32(
        jprecompute.build_bgmw_table(JG2, jax_points, small)).XY)
    plan = plan_from_jax({"table_nh": jrows,
                          "points": [np.asarray(c) for c in jax_points]},
                         params.make_config(4, c=8, h=32), curve=G2,
                         device=CPU)
    own = G2.to_rows32(build_bgmw_table(G2, points, small)).XY
    assert own.shape == (16 * 3, 48)
    assert torch.equal(plan.table_nh.XY, own)
    assert all(torch.equal(a, b) for a, b in zip(plan.points, points))
    assert torch.equal(plan.points_rows.XY, G2.to_rows32(points).XY)
