"""The three K2 point formulas over G2 against the JAX package's G2 ops, bit
for bit, with degenerate lanes: P == Q (doubles), P == -Q (cancels) and
infinity on either side, for both signs of the mixed add.

On the CPU, JAX's G2.xyzz_* run the plain formula bodies of curves/ops.py
(tests/test_pallas.py holds them against the Pallas kernel); they run
eagerly here, since one jit of the three G2 formulas takes longer to compile
than the whole comparison. The port's wrappers run their plain versions on
CPU tensors. Inputs are affine oracle points (numpy seed) converted to both
sides, so both get the same words; equality is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.constants import P
from msm_blst_tpu.curves import G2 as JG2
from msm_blst_tpu.curves.ops import AffinePoint as JAffine
from msm_blst_tpu.curves.ops import XyzzPoint as JXyzz
from msm_blst_tpu_torch.convert import fp2_to_jax
from msm_blst_tpu_torch.curves import G2, cuda_point
from msm_blst_tpu_torch.refimpl import G2 as ref

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

B = 12


def _ints(seed):
    rng = np.random.default_rng(seed)
    return [ref.mult(int.from_bytes(rng.bytes(8), "little") + 1)
            for _ in range(B)]


@pytest.fixture(scope="module")
def inputs():
    """Port and JAX inputs. acc lanes: 0 infinity; 1, 2 equal to pts (P+P,
    and P-P with the sign set); 3 adds the affine infinity; 4 both infinite;
    5, 6 hold -pts ((-P) - P with the sign set doubles, (-P) + P cancels).
    Signs: lanes 2, 4, 5, 9 subtract."""
    lane = torch.arange(B)
    pts = _ints(1)
    pts[3] = pts[4] = ref.INF
    tp = G2.affine_from_ints(pts, device=CPU)
    acc = G2.xyzz_double(G2.xyzz_from_affine(
        G2.affine_from_ints(_ints(2), device=CPU)))
    inf = G2.xyzz_inf((B,), CPU)
    acc = G2.select((lane == 0) | (lane == 4), inf, acc)
    acc = G2.select((lane == 1) | (lane == 2), G2.xyzz_from_affine(tp), acc)
    neg = G2.xyzz_from_affine(tp, negate=torch.ones(B, dtype=torch.bool))
    acc = G2.select((lane == 5) | (lane == 6), neg, acc)
    signs = (lane == 2) | (lane == 4) | (lane == 5) | (lane == 9)
    j = {"acc": [jnp.asarray(fp2_to_jax(c)) for c in acc],
         "pts": [jnp.asarray(fp2_to_jax(c)) for c in tp],
         "signs": jnp.asarray(signs.numpy())}
    return (acc, tp, signs), j, pts


def _same(port_pt, jax_pt):
    for a, b in zip(port_pt, jax_pt):
        assert np.array_equal(fp2_to_jax(a), np.asarray(b))


@pytest.mark.parametrize("op", ["dadd_affine", "dadd_affine_add", "dadd",
                                "double"])
def test_g2_point_op_matches_jax(inputs, op):
    (acc, tp, signs), j, _ = inputs
    jacc, jpts = JXyzz(*j["acc"]), JAffine(*j["pts"])
    if op.startswith("dadd_affine"):
        sub = signs if op == "dadd_affine" else None
        jsub = j["signs"] if op == "dadd_affine" else None
        want = JG2.xyzz_dadd_affine(jacc, jpts, jsub)
        got = G2.xyzz_dadd_affine(acc, tp, sub)
        plain = cuda_point.xyzz_dadd_affine_plain(G2, acc, tp, sub)
    elif op == "dadd":
        q = G2.xyzz_from_affine(tp, negate=signs)
        want = JG2.xyzz_dadd(jacc, JG2.xyzz_from_affine(jpts, negate=j["signs"]))
        got = G2.xyzz_dadd(acc, q)
        plain = cuda_point.xyzz_dadd_plain(G2, acc, q)
    else:
        want = JG2.xyzz_double(jacc)
        got = G2.xyzz_double(acc)
        plain = cuda_point.xyzz_double_plain(G2, acc)
    _same(got, want)
    _same(plain, want)


def test_g2_degenerate_lanes_are_exercised(inputs):
    """The inputs reach the double, cancel and infinity cases, by the
    oracle."""
    (acc, tp, signs), _, pts = inputs
    out = G2.affine_to_ints(G2.xyzz_to_affine(
        G2.xyzz_dadd_affine(acc, tp, signs)))
    assert out[0] == pts[0]                       # inf + P
    assert out[1] == ref.add(pts[1], pts[1])      # P + P
    assert out[2] == ref.INF                      # P - P
    assert out[4] == ref.INF                      # inf - inf
    x2, y2 = ref.add(pts[5], pts[5])
    assert out[5] == (x2, tuple(-v % P for v in y2))  # -P - P = -2P
    assert out[6] == ref.INF                      # -P + P


def test_g2_xyzz_conversions_match_jax(inputs):
    (acc, _, _), j, _ = inputs
    jac, aff = jax.jit(lambda p: (JG2.xyzz_to_jac(p), JG2.xyzz_to_affine(p)))(
        JXyzz(*j["acc"]))
    _same(G2.xyzz_to_jac(acc), jac)
    _same(G2.xyzz_to_affine(acc), aff)
