"""The three K2 point formulas (and the xyzz conversions) against the JAX
package's G1 ops, bit for bit, with degenerate lanes.

On the CPU, JAX's G1.xyzz_* run the plain formula bodies of curves/ops.py —
the bodies that tests/test_pallas.py holds against the interpret-mode Pallas
kernel. The port's wrappers run their plain versions on CPU tensors. Inputs
are built on the JAX side and converted, so both get the same words.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.curves import G1 as JG1
from msm_blst_tpu.refimpl import G1_REF
from msm_blst_tpu_torch.convert import fp_from_jax, fp_to_jax
from msm_blst_tpu_torch.curves import G1, AffinePoint, XyzzPoint, cuda_point

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

B = 16


def _ref_points(seed):
    rng = random.Random(seed)
    gen = G1_REF.generator_jac()
    out = []
    for _ in range(B):
        x, y = G1_REF.to_affine(G1_REF.jac_mult(rng.randrange(1, 1 << 64), gen))
        out.append((x.v, y.v))
    return out


def _inputs():
    """JAX-side inputs. acc lanes: 0 infinity; 1, 2 equal to pts (P+P, and
    P-P with the sign set); 3 adds the affine infinity; 4 both infinite."""
    pts = JG1.affine_from_ints(_ref_points(1))
    lane = jnp.arange(B)
    pts = type(pts)(*(jnp.where((lane == 3) | (lane == 4), 0, c) for c in pts))
    other = JG1.affine_from_ints(_ref_points(2))
    acc = jax.jit(JG1.xyzz_double)(JG1.xyzz_from_affine(other))
    inf = JG1.xyzz_inf((B,))
    acc = JG1.select((lane == 0) | (lane == 4), inf, acc)
    acc = JG1.select((lane == 1) | (lane == 2), JG1.xyzz_from_affine(pts), acc)
    signs = (lane == 2) | (lane % 5 == 4)
    return acc, pts, signs


def _same(port_pt, jax_pt):
    for a, b in zip(port_pt, jax_pt):
        assert np.array_equal(fp_to_jax(a), np.asarray(b))


def _port(jpt, cls):
    return cls(*(fp_from_jax(np.asarray(c), CPU) for c in jpt))


@pytest.mark.parametrize("op", ["dadd_affine", "dadd", "double"])
def test_point_op_matches_jax(op):
    acc, pts, signs = _inputs()
    tacc = _port(acc, XyzzPoint)
    tsg = torch.as_tensor(np.array(signs))
    if op == "dadd_affine":
        want = jax.jit(JG1.xyzz_dadd_affine)(acc, pts, signs)
        tp = _port(pts, AffinePoint)
        got = G1.xyzz_dadd_affine(tacc, tp, tsg)
        plain = cuda_point.xyzz_dadd_affine_plain(G1, tacc, tp, tsg)
    elif op == "dadd":
        q = JG1.xyzz_from_affine(pts, negate=signs)
        want = jax.jit(JG1.xyzz_dadd)(acc, q)
        tq = _port(q, XyzzPoint)
        got = G1.xyzz_dadd(tacc, tq)
        plain = cuda_point.xyzz_dadd_plain(G1, tacc, tq)
    else:
        want = jax.jit(JG1.xyzz_double)(acc)
        got = G1.xyzz_double(tacc)
        plain = cuda_point.xyzz_double_plain(G1, tacc)
    _same(got, want)
    _same(plain, want)


def test_degenerate_lanes_are_exercised():
    """The inputs reach the double, cancel and infinity cases."""
    acc, pts, signs = _inputs()
    out = G1.xyzz_dadd_affine(_port(acc, XyzzPoint), _port(pts, AffinePoint),
                              torch.as_tensor(np.array(signs)))
    aff = G1.affine_to_ints(G1.xyzz_to_affine(out))
    p1 = _ref_points(1)[1]
    two = G1_REF.to_affine(G1_REF.jac_double(G1_REF.from_affine(
        (G1_REF.F(p1[0]), G1_REF.F(p1[1])))))
    assert aff[1] == (two[0].v, two[1].v)      # P + P
    assert aff[2] == (0, 0)                    # P - P
    assert aff[0] == _ref_points(1)[0]         # inf + P
    assert aff[4] == (0, 0)                    # inf + inf


def test_xyzz_conversions_match_jax():
    acc, pts, _ = _inputs()
    tacc = _port(acc, XyzzPoint)
    _same(G1.xyzz_to_jac(tacc), jax.jit(JG1.xyzz_to_jac)(acc))
    _same(G1.xyzz_to_affine(tacc), jax.jit(JG1.xyzz_to_affine)(acc))
