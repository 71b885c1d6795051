"""The port's batched SSWU maps (protocol/device_map.py) on CPU tensors —
the plain twins of K1 and K2 — against the JAX package's host maps
(protocol/hash_to_curve.py), the functions the JAX device maps are tested
against, on the edge lanes:

* G1: u = 0 (tv2 = 0, the exceptional x1), u whose g(x1) is not a square
  (x2 taken) and one whose g(x1) is, 1, p - 1 (opposite signs) and random
  u; `_sswu_g1` against the host SSWU, `_iso_g1` against the host
  isogeny, `map_to_g1_device` with and without cofactor clearing;
  `hash_to_g1_device` on messages, and its body on u pairs whose maps are
  equal (K2's doubling case), opposite (cancelling) or both u = 0.
* G2: `_sqrt_fp2_device` with its ok flags (squares, a non-residue, -1 and
  -25, where alpha == -1, and 0), `_sgn0_fp2_device` (c0 == 0 with c1 odd
  and even), `_mul_by_i` and `map_to_g2_device` on u = 0, u with c0 = 0,
  u in Fp and random u.

Affine outputs are canonical, so equal ints are equal words. The JAX
traces of the maps: tests/test_torch_device_map_jax.py (the G1 map) and
tests/test_torch_device_map_jax_slow.py.
"""

import random

import numpy as np
import pytest
import torch

from msm_blst_tpu.protocol import hash_to_curve as jh2c
from msm_blst_tpu.refimpl import G1_REF as JG1_REF
from msm_blst_tpu.refimpl.field import Fp as JFp
from msm_blst_tpu.refimpl.field import Fp2 as JFp2
from msm_blst_tpu_torch.constants import P
from msm_blst_tpu_torch.curves import G1, G2
from msm_blst_tpu_torch.fields import FP, FP2
from msm_blst_tpu_torch.protocol import device_map as dm

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

rng = random.Random(0xD3F1CE)


def g1_edge_us():
    """[0, 1, p - 1, u with g(x1) a square, u with g(x1) not a square]."""
    us = [0, 1, P - 1]
    a, b, z = jh2c._G1_A, jh2c._G1_B, jh2c._G1_Z
    want = {True: 1, False: 1}
    while any(want.values()):
        u = JFp(rng.randrange(P))
        tv1 = z * u.sqr()
        x1 = (-b) * a.inv() * ((tv1.sqr() + tv1).inv() + JFp.one())
        sq = jh2c.is_square_fp((x1.sqr() + a) * x1 + b)
        if want[sq]:
            want[sq] -= 1
            us.append(u.v)
    return us


G1_US = g1_edge_us()


def _ints(pt):
    return tuple(c.v for c in pt)


def _ints2(pt):
    return tuple((c.c0.v, c.c1.v) for c in pt)


def _fp(xs):
    return FP.from_ints(xs, device=CPU)


def test_sswu_and_iso_g1():
    x, y = dm._sswu_g1(_fp(G1_US))
    got = list(zip(FP.to_ints(x), FP.to_ints(y)))
    jx = [jh2c._sswu(JFp(u), jh2c._G1_A, jh2c._G1_B, jh2c._G1_Z,
                     jh2c.sqrt_fp, jh2c.is_square_fp, jh2c.sgn0_fp)
          for u in G1_US]
    assert got == [_ints(p) for p in jx]
    iso = G1.affine_to_ints(dm._iso_g1(x, y))
    assert iso == [_ints(jh2c._iso_map(*p, jh2c._G1_XNUM, jh2c._G1_XDEN,
                                       jh2c._G1_YNUM, jh2c._G1_YDEN))
                   for p in jx]


@pytest.mark.parametrize("clear", [False, True], ids=["on_E1", "cleared"])
def test_map_to_g1_device(clear):
    got = G1.affine_to_ints(dm.map_to_g1_device(_fp(G1_US),
                                                clear_cofactor=clear,
                                                device=CPU))
    for u, pt in zip(G1_US, got):
        want = jh2c.map_to_curve_g1(JFp(u))
        if clear:
            want = jh2c.clear_cofactor_g1(want)
        assert pt == _ints(want), u


def test_hash_to_g1_device():
    msgs = [b"", b"abc", b"batched hash to curve"]
    got = G1.affine_to_ints(dm.hash_to_g1_device(msgs, device=CPU))
    assert got == [jh2c.hash_to_g1(m) for m in msgs]
    dst = b"QUUX-V01-CS02-with-BLS12381G1_XMD:SHA-256_SSWU_RO_"
    got = G1.affine_to_ints(dm.hash_to_g1_device([b"abc"], dst, device=CPU))
    assert got == [jh2c.hash_to_g1(b"abc", dst)]


def test_hash_to_g1_doubling_and_cancelling():
    """u0, u1 pairs whose maps are equal (K2's add doubles), opposite
    (sgn0 flips with u: map(p - u) = -map(u); the add cancels to infinity)
    and u0 = u1 = 0, then a random pair."""
    u, v, w = G1_US[3], G1_US[4], rng.randrange(P)
    pairs = [(u, u), (v, P - v), (0, 0), (w, v)]
    got = G1.affine_to_ints(dm._run_hash_to_g1(
        _fp([x for pair in pairs for x in pair])))
    want = []
    for u0, u1 in pairs:
        q0, q1 = (jh2c.map_to_curve_g1(JFp(x)) for x in (u0, u1))
        q = JG1_REF.to_affine(JG1_REF.jac_add(JG1_REF.from_affine(q0),
                                              JG1_REF.from_affine(q1)))
        want.append(_ints(jh2c.clear_cofactor_g1(q)))
    assert got == want
    assert got[1] == (0, 0)  # the cancelling pair


# ---- G2 ---------------------------------------------------------------------


def _fp2(pairs):
    return FP2.from_int_pairs(pairs, device=CPU)


def _nonresidue():
    while True:
        c = JFp2(rng.randrange(P), rng.randrange(P))
        if jh2c.sqrt_fp2(c) is None:
            return (c.c0.v, c.c1.v)


def test_sqrt_fp2_device():
    roots = [JFp2(rng.randrange(P), rng.randrange(P)) for _ in range(3)]
    vals = [(r.sqr().c0.v, r.sqr().c1.v) for r in roots]
    # -1 and -25 (= (5i)^2): alpha == -1; 0; a non-residue
    vals += [(P - 1, 0), (P - 25, 0), (0, 0), _nonresidue()]
    root, ok = dm._sqrt_fp2_device(_fp2(vals))
    want_ok = [jh2c.sqrt_fp2(JFp2(*v)) is not None for v in vals]
    assert ok.tolist() == want_ok == [True] * 6 + [False]
    for (r0, r1), v, good in zip(FP2.to_int_pairs(root), vals, want_ok):
        if good:
            assert JFp2(r0, r1).sqr() == JFp2(*v)
            host = jh2c.sqrt_fp2(JFp2(*v))
            assert (r0, r1) in ((host.c0.v, host.c1.v),
                                ((-host).c0.v, (-host).c1.v))


def test_sqrt_fp2_device_alpha_minus_one_branch():
    """-1 and -25 take the i * x0 branch (the other gives 0, which is no
    root): their roots are i and 5i up to sign."""
    root, ok = dm._sqrt_fp2_device(_fp2([(P - 1, 0), (P - 25, 0)]))
    assert ok.tolist() == [True, True]
    got = FP2.to_int_pairs(root)
    assert got[0] in ((0, 1), (0, P - 1)) and got[1] in ((0, 5), (0, P - 5))


def test_sgn0_fp2_device():
    vals = [(0, 0), (0, 1), (0, 2), (1, 0), (2, 7), (P - 1, 3)] + [
        (rng.randrange(P), rng.randrange(P)) for _ in range(4)]
    got = dm._sgn0_fp2_device(_fp2(vals)).tolist()
    assert got == [bool(jh2c.sgn0_fp2(JFp2(*v))) for v in vals]


def test_mul_by_i():
    vals = [(3, 5), (0, 1), (0, 0)]
    got = FP2.to_int_pairs(dm._mul_by_i(_fp2(vals)))
    assert got == [((P - b) % P, a) for a, b in vals]


def test_map_to_g2_device():
    us = [(0, 0), (0, 5), (7, 0)] + [(rng.randrange(P), rng.randrange(P))
                                     for _ in range(3)]
    got = G2.affine_to_ints(dm.map_to_g2_device(_fp2(us), device=CPU))
    assert got == [_ints2(jh2c.map_to_curve_g2(JFp2(*u))) for u in us]


def test_host_constants_are_the_inverted_ones():
    """-B/A and B/(Z A), worked out once on the host, are the values the
    JAX map computes on the device from A, B and Z (a canonical value has
    one Montgomery form, so the words are the same)."""
    a, b, z = jh2c._G1_A, jh2c._G1_B, jh2c._G1_Z
    assert dm._G1_MB_OVER_A == ((-b) * a.inv()).v
    assert dm._G1_B_OVER_ZA == (b * (z * a).inv()).v
    a, b, z = jh2c._G2_A, jh2c._G2_B, jh2c._G2_Z
    assert (dm._G2_MB_OVER_A.c0.v, dm._G2_MB_OVER_A.c1.v) == (
        ((-b) * a.inv()).c0.v, ((-b) * a.inv()).c1.v)
    c = b * (z * a).inv()
    assert (dm._G2_B_OVER_ZA.c0.v, dm._G2_B_OVER_ZA.c1.v) == (c.c0.v, c.c1.v)
    words = dm._mont_const_fp(dm._G1_MB_OVER_A, (3,), CPU)
    assert words.shape == (12, 3)
    assert FP.to_ints(words) == [dm._G1_MB_OVER_A] * 3
    assert np.array_equal(words[:, 0].numpy(), words[:, 2].numpy())
