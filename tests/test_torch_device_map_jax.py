"""The port's G1 map (protocol/device_map.py) against the JAX package's
traced device map, word for word, on CPU tensors (the plain twin of K1):
map_to_g1_device without cofactor clearing on the edge lanes — u = 0
(tv2 = 0, the exceptional x1), u whose g(x1) is and is not a square, 1,
p - 1 and random u — and the Montgomery words of the two constants the
port works out on the host (-B/A and B/(Z A)) against JAX's device
inversions of them.

JAX's trace of its G1 map takes about 25 s on a CPU core, so it lives in
a file of its own, with the Fp2 square root's (about 9 s):
`_sqrt_fp2_device` on squares, a non-residue, -1 and -25 (alpha == -1)
and 0, roots and ok flags, and the G2 map's two host constants. The traces of
hash_to_g1_device, of the cleared G1 map and of the G2 map are in
tests/test_torch_device_map_jax_slow.py (slow).
"""

import random

import jax
import numpy as np
import torch

from msm_blst_tpu.fields.fp2 import FP2 as JFP2
from msm_blst_tpu.fields.limb import FP as JFP
from msm_blst_tpu.protocol import device_map as jdm
from msm_blst_tpu.protocol import hash_to_curve as jh2c
from msm_blst_tpu.protocol import iso_constants as JK
from msm_blst_tpu.refimpl.field import Fp as JFp
from msm_blst_tpu.refimpl.field import Fp2 as JFp2
from msm_blst_tpu_torch.constants import P
from msm_blst_tpu_torch.convert import fp2_from_jax, fp_from_jax
from msm_blst_tpu_torch.protocol import device_map as dm

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

rng = random.Random(0xD3F1CF)


def _edge_us():
    us = [0, 1, P - 1, rng.randrange(P)]
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


def test_map_to_g1_device_words_equal_jax_trace():
    us = _edge_us()
    u_j = JFP.from_ints(us)
    want = jax.jit(lambda u: jdm.map_to_g1_device(u, clear_cofactor=False))(
        u_j)
    got = dm.map_to_g1_device(fp_from_jax(np.asarray(u_j), device=CPU),
                              clear_cofactor=False, device=CPU)
    for g, w in zip(got, want):
        assert torch.equal(g, fp_from_jax(np.asarray(w), device=CPU))


def test_host_constants_words_equal_jax_device_inversions():
    def consts():
        A = jdm._mont_const_fp(JK.G1_A, (1,))
        B = jdm._mont_const_fp(JK.G1_B, (1,))
        Z = jdm._mont_const_fp(JK.G1_SSWU_Z, (1,))
        return (JFP.mul(JFP.neg(B), JFP.inv(A)),
                JFP.mul(B, JFP.inv(JFP.mul(Z, A))))

    want = jax.jit(consts)()
    for value, w in zip((dm._G1_MB_OVER_A, dm._G1_B_OVER_ZA), want):
        got = dm._mont_const_fp(value, (1,), CPU)
        assert torch.equal(got, fp_from_jax(np.asarray(w), device=CPU))


def test_sqrt_fp2_device_words_equal_jax_trace():
    roots = [JFp2(rng.randrange(P), rng.randrange(P)) for _ in range(2)]
    vals = [(r.sqr().c0.v, r.sqr().c1.v) for r in roots]
    vals += [(P - 1, 0), (P - 25, 0), (0, 0), (3, 5)]
    a_j = JFP2.from_int_pairs(vals)
    root_j, ok_j = jax.jit(jdm._sqrt_fp2_device)(a_j)
    root, ok = dm._sqrt_fp2_device(fp2_from_jax(np.asarray(a_j), device=CPU))
    assert torch.equal(root, fp2_from_jax(np.asarray(root_j), device=CPU))
    assert ok.tolist() == np.asarray(ok_j).tolist()
    assert ok.tolist()[:5] == [True] * 5


def test_g2_host_constants_words_equal_jax_device_inversions():
    def consts():
        A = jdm._mont_const_fp2(*JK.G2_A, (1,))
        B = jdm._mont_const_fp2(*JK.G2_B, (1,))
        Z = jdm._mont_const_fp2(*JK.G2_SSWU_Z, (1,))
        return (JFP2.mul(JFP2.neg(B), JFP2.inv(A)),
                JFP2.mul(B, JFP2.inv(JFP2.mul(Z, A))))

    want = jax.jit(consts)()
    for value, w in zip((dm._G2_MB_OVER_A, dm._G2_B_OVER_ZA), want):
        got = dm._mont_const_fp2(value.c0.v, value.c1.v, (1,), CPU)
        assert torch.equal(got, fp2_from_jax(np.asarray(w), device=CPU))
