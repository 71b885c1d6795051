"""The port's host protocol copies against the JAX package's, on seeded
inputs: hash_to_curve (expand_message_xmd, hash_to_field, square roots and
sgn0, the SSWU and isogeny maps with their edge inputs, cofactor clearing,
psi, the four suites), glv (phi, the GLV and GLS decompositions, the
endomorphism multiplications, in_g1 / in_g2 on points outside the
subgroups), keygen (keygen, keygen_v3, EIP-2333 with its published vector)
and curves/serialize.py (round trips, the bytes of both, infinity and the
malformed inputs); protocol/__init__ exports the JAX package's names.
Outputs compare as ints, bytes and bools.

The RFC 9380 vector files the JAX package's own tests read are not in the
repository; the copies are held to the functions those tests trust.
"""

import importlib
import inspect
import random

import pytest

from msm_blst_tpu.curves import serialize as jser
from msm_blst_tpu.protocol import glv as jglv
from msm_blst_tpu.protocol import hash_to_curve as jh2c
from msm_blst_tpu.refimpl import G1_REF as JG1_REF
from msm_blst_tpu.refimpl import G2_REF as JG2_REF
from msm_blst_tpu.refimpl import field as jfield
from msm_blst_tpu_torch.constants import P, R_ORDER
from msm_blst_tpu_torch.curves import serialize as ser
from msm_blst_tpu_torch.protocol import glv
from msm_blst_tpu_torch.protocol import hash_to_curve as h2c
from msm_blst_tpu_torch.refimpl import G1_REF, G2_REF, Fp, Fp2

# protocol/__init__ exports a function named keygen, which hides the module
jkg = importlib.import_module("msm_blst_tpu.protocol.keygen")
kg = importlib.import_module("msm_blst_tpu_torch.protocol.keygen")

rng = random.Random(0x16)
MSGS = [b"", b"abc", b"abcdef0123456789", b"q128_" + b"q" * 128,
        bytes(range(256))]


def _v(x):
    """An element, a point or None of either package as ints."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_v(c) for c in x)
    return (x.c0.v, x.c1.v) if hasattr(x, "c0") else x.v


def _j2(a):
    return jfield.Fp2(a.c0.v, a.c1.v)


def _g1_outside():
    """Points of y^2 = x^3 + 4 over Fp outside G1 (the first from x = 2)."""
    out, x = [], 1
    while len(out) < 2:
        x += 1
        y = h2c.sqrt_fp(Fp(x).sqr() * Fp(x) + G1_REF.b)
        if y is not None:
            out.append((Fp(x), y))
    return out


def _g2_outside():
    """A point of E2 outside G2: the SSWU map of a u (not cofactor-cleared)."""
    return h2c.map_to_curve_g2(Fp2(3, 5))


# ---- hash_to_curve --------------------------------------------------------------


@pytest.mark.parametrize("length", [0, 32, 48, 128, 255])
def test_expand_message_xmd(length):
    dst = b"QUUX-V01-CS02-with-expander-SHA256-128"
    for m in MSGS:
        assert h2c.expand_message_xmd(m, dst, length) == \
            jh2c.expand_message_xmd(m, dst, length)
    long_dst = b"D" * 300  # hashed down (the oversize DST rule)
    assert h2c.expand_message_xmd(b"x", long_dst, 64) == \
        jh2c.expand_message_xmd(b"x", long_dst, 64)


def test_expand_message_xmd_rejects_long_outputs():
    for mod in (h2c, jh2c):
        with pytest.raises(ValueError):
            mod.expand_message_xmd(b"x", b"dst", 256 * 32)


def test_hash_to_field():
    for m in MSGS:
        for count in (1, 2):
            assert [_v(u) for u in h2c.hash_to_field_fp(m, h2c.DST_G1_RO,
                                                        count)] == \
                [_v(u) for u in jh2c.hash_to_field_fp(m, jh2c.DST_G1_RO,
                                                      count)]
            assert [_v(u) for u in h2c.hash_to_field_fp2(m, h2c.DST_G2_RO,
                                                         count)] == \
                [_v(u) for u in jh2c.hash_to_field_fp2(m, jh2c.DST_G2_RO,
                                                       count)]


def test_dsts_and_constants():
    for name in ("DST_G1_RO", "DST_G1_NU", "DST_G2_RO", "DST_G2_NU",
                 "G1_H_EFF", "BLS_X"):
        assert getattr(h2c, name) == getattr(jh2c, name)
    assert _v(h2c._PSI_CX) == _v(jh2c._PSI_CX)
    assert _v(h2c._PSI_CY) == _v(jh2c._PSI_CY)


def test_square_roots_and_sign():
    vals = [0, 1, P - 1, 4] + [rng.randrange(P) for _ in range(6)]
    for a in vals:
        assert _v(h2c.sqrt_fp(Fp(a))) == _v(jh2c.sqrt_fp(jfield.Fp(a)))
        assert h2c.is_square_fp(Fp(a)) == jh2c.is_square_fp(jfield.Fp(a))
        assert h2c.sgn0_fp(Fp(a)) == jh2c.sgn0_fp(jfield.Fp(a))
    pairs = [(0, 0), (P - 1, 0), (P - 25, 0), (0, 7), (3, 0)] + [
        (rng.randrange(P), rng.randrange(P)) for _ in range(6)]
    for a in pairs:
        t, j = Fp2(*a), jfield.Fp2(*a)
        assert _v(h2c.sqrt_fp2(t)) == _v(jh2c.sqrt_fp2(j))
        assert h2c.is_square_fp2(t) == jh2c.is_square_fp2(j)
        assert h2c.sgn0_fp2(t) == jh2c.sgn0_fp2(j)
        r = h2c.sqrt_fp2(t)
        assert (r is not None and r.sqr() == t) == h2c.is_square_fp2(t)


def _edge_us():
    """u = 0 (the exceptional x1), u whose g(x1) is and is not a square,
    and random u."""
    us = [0, 1, P - 1]
    a, b, z = h2c._G1_A, h2c._G1_B, h2c._G1_Z
    want = {True: 1, False: 1}
    while any(want.values()):
        u = Fp(rng.randrange(P))
        tv1 = z * u.sqr()
        x1 = (-b) * a.inv() * ((tv1.sqr() + tv1).inv() + Fp.one())
        sq = h2c.is_square_fp((x1.sqr() + a) * x1 + b)
        if want[sq]:
            want[sq] -= 1
            us.append(u.v)
    return us


def test_map_to_curve_g1_and_clearing():
    for u in _edge_us():
        t, j = h2c.map_to_curve_g1(Fp(u)), jh2c.map_to_curve_g1(jfield.Fp(u))
        assert _v(t) == _v(j), u
        assert G1_REF.is_on_curve(t)
        assert _v(h2c.clear_cofactor_g1(t)) == _v(jh2c.clear_cofactor_g1(j))
        x, y = h2c._sswu(Fp(u), h2c._G1_A, h2c._G1_B, h2c._G1_Z, h2c.sqrt_fp,
                         h2c.is_square_fp, h2c.sgn0_fp)
        jx, jy = jh2c._sswu(jfield.Fp(u), jh2c._G1_A, jh2c._G1_B, jh2c._G1_Z,
                            jh2c.sqrt_fp, jh2c.is_square_fp, jh2c.sgn0_fp)
        assert _v((x, y)) == _v((jx, jy))


def test_map_to_curve_g2_clearing_and_psi():
    us = [(0, 0), (0, 5), (1, 0)] + [(rng.randrange(P), rng.randrange(P))
                                     for _ in range(3)]
    for u in us:
        t, j = h2c.map_to_curve_g2(Fp2(*u)), jh2c.map_to_curve_g2(
            jfield.Fp2(*u))
        assert _v(t) == _v(j), u
        assert G2_REF.is_on_curve(t)
        assert _v(h2c.psi(t)) == _v(jh2c.psi(j))
        assert _v(h2c.psi2(t)) == _v(jh2c.psi2(j))
    t, j = h2c.map_to_curve_g2(Fp2(*us[-1])), jh2c.map_to_curve_g2(
        jfield.Fp2(*us[-1]))
    assert _v(h2c.clear_cofactor_g2(t)) == _v(jh2c.clear_cofactor_g2(j))


@pytest.mark.parametrize("suite", ["hash_to_g1", "encode_to_g1",
                                   "hash_to_g2", "encode_to_g2"])
def test_suites(suite):
    msgs = MSGS[:3] if suite.endswith("g1") else MSGS[:2]
    for m in msgs:
        got = getattr(h2c, suite)(m)
        assert got == getattr(jh2c, suite)(m), m
    dst = b"QUUX-V01-CS02-with-BLS12381G1_XMD:SHA-256_SSWU_RO_"
    assert getattr(h2c, suite)(b"abc", dst) == getattr(jh2c, suite)(b"abc",
                                                                      dst)


def test_hash_outputs_in_group():
    p1, p2 = h2c.hash_to_g1(b"group membership"), h2c.hash_to_g2(
        b"group membership")
    assert glv.in_g1((Fp(p1[0]), Fp(p1[1])))
    assert glv.in_g2((Fp2(*p2[0]), Fp2(*p2[1])))


# ---- glv --------------------------------------------------------------------------


def test_glv_constants_and_phi():
    assert (glv.BETA, glv.LAMBDA) == (jglv.BETA, jglv.LAMBDA)
    g = G1_REF.gen_affine
    assert _v(glv.phi(g)) == _v(jglv.phi(JG1_REF.gen_affine))
    assert _v(glv.phi(G1_REF.affine_inf())) == (0, 0)


def test_decompositions():
    ks = [0, 1, R_ORDER - 1, R_ORDER, -5] + [rng.randrange(R_ORDER)
                                             for _ in range(8)]
    for k in ks:
        assert glv.glv_decompose(k) == jglv.glv_decompose(k)
        assert glv.gls_decompose(k) == jglv.gls_decompose(k)


def test_endomorphism_mults():
    for k in (0, 1, rng.randrange(R_ORDER)):
        assert _v(glv.mult_glv_g1(k, G1_REF.gen_affine)) == _v(
            jglv.mult_glv_g1(k, JG1_REF.gen_affine))
    k = rng.randrange(R_ORDER)
    assert _v(glv.mult_gls_g2(k, G2_REF.gen_affine)) == _v(
        jglv.mult_gls_g2(k, JG2_REF.gen_affine))


def test_in_group_on_cofactor_points():
    for pt in _g1_outside() + [G1_REF.gen_affine, G1_REF.affine_inf(),
                               (Fp(1), Fp(1))]:
        jpt = (jfield.Fp(pt[0].v), jfield.Fp(pt[1].v))
        assert glv.in_g1(pt) == jglv.in_g1(jpt)
    assert not glv.in_g1(_g1_outside()[0])
    q = _g2_outside()
    for pt in (q, G2_REF.gen_affine, G2_REF.affine_inf()):
        assert glv.in_g2(pt) == jglv.in_g2((_j2(pt[0]), _j2(pt[1])))
    assert not glv.in_g2(q)
    assert glv.in_g2(h2c.clear_cofactor_g2(q))


# ---- keygen -----------------------------------------------------------------------


def test_keygen():
    for ikm in (b"\x01" * 32, bytes(range(40))):
        for info in (b"", b"key info"):
            assert kg.keygen(ikm, info) == jkg.keygen(ikm, info)
            assert kg.keygen_v3(ikm, info) == jkg.keygen_v3(ikm, info)
    for fn in (kg.keygen, kg.keygen_v3, kg.derive_master_eip2333):
        with pytest.raises(ValueError):
            fn(b"short")


def test_eip2333():
    seed = bytes.fromhex(
        "c55257c360c07c72029aebc1b53c05ed0362ada38ead3e3e9efa3708"
        "e53495531f09a6987599d18264c1e1c92f2cf141630c7a3c4ab7c81b"
        "2f001698e7463b04")
    master = kg.derive_master_eip2333(seed)
    assert master == jkg.derive_master_eip2333(seed) == \
        6083874454709270928345386274498605044986640685124978867557563392430687146096
    child = kg.derive_child_eip2333(master, 0)
    assert child == jkg.derive_child_eip2333(master, 0) == \
        20397789859736650942317412262472558107875392172444076792671091975210932703118
    assert kg.derive_path_eip2333(seed, [0, 7]) == jkg.derive_path_eip2333(
        seed, [0, 7])


# ---- curves/serialize.py ----------------------------------------------------------


def _g1_points():
    pts = [G1_REF.affine_mult(rng.randrange(1, R_ORDER), G1_REF.gen_affine)
           for _ in range(3)]
    return [_v(p) for p in pts] + [(0, 0)]


def _g2_points():
    pts = [G2_REF.affine_mult(rng.randrange(1, R_ORDER), G2_REF.gen_affine)
           for _ in range(2)]
    return [_v(p) for p in pts] + [((0, 0), (0, 0))]


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_serialize_round_trips_and_bytes(curve):
    pts = _g1_points() if curve == "g1" else _g2_points()
    for pt in pts:
        for kind in ("compress", "serialize"):
            b = getattr(ser, f"{curve}_{kind}")(pt)
            assert b == getattr(jser, f"{curve}_{kind}")(pt)
            assert getattr(ser, f"{curve}_deserialize")(b) == pt
        comp = getattr(ser, f"{curve}_compress")(pt)
        assert getattr(ser, f"{curve}_uncompress")(comp) == \
            getattr(jser, f"{curve}_uncompress")(comp) == pt
        neg = (pt[0], tuple((P - c) % P for c in pt[1])) if curve == "g2" \
            else (pt[0], (P - pt[1]) % P)
        assert getattr(ser, f"{curve}_compress")(neg) == \
            getattr(jser, f"{curve}_compress")(neg)


@pytest.mark.parametrize("curve, size", [("g1", 48), ("g2", 96)])
def test_serialize_rejects_what_jax_rejects(curve, size):
    bad = [bytes(size),  # compressed bit not set
           bytes([0xC1]) + bytes(size - 1),  # malformed infinity
           bytes([0x80]) + b"\xff" * (size - 1),  # x not canonical
           bytes(size - 1),  # wrong length
           bytes([0x40]) + bytes(2 * size - 1),  # uncompressed infinity
           bytes([0x40, 1]) + bytes(2 * size - 2),  # ... malformed
           b"\x01" * (2 * size)]  # uncompressed, not on the curve
    x = 1
    while True:  # an x of G1 or G2 with no point on the curve
        x += 1
        b = (bytes([0x80]) + bytes(size - 1 - 1) + bytes([x]))
        try:
            jser.g1_uncompress(b) if curve == "g1" else jser.g2_uncompress(b)
        except ValueError:
            bad.append(b)
            break
    for b in bad:
        outs = []
        for mod in (ser, jser):
            try:
                outs.append(getattr(mod, f"{curve}_deserialize")(b))
            except ValueError as err:
                outs.append(("ValueError", str(err)))
        assert outs[0] == outs[1], b.hex()


def test_protocol_package_exports_the_jax_names():
    """protocol/__init__ exports what the JAX package's does, each name the
    port's own function or class of the same name."""
    jp = importlib.import_module("msm_blst_tpu.protocol")
    tp = importlib.import_module("msm_blst_tpu_torch.protocol")

    def exported(pkg):
        return {n for n in dir(pkg) if not n.startswith("_")
                and not inspect.ismodule(getattr(pkg, n))}

    names = exported(jp)
    assert names == exported(tp) and len(names) == 33
    for n in names:
        obj = getattr(tp, n)
        assert getattr(obj, "__name__", n) == getattr(getattr(jp, n),
                                                      "__name__", n)
        if callable(obj):
            assert obj.__module__.startswith("msm_blst_tpu_torch.protocol")
