"""The port's blst-named facade (msm_blst_tpu_torch/api.py) against the JAX
package's (msm_blst_tpu/api.py), which is imported, never traced:

* the surface: every name of JAX's `__all__` is in the port's; each
  function's signature equals JAX's but for a keyword-only `device`, which
  exactly the entries that touch the card take (the engine functions the
  JAX facade re-exports are the port's own, with JAX's parameters first);
* every host entry, driven by name over seeded and edge inputs (infinity,
  0, 1, p - 1, non-residues, points off the curve and outside the
  subgroup, serialize round trips, an Fp12 outside GT), gives JAX's
  output;
* one keygen -> sign -> core_verify round trip on each variant (pk in G1,
  pk in G2), equal to JAX's at every step.
"""

import functools
import importlib
import inspect
import typing

import numpy as np
import pytest

import msm_blst_tpu.api as J
import msm_blst_tpu_torch.api as T
from msm_blst_tpu_torch.constants import P, R_ORDER

PKGS = ("msm_blst_tpu", "msm_blst_tpu_torch")
API = {"msm_blst_tpu": J, "msm_blst_tpu_torch": T}

# the entries that run on the card, each with a keyword-only `device`
DEVICE_ENTRIES = {
    f"{g}{name}" for g in ("p1", "p2") for name in (
        "s_to_affine", "s_add", "s_mult_pippenger", "s_tile_pippenger",
        "s_mult_wbits_precompute", "s_mult_wbits", "_tile_pippenger_d_CHES",
        "_tile_pippenger_BGMW95")}
# JAX's facade re-exports these engine functions; the port's take JAX's
# parameters first, then their own (device, mul_impl)
ENGINE = {"build_plan", "msm_wbits", "point_mult_ints", "points_add"}


# ---------------------------------------------------------------------------
# the surface
# ---------------------------------------------------------------------------


def test_every_name_of_jax_all_is_in_the_port():
    assert set(J.__all__) <= set(T.__all__)
    assert DEVICE_ENTRIES <= set(T.__all__)


@pytest.mark.parametrize("name", sorted(
    n for n in J.__all__ if inspect.isfunction(getattr(J, n))))
def test_signature(name):
    want = inspect.signature(getattr(J, name))
    got = inspect.signature(getattr(T, name))
    params = list(got.parameters.values())
    if name in ENGINE:
        assert [p.name for p in params[:len(want.parameters)]] == list(
            want.parameters)
        return
    if name in DEVICE_ENTRIES:
        dev = params.pop()
        assert dev.name == "device" and dev.kind is dev.KEYWORD_ONLY
        assert dev.default is None
    assert "device" not in [p.name for p in params]
    assert str(got.replace(parameters=params)) == str(want)


@pytest.mark.parametrize("name", ["AffinePoint", "fp12", "fp6", "Optional",
                                  "Sequence", "Tuple"])
def test_non_function_names(name):
    a, b = getattr(J, name), getattr(T, name)
    if name in ("Optional", "Sequence", "Tuple"):
        assert a is b is getattr(typing, name)
    elif name == "AffinePoint":
        assert a._fields == b._fields
    else:
        assert (list(inspect.signature(a).parameters)
                == list(inspect.signature(b).parameters))


# ---------------------------------------------------------------------------
# the host entries, by name
# ---------------------------------------------------------------------------


def _norm(x):
    """Host ints out of any facade output: tuples and lists by element,
    field elements by value (Fp .v; Fp2, Fp6, Fp12 by component)."""
    if isinstance(x, (bool, int, bytes, str, type(None))):
        return x
    if isinstance(x, (tuple, list)):
        return tuple(_norm(v) for v in x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    for fields in (("v",), ("c0", "c1", "c2"), ("c0", "c1"), ("a0", "a1")):
        if all(hasattr(x, f) for f in fields):
            out = tuple(_norm(getattr(x, f)) for f in fields)
            return out[0] if fields == ("v",) else out
    raise TypeError(type(x))


def _fp12(pkg, vals):
    """An Fp12 of the package `pkg` from 12 ints (c0, c1 of each Fp2)."""
    tower = importlib.import_module(pkg + ".protocol.tower")
    field = importlib.import_module(pkg + ".refimpl.field")
    f2 = [field.Fp2(field.Fp(vals[2 * i]), field.Fp(vals[2 * i + 1]))
          for i in range(6)]
    return tower.Fp12(tower.Fp6(*f2[:3]), tower.Fp6(*f2[3:]))


RNG = np.random.default_rng(17)


def _rand(mod):
    return int.from_bytes(RNG.bytes(64), "little") % mod


# seeded and edge values
FP_VALS = [0, 1, P - 1, _rand(P), _rand(P)]
FP_NONRES = next(a for a in range(2, 50) if pow(a, (P - 1) // 2, P) != 1)
FP2_VALS = [(0, 0), (1, 0), (0, 1), (P - 1, P - 1), (_rand(P), _rand(P)),
            (FP_NONRES, 0)]
FR_VALS = [0, 1, R_ORDER - 1, _rand(R_ORDER)]
SCALARS = [0, 1, 2, R_ORDER - 1, R_ORDER, _rand(R_ORDER), 1 << 255]

G1J = T.p1_generator()
G2J = T.p2_generator()
G1A = T.p1_affine_generator()
G2A = T.p2_affine_generator()
P1 = [G1J, T.p1_mult(G1J, 5), T.p1_mult(G1J, _rand(R_ORDER)), (1, 1, 0)]
P2 = [G2J, T.p2_mult(G2J, 7), T.p2_mult(G2J, _rand(R_ORDER)),
      ((1, 0), (1, 0), (0, 0))]
A1 = [T.p1_to_affine(p) for p in P1]
A2 = [T.p2_to_affine(p) for p in P2]


@functools.lru_cache(maxsize=None)
def _outside_g1():
    """The first point of y^2 = x^3 + 4 over Fp from x = 2 on (p = 3 mod 4,
    so y = a^((p+1)/4)); the cofactor puts it outside G1."""
    x = 1
    while True:
        x += 1
        a = (x ** 3 + 4) % P
        y = pow(a, (P + 1) // 4, P)
        if y * y % P == a:
            return (x, y)


@functools.lru_cache(maxsize=None)
def _outside_g2():
    """The first point of y^2 = x^3 + 4(1 + i) from x = (2, 0) on."""
    x = 1
    while True:
        x += 1
        a = T.fp2_add(T.fp2_mul(T.fp2_sqr((x, 0)), (x, 0)), (4, 4))
        y = T.fp2_sqrt(a)
        if y is not None:
            return ((x, 0), y)


def _cases():
    """(name, a function of the package name giving the args) for every host
    entry."""
    c = []

    def add(name, *args):
        c.append((name, lambda pkg, a=args: a))

    for name in ("p1_generator", "p2_generator", "p1_affine_generator",
                 "p2_affine_generator"):
        add(name)
    for g, pts, aff in (("p1", P1, A1), ("p2", P2, A2)):
        for a in pts:
            for b in pts:
                add(f"{g}_add_or_double", a, b)
                add(f"{g}_add", a, b)
                add(f"{g}_is_equal", a, b)
            for b in aff:
                add(f"{g}_add_or_double_affine", a, b)
                add(f"{g}_add_affine", a, b)
            for name in ("double", "to_affine", "is_inf", "on_curve",
                         "serialize", "compress"):
                add(f"{g}_{name}", a)
            add(f"{g}_cneg", a, True)
            add(f"{g}_cneg", a, False)
            for k in SCALARS[:4]:
                add(f"{g}_mult", a, k)
        neg = (T.p1_cneg if g == "p1" else T.p2_cneg)(pts[1], True)
        add(f"{g}_add_or_double", pts[1], neg)  # P + (-P): infinity
        add(f"{g}_is_equal", pts[1], T.p1_double(T.p1_double(pts[0]))
            if g == "p1" else pts[0])
        for b in aff:
            for name in ("from_affine", "affine_is_inf", "affine_on_curve",
                         "affine_in_g1" if g == "p1" else "affine_in_g2",
                         "affine_serialize", "affine_compress"):
                add(f"{g}_{name}", b)
            add(f"{g}_affine_is_equal", b, aff[1])
        for name in ("in_g1", "in_g2"):
            if name.endswith(g[1]):
                for a in pts:
                    add(f"{g}_{name}", a)
    add("p1_to_xyzz", P1[2])
    add("p1_to_xyzz", P1[3])
    off1, off2 = (1, 1), ((1, 0), (1, 0))
    for g, off, outside in (("p1", off1, _outside_g1()),
                            ("p2", off2, _outside_g2())):
        grp = "g1" if g == "p1" else "g2"
        for pt in (off, outside):
            add(f"{g}_affine_on_curve", pt)
            add(f"{g}_affine_in_{grp}", pt)
    # serialization round trips and the decoders' edges
    for g, aff, pts in (("p1", A1, P1), ("p2", A2, P2)):
        for a in aff:
            add(f"{g}_deserialize", getattr(T, f"{g}_affine_serialize")(a))
            add(f"{g}_uncompress", getattr(T, f"{g}_affine_compress")(a))
    for g, size in (("p1", 48), ("p2", 96)):
        add(f"{g}_uncompress", bytes([0xC0]) + bytes(size - 1))  # infinity
        add(f"{g}_deserialize", bytes([0x40]) + bytes(2 * size - 1))
    for w in (1, 5, 8):
        for n in (1, 1000):
            add("p1s_mult_wbits_precompute_sizeof", w, n)
            add("p2s_mult_wbits_precompute_sizeof", w, n)
    for n in (1, 64, 1 << 16, 1 << 21):
        add("p1s_mult_pippenger_scratch_sizeof", n)
        add("p2s_mult_pippenger_scratch_sizeof", n)
    # fields
    for a in FP_VALS:
        for name in ("fp_sqr", "fp_mul_by_3", "fp_mul_by_8", "fp_inverse",
                     "fp_eucl_inverse", "fp_sqrt", "fp_is_square"):
            add(name, a)
        add("fp_cneg", a, True)
        add("fp_cneg", a, False)
        add("fp_lshift", a, 7)
        for b in FP_VALS[:3]:
            for name in ("fp_add", "fp_sub", "fp_mul"):
                add(name, a, b)
    add("fp_sqrt", FP_NONRES)
    add("fp_is_square", FP_NONRES)
    for a in FP2_VALS:
        for name in ("fp2_sqr", "fp2_mul_by_3", "fp2_mul_by_8",
                     "fp2_inverse", "fp2_eucl_inverse", "fp2_sqrt",
                     "fp2_is_square"):
            add(name, a)
        add("fp2_cneg", a, True)
        add("fp2_cneg", a, False)
        add("fp2_lshift", a, 3)
        for b in FP2_VALS[:3]:
            for name in ("fp2_add", "fp2_sub", "fp2_mul"):
                add(name, a, b)
    for a in FR_VALS:
        for name in ("fr_sqr", "fr_mul_by_3", "fr_inverse",
                     "fr_eucl_inverse"):
            add(name, a)
        add("fr_cneg", a, True)
        add("fr_lshift", a, 9)
        for k in (0, 1, 5, 255):
            add("fr_rshift", a, k)
        for b in FR_VALS[:3]:
            for name in ("fr_add", "fr_sub", "fr_mul"):
                add(name, a, b)
    # exports
    for x in SCALARS + [(1 << 256) - 1]:
        for name in ("bendian_from_scalar", "lendian_from_scalar",
                     "scalar_fr_check", "sk_check", "fr_from_scalar"):
            add(name, x)
        for name in ("scalar_from_bendian", "scalar_from_lendian"):
            add(name, (x % (1 << 256)).to_bytes(32, "big"))
        add("scalar_from_hex", hex(x))
        add("scalar_from_uint32", [(x >> (32 * i)) & 0xFFFFFFFF
                                   for i in range(8)])
        add("scalar_from_uint64", [(x >> (64 * i)) & (2 ** 64 - 1)
                                   for i in range(4)])
    for x in FP_VALS:
        add("bendian_from_fp", x)
        add("lendian_from_fp", x)
        add("fp_from_bendian", x.to_bytes(48, "big"))
        add("fp_from_lendian", x.to_bytes(48, "little"))
        add("fp_from_uint32", [(x >> (32 * i)) & 0xFFFFFFFF
                               for i in range(12)])
        add("fp_from_uint64", [(x >> (64 * i)) & (2 ** 64 - 1)
                               for i in range(6)])
    add("fp_from_uint32", [0xFFFFFFFF] * 12)
    # hash to curve and keys
    for msg in (b"", b"abc", bytes(range(100))):
        for name in ("hash_to_g1", "hash_to_g2", "encode_to_g1",
                     "encode_to_g2"):
            add(name, msg)
        add("hash_to_g1", msg, b"OTHER-DST", b"aug")
        add("keygen", msg + bytes(32))
        add("keygen_v3", msg + bytes(32), b"info")
        add("derive_master_eip2333", msg + bytes(32))
    for u in (0, 1, P - 1, _rand(P)):
        add("map_to_g1", u)
        add("map_to_g1", u, 5)
    for u in ((0, 0), (1, 2), (_rand(P), _rand(P))):
        add("map_to_g2", u)
    add("map_to_g2", (3, 4), (5, 6))
    for sk in (1, _rand(R_ORDER)):
        add("derive_child_eip2333", sk, 0)
        add("derive_child_eip2333", sk, 2 ** 32 - 1)
        add("sk_to_pk_in_g1", sk)
        add("sk_to_pk_in_g2", sk)
    add("aggregate_in_g1", A1)
    add("aggregate_in_g2", A2)
    add("aggregate_in_g1", [])
    # fp12
    vals = [_rand(P) for _ in range(12)]
    vals2 = [_rand(P) for _ in range(12)]
    c.append(("fp12_one", lambda pkg: ()))
    for name in ("fp12_sqr", "fp12_cyclotomic_sqr", "fp12_inverse",
                 "fp12_conjugate", "fp12_is_one", "fp12_in_group"):
        c.append((name, lambda pkg: (_fp12(pkg, vals),)))
    for n in (1, 2, 3, 6):
        c.append(("fp12_frobenius_map", lambda pkg, n=n: (_fp12(pkg, vals),
                                                          n)))
    for name in ("fp12_mul", "fp12_is_equal"):
        c.append((name, lambda pkg: (_fp12(pkg, vals), _fp12(pkg, vals2))))
    c.append(("fp12_is_equal", lambda pkg: (_fp12(pkg, vals),
                                            _fp12(pkg, vals))))
    c.append(("fp12_is_one", lambda pkg: (_fp12(pkg, [1] + [0] * 11),)))
    c.append(("fp12_in_group", lambda pkg: (_fp12(pkg, [0] * 12),)))
    c.append(("fp12_in_group", lambda pkg: (_gt(pkg),)))
    c.append(("miller_loop", lambda pkg: (A2[1], A1[1])))
    c.append(("final_exp", lambda pkg: (_miller(pkg),)))
    c.append(("fp12_finalverify", lambda pkg: (_miller(pkg), _miller(pkg))))
    c.append(("fp12_finalverify", lambda pkg: (_miller(pkg),
                                               _fp12(pkg, vals))))
    return c


@functools.lru_cache(maxsize=None)
def _miller(pkg):
    return API[pkg].miller_loop(A2[1], A1[1])


@functools.lru_cache(maxsize=None)
def _gt(pkg):
    return API[pkg].final_exp(_miller(pkg))


CASES = _cases()


def _ids():
    seen = {}
    for name, _ in CASES:
        seen[name] = seen.get(name, -1) + 1
        yield f"{name}-{seen[name]}"


# The JAX facade's hash and encode entries hand h2c's affine int tuples to
# G1_REF/G2_REF.from_affine, which wants field elements: they raise
# AttributeError. The port's lift the ints; they are held to JAX's h2c.
JAX_H2C_FAULT = {"hash_to_g1", "hash_to_g2", "encode_to_g1", "encode_to_g2"}


@pytest.mark.parametrize("case", CASES, ids=list(_ids()))
def test_host_entry_matches_jax(case):
    name, args = case
    assert name not in DEVICE_ENTRIES
    got = getattr(T, name)(*args(PKGS[1]))
    if name in JAX_H2C_FAULT:
        with pytest.raises(AttributeError):
            getattr(J, name)(*args(PKGS[0]))
        msg, dst, aug = (args(PKGS[0]) + (None, b""))[:3]
        fn = getattr(J.h2c, name)
        want = fn(aug + msg, dst) if dst is not None else fn(msg)
        to_affine = T.p1_to_affine if name.endswith("g1") else T.p2_to_affine
        assert _norm(to_affine(got)) == _norm(want)
        return
    want = getattr(J, name)(*args(PKGS[0]))
    assert _norm(got) == _norm(want)


def test_host_cases_cover_every_host_entry():
    """Every function of JAX's __all__ but the card's entries, the engine
    re-exports and the scalar conversion (tests/test_torch_api_msm.py) is
    driven above."""
    driven = {name for name, _ in CASES} | {"sign_pk_in_g1", "sign_pk_in_g2",
                                            "core_verify_pk_in_g1",
                                            "core_verify_pk_in_g2"}
    host = {n for n in J.__all__ if inspect.isfunction(getattr(J, n))}
    rest = host - DEVICE_ENTRIES - ENGINE - {
        "p1_construct_nh_scalars_nh_points",
        "p2_construct_nh_scalars_nh_points"}
    assert rest - driven == set()


@pytest.mark.parametrize("g", ["g1", "g2"])
def test_aggregate_rejects_a_point_outside_the_group(g):
    pt = _outside_g1() if g == "g1" else _outside_g2()
    for api in (J, T):
        with pytest.raises(ValueError, match="not in"):
            getattr(api, f"aggregate_in_{g}")([pt])


@pytest.mark.parametrize("variant", ["pk_in_g1", "pk_in_g2"])
def test_keygen_sign_verify_round_trip(variant):
    """keygen -> sk_to_pk -> hash -> sign -> core_verify, every step equal
    to JAX's. JAX's facade hash and core_verify raise (JAX_H2C_FAULT,
    test_jax_core_verify_fault), so its side takes JAX's h2c point and
    its signatures module's verify (the hash, int tuples in). The port's
    signature verifies, and not for another message; a signature over the
    encoding (hash_or_encode False) verifies as that only."""
    from msm_blst_tpu.protocol import signatures as jsig

    msg, dst = b"facade round trip", b"BLS_SIG_TEST_DST_"
    g_pk, g_sig = ("g1", "g2") if variant == "pk_in_g1" else ("g2", "g1")
    lift = T.p2_from_affine if g_sig == "g2" else T.p1_from_affine
    to_aff = T.p2_to_affine if g_sig == "g2" else T.p1_to_affine
    scheme = jsig.MinPk if variant == "pk_in_g1" else jsig.MinSig
    out = {}
    for pkg, api in API.items():
        sk = api.keygen(b"\x07" * 32)
        pk = getattr(api, f"sk_to_pk_in_{g_pk}")(sk)
        h = lift(getattr(api.h2c, f"hash_to_{g_sig}")(msg, dst))
        sig = getattr(api, f"sign_{variant}")(h, sk)
        sig_aff = to_aff(sig)
        if pkg == PKGS[0]:
            ok = scheme.verify(pk, sig_aff, msg, dst)
        else:
            assert h == getattr(api, f"hash_to_{g_sig}")(msg, dst)
            verify = getattr(api, f"core_verify_{variant}")
            ok = verify(pk, sig_aff, True, msg, dst)
            assert not verify(pk, sig_aff, True, msg + b"!", dst)
            assert verify(pk, sig_aff, True, b"!", dst, aug=msg) is False
            enc = getattr(api, f"encode_to_{g_sig}")(msg, dst)
            sig_enc = to_aff(getattr(api, f"sign_{variant}")(enc, sk))
            assert verify(pk, sig_enc, False, msg, dst)
            assert not verify(pk, sig_enc, True, msg, dst)
        assert ok
        out[pkg] = (sk, pk, h, sig, ok)
    assert _norm(out[PKGS[0]]) == _norm(out[PKGS[1]])


@pytest.mark.parametrize("variant", ["pk_in_g1", "pk_in_g2"])
def test_core_verify_rejects(variant):
    """A pk at infinity, a pk off the curve and a signature outside its
    group are refused before any pairing."""
    g = T.p1_affine_generator() if variant == "pk_in_g1" else \
        T.p2_affine_generator()
    sig = T.p2_affine_generator() if variant == "pk_in_g1" else \
        T.p1_affine_generator()
    inf = (0, 0) if variant == "pk_in_g1" else ((0, 0), (0, 0))
    off = (1, 1) if variant == "pk_in_g1" else ((1, 0), (1, 0))
    outside = _outside_g2() if variant == "pk_in_g1" else _outside_g1()
    verify = getattr(T, f"core_verify_{variant}")
    assert not verify(inf, sig, True, b"m", b"D")
    assert not verify(off, sig, True, b"m", b"D")
    assert not verify(g, outside, True, b"m", b"D")


@pytest.mark.parametrize("variant", ["pk_in_g1", "pk_in_g2"])
def test_jax_core_verify_fault(variant):
    """The JAX facade's core_verify passes a `hash_or_encode` keyword that
    its signatures module's verify does not take."""
    pk = T.p1_affine_generator() if variant == "pk_in_g1" else \
        T.p2_affine_generator()
    sig = T.p2_affine_generator() if variant == "pk_in_g1" else \
        T.p1_affine_generator()
    with pytest.raises(TypeError, match="hash_or_encode"):
        getattr(J, f"core_verify_{variant}")(pk, sig, True, b"m", b"D")
