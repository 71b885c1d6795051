"""blst-compatible API facade of the port (port of msm_blst_tpu/api.py).

Every public entry point of the reference's C API surface (bindings/blst.h;
the CHES additions at :249-358) has a same-named function here (minus the
`blst_` prefix), with the JAX package's names, signatures and `__all__`:

* single-point / single-element ops run on the host (the pure-Python
  refimpl classes: the honest analog of the reference's single-element C
  calls),
* batch ops (`p1s_*` / `p2s_*`, the stock, wbits, CHES and BGMW95 MSMs) run
  on the card through the port's engine (msm/engine.py, curves/mult.py);
  each takes a keyword-only `device`, the card when None (it raises
  without one; the CPU tests pass device="cpu"),
* codecs route to curves/serialize.py and utils/exports.py,
* protocol ops route to protocol/ (hash-to-curve, keygen, pairing, BLS).

Conventions (host side): G1 affine points are `(x, y)` int pairs, G2 affine
points are `((x0, x1), (y0, y1))`; Jacobian points are the same with a
third coordinate; infinity is the all-zero tuple (affine) or Z = 0
(Jacobian), as in the reference (src/e1.c, src/e2.c). Scalars and field
elements are canonical Python ints; scalars are reduced mod r.

The CHES and BGMW95 entries keep their plan in a memo keyed by the VALUE of
the point list: a SHA-256 of every coordinate of every point, taken on
every call, so a list changed in place at any position gets a plan of its
own points (the JAX facade revalidates a repeat call at 16 probe positions
only, and misses a change elsewhere).
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence, Tuple

import numpy as np

from .constants import P, R_ORDER
from .curves import G1, G2, serialize
from .curves.mult import msm_wbits, point_mult_ints, points_add
from .curves.ops import AffinePoint
from .device import resolve as _resolve
from .msm import build_plan, engine, params, recode
# protocol/__init__ re-exports functions named `keygen` and `pairing` that
# shadow the same-named SUBMODULES as package attributes, so the submodules
# are imported by their dotted path.
from .protocol import glv, hash_to_curve as h2c
import importlib as _importlib

kg = _importlib.import_module(__package__ + ".protocol.keygen")
pr = _importlib.import_module(__package__ + ".protocol.pairing")
from .protocol.tower import Fp12 as _Fp12T, Fp6 as _Fp6T  # noqa: E402
from .refimpl import G1_REF, G2_REF  # noqa: E402
from .refimpl.field import Fp as _Fp, Fp2 as _Fp2  # noqa: E402
from .utils import exports as ex  # noqa: E402


# ---------------------------------------------------------------------------
# host <-> refimpl coercions
# ---------------------------------------------------------------------------


def _a1(pt):  # (x, y) ints -> refimpl G1 affine
    return (_Fp(pt[0]), _Fp(pt[1]))


def _a1i(pt) -> Tuple[int, int]:
    return (pt[0].v, pt[1].v)


def _a2(pt):
    (x0, x1), (y0, y1) = pt
    return (_Fp2(_Fp(x0), _Fp(x1)), _Fp2(_Fp(y0), _Fp(y1)))


def _a2i(pt):
    x, y = pt
    return ((x.c0.v, x.c1.v), (y.c0.v, y.c1.v))


def _j1(pt):  # (x, y, z) ints -> refimpl Jacobian
    from .refimpl.curve import JacobianPoint

    return JacobianPoint(_Fp(pt[0]), _Fp(pt[1]), _Fp(pt[2]))


def _j1i(p) -> Tuple[int, int, int]:
    return (p.X.v, p.Y.v, p.Z.v)


def _j2(pt):
    from .refimpl.curve import JacobianPoint

    (x0, x1), (y0, y1), (z0, z1) = pt
    return JacobianPoint(
        _Fp2(_Fp(x0), _Fp(x1)), _Fp2(_Fp(y0), _Fp(y1)), _Fp2(_Fp(z0), _Fp(z1))
    )


def _j2i(p):
    return (
        (p.X.c0.v, p.X.c1.v),
        (p.Y.c0.v, p.Y.c1.v),
        (p.Z.c0.v, p.Z.c1.v),
    )


def _device_affine(curve, pts, device) -> AffinePoint:
    """Host affine points of `curve` -> a Montgomery AffinePoint batch on
    `device` (the host conversion a first call pays; chip_smoke times it
    by this name)."""
    return curve.affine_from_ints(pts, device=device)


def _scalars_device(scalars: Sequence[int], device):
    """Host int scalars, reduced mod r, as int32[8, n] words on `device`."""
    return recode.to_device(
        recode.scalars_from_ints([s % R_ORDER for s in scalars]), device)


def _jac_ints(curve, jac):
    """The first lane of a Jacobian batch as host ints (G1: (x, y, z); G2:
    pairs), out of the Montgomery domain."""
    F = curve.F
    to = F.to_ints if curve.name == "G1" else F.to_int_pairs
    return (to(jac.X)[0], to(jac.Y)[0], to(jac.Z)[0])


# ---------------------------------------------------------------------------
# generators / single-point arithmetic (blst_p1_* / blst_p2_*)
# ---------------------------------------------------------------------------


def p1_generator():
    """blst_p1_generator (src/e1.c:20-33): Jacobian generator."""
    return _j1i(G1_REF.generator_jac())


def p2_generator():
    return _j2i(G2_REF.generator_jac())


def p1_affine_generator():
    return _a1i(G1_REF.gen_affine)


def p2_affine_generator():
    return _a2i(G2_REF.gen_affine)


def p1_add_or_double(a, b):
    """blst_p1_add_or_double (unified Jacobian add, src/ec_ops.h:40-100)."""
    return _j1i(G1_REF.jac_add(_j1(a), _j1(b)))


def p2_add_or_double(a, b):
    return _j2i(G2_REF.jac_add(_j2(a), _j2(b)))


def p1_add(a, b):
    return p1_add_or_double(a, b)


def p2_add(a, b):
    return p2_add_or_double(a, b)


def p1_add_or_double_affine(a, b_affine):
    return _j1i(G1_REF.jac_add(_j1(a), G1_REF.from_affine(_a1(b_affine))))


def p2_add_or_double_affine(a, b_affine):
    return _j2i(G2_REF.jac_add(_j2(a), G2_REF.from_affine(_a2(b_affine))))


def p1_add_affine(a, b_affine):
    return p1_add_or_double_affine(a, b_affine)


def p2_add_affine(a, b_affine):
    return p2_add_or_double_affine(a, b_affine)


def p1_double(a):
    """blst_p1_double (src/ec_ops.h:299-327)."""
    return _j1i(G1_REF.jac_double(_j1(a)))


def p2_double(a):
    return _j2i(G2_REF.jac_double(_j2(a)))


def p1_cneg(a, flag: bool):
    x, y, z = a
    return (x, (-y) % P if flag else y, z)


def p2_cneg(a, flag: bool):
    x, (y0, y1), z = a
    return (x, ((-y0) % P, (-y1) % P) if flag else (y0, y1), z)


def p1_mult(a, scalar: int):
    """blst_p1_mult — GLV-accelerated single mult (src/e1.c:396-442)."""
    aff = p1_to_affine(a)
    if aff == (0, 0):
        return (0, 0, 0)
    out = glv.mult_glv_g1(scalar % R_ORDER, _a1(aff))
    return _j1i(G1_REF.from_affine(out)) if out is not None else (0, 0, 0)


def p2_mult(a, scalar: int):
    """blst_p2_mult — GLS 4-dim (src/e2.c:455-516)."""
    aff = p2_to_affine(a)
    if aff == ((0, 0), (0, 0)):
        return ((0, 0), (0, 0), (0, 0))
    out = glv.mult_gls_g2(scalar % R_ORDER, _a2(aff))
    return (
        _j2i(G2_REF.from_affine(out))
        if out is not None
        else ((0, 0), (0, 0), (0, 0))
    )


def p1_to_affine(a):
    return _a1i(G1_REF.to_affine(_j1(a)))


def p2_to_affine(a):
    return _a2i(G2_REF.to_affine(_j2(a)))


def p1_from_affine(a):
    return _j1i(G1_REF.from_affine(_a1(a)))


def p2_from_affine(a):
    return _j2i(G2_REF.from_affine(_a2(a)))


def p1_to_xyzz(a):
    """blst_p1_to_xyzz (src/ec_ops.h:779-785): (X, Y, ZZ, ZZZ) ints."""
    x, y, z = a
    zz = (z * z) % P
    return (x, y, zz, (zz * z) % P)


def p1_is_equal(a, b) -> bool:
    return p1_to_affine(a) == p1_to_affine(b)


def p2_is_equal(a, b) -> bool:
    return p2_to_affine(a) == p2_to_affine(b)


def p1_is_inf(a) -> bool:
    return a[2] == 0


def p2_is_inf(a) -> bool:
    return tuple(a[2]) == (0, 0)


def p1_affine_is_inf(a) -> bool:
    return tuple(a) == (0, 0)


def p2_affine_is_inf(a) -> bool:
    return tuple(map(tuple, a)) == ((0, 0), (0, 0))


def p1_affine_is_equal(a, b) -> bool:
    return tuple(a) == tuple(b)


def p2_affine_is_equal(a, b) -> bool:
    return tuple(map(tuple, a)) == tuple(map(tuple, b))


def p1_on_curve(a) -> bool:
    return p1_affine_on_curve(p1_to_affine(a))


def p2_on_curve(a) -> bool:
    return p2_affine_on_curve(p2_to_affine(a))


def p1_affine_on_curve(a) -> bool:
    """y^2 = x^3 + 4 (src/e1.c:101-138); infinity counts as on-curve."""
    return p1_affine_is_inf(a) or G1_REF.is_on_curve(_a1(a))


def p2_affine_on_curve(a) -> bool:
    return p2_affine_is_inf(a) or G2_REF.is_on_curve(_a2(a))


def p1_in_g1(a) -> bool:
    """blst_p1_in_g1 — subgroup check via the GLV endomorphism."""
    return p1_affine_in_g1(p1_to_affine(a))


def p2_in_g2(a) -> bool:
    return p2_affine_in_g2(p2_to_affine(a))


def p1_affine_in_g1(a) -> bool:
    return p1_affine_is_inf(a) or (
        p1_affine_on_curve(a) and glv.in_g1(_a1(a))
    )


def p2_affine_in_g2(a) -> bool:
    return p2_affine_is_inf(a) or (
        p2_affine_on_curve(a) and glv.in_g2(_a2(a))
    )


# ---------------------------------------------------------------------------
# serialization (blst_p1_serialize family; src/e1.c:139-359, src/e2.c:176-419)
# ---------------------------------------------------------------------------


def p1_serialize(a) -> bytes:
    return serialize.g1_serialize(p1_to_affine(a))


def p1_compress(a) -> bytes:
    return serialize.g1_compress(p1_to_affine(a))


def p1_affine_serialize(a) -> bytes:
    return serialize.g1_serialize(tuple(a))


def p1_affine_compress(a) -> bytes:
    return serialize.g1_compress(tuple(a))


def p1_deserialize(b: bytes):
    return serialize.g1_deserialize(b)


def p1_uncompress(b: bytes):
    return serialize.g1_uncompress(b)


def p2_serialize(a) -> bytes:
    return serialize.g2_serialize(p2_to_affine(a))


def p2_compress(a) -> bytes:
    return serialize.g2_compress(p2_to_affine(a))


def p2_affine_serialize(a) -> bytes:
    return serialize.g2_serialize(tuple(a))


def p2_affine_compress(a) -> bytes:
    return serialize.g2_compress(tuple(a))


def p2_deserialize(b: bytes):
    return serialize.g2_deserialize(b)


def p2_uncompress(b: bytes):
    return serialize.g2_uncompress(b)


# ---------------------------------------------------------------------------
# batch point ops (blst_p1s_* — the card's surface)
# ---------------------------------------------------------------------------


def _to_affine_batch(curve, points_jac, device) -> list:
    from .curves.ops import JacPoint

    dev = _resolve(device)
    F = curve.F
    if curve.name == "G1":
        coords = [F.from_ints([p[k] for p in points_jac], device=dev)
                  for k in range(3)]
    else:
        coords = [F.from_int_pairs([tuple(p[k]) for p in points_jac],
                                   device=dev) for k in range(3)]
    return curve.affine_to_ints(curve.jac_to_affine(JacPoint(*coords)))


def p1s_to_affine(points_jac: Sequence, *, device=None) -> list:
    """blst_p1s_to_affine (multi_scalar.c:17-62): one batch inversion on
    the card (K1); Z = 0 lanes give (0, 0)."""
    return _to_affine_batch(G1, points_jac, device)


def p2s_to_affine(points_jac: Sequence, *, device=None) -> list:
    return _to_affine_batch(G2, points_jac, device)


def p1s_add(points_affine: Sequence, *,
            device=None) -> Tuple[int, int, int]:
    """blst_p1s_add (bulk_addition.c:51-168): sum of affine points, a lane
    tree of K2 adds."""
    out = points_add(G1, _device_affine(G1, points_affine, _resolve(device)))
    return _jac_ints(G1, out)


def p2s_add(points_affine: Sequence, *, device=None):
    out = points_add(G2, _device_affine(G2, points_affine, _resolve(device)))
    return _jac_ints(G2, out)


def _stock_cfg(n: int) -> params.MsmConfig:
    """Placeholder config for the stock path (it derives its own window from
    n and nbits; no CHES/BGMW parameters are consulted)."""
    return params.make_config(max(n.bit_length() - 1, 1), c=13, h=20)


def _stock_run(curve, points_affine, scalars, window, nbits, device):
    """Stock Pippenger on a plan holding only the points' rows (no tables
    are built)."""
    dev = _resolve(device)
    pts = _device_affine(curve, points_affine, dev)
    plan = engine.MsmPlan(curve, _stock_cfg(len(points_affine)),
                          points_rows=curve.to_rows32(pts))
    out = engine.msm_stock_pippenger(plan, _scalars_device(scalars, dev),
                                     window=window, nbits=nbits)
    return _jac_ints(curve, out)


def p1s_mult_pippenger(points_affine: Sequence, scalars: Sequence[int],
                       nbits: int = 255, *, device=None):
    """blst_p1s_mult_pippenger (multi_scalar.c:549-576): stock Pippenger."""
    return _stock_run(G1, points_affine, scalars, None, nbits, device)


def p2s_mult_pippenger(points_affine: Sequence, scalars: Sequence[int],
                       nbits: int = 255, *, device=None):
    return _stock_run(G2, points_affine, scalars, None, nbits, device)


def p1s_tile_pippenger(points_affine: Sequence, scalars: Sequence[int],
                       window: Optional[int] = None, *, device=None):
    """blst_p1s_tile_pippenger (multi_scalar.c:383-419) — one windowed tile;
    exposed as the full windowed MSM with an explicit window, matching the
    Rust bindings' per-tile use (lib.rs:1876-1917)."""
    return _stock_run(G1, points_affine, scalars, window, 255, device)


def p1s_mult_wbits_precompute(points_affine: Sequence, wbits: int, *,
                              device=None):
    """blst_p1s_mult_wbits_precompute (multi_scalar.c:81-130): per-point
    multiples table, on the card."""
    from .curves.mult import _multiples_table

    return _multiples_table(
        G1, _device_affine(G1, points_affine, _resolve(device)),
        1 << (wbits - 1))


def p1s_mult_wbits(precomputed, scalars: Sequence[int], wbits: int,
                   npoints: Optional[int] = None, *, device=None):
    """blst_p1s_mult_wbits (multi_scalar.c:132-261): 2-step MSM over a table
    from p1s_mult_wbits_precompute."""
    out = msm_wbits(G1, _scalars_device(scalars, _resolve(device)), None,
                    w=wbits, table=precomputed)
    return _jac_ints(G1, out)


def p1s_mult_wbits_precompute_sizeof(wbits: int, npoints: int) -> int:
    """Table footprint in bytes (affine G1 = 96 B canonical)."""
    return 96 * npoints << (wbits - 1)


def p2s_tile_pippenger(points_affine: Sequence, scalars: Sequence[int],
                       window: Optional[int] = None, *, device=None):
    """blst_p2s_tile_pippenger (multi_scalar.c:802-807 G2 instantiation of
    :383-419) — G2 twin of p1s_tile_pippenger."""
    return _stock_run(G2, points_affine, scalars, window, 255, device)


def p2s_mult_wbits_precompute(points_affine: Sequence, wbits: int, *,
                              device=None):
    """blst_p2s_mult_wbits_precompute (multi_scalar.c:232-261 G2
    instantiation): per-point multiples table, on the card."""
    from .curves.mult import _multiples_table

    return _multiples_table(
        G2, _device_affine(G2, points_affine, _resolve(device)),
        1 << (wbits - 1))


def p2s_mult_wbits(precomputed, scalars: Sequence[int], wbits: int,
                   npoints: Optional[int] = None, *, device=None):
    """blst_p2s_mult_wbits: 2-step G2 MSM over a table from
    p2s_mult_wbits_precompute."""
    out = msm_wbits(G2, _scalars_device(scalars, _resolve(device)), None,
                    w=wbits, table=precomputed)
    return _jac_ints(G2, out)


def p2s_mult_wbits_precompute_sizeof(wbits: int, npoints: int) -> int:
    """Table footprint in bytes (affine G2 = 192 B canonical)."""
    return 192 * npoints << (wbits - 1)


# ---------------------------------------------------------------------------
# CHES / BGMW95 fixed-point MSM (bindings/blst.h:249-358 additions)
# ---------------------------------------------------------------------------


_PLAN_CACHE: dict = {}


def _points_digest(points_affine) -> str:
    """SHA-256 of every coordinate of every point of an affine point list
    (G1 (x, y) ints or G2 ((x0, x1), (y0, y1))), each as 48 little-endian
    bytes, in one join. Plans are memoized by this VALUE, never by object
    identity or by a sample of the points: the digest is taken in full on
    every call, so a point changed in place anywhere in the list changes
    it."""
    if points_affine and isinstance(points_affine[0][0], (tuple, list)):
        coords = (c for pt in points_affine for xy in pt for c in xy)
    else:
        coords = (c for pt in points_affine for c in pt)
    raw = b"".join(int(c).to_bytes(48, "little") for c in coords)
    return hashlib.sha256(raw).hexdigest()


def _facade_config(n: int, n_exp_hint=None) -> params.MsmConfig:
    """Config for a facade MSM call: the shipped config when n matches one
    of the 17 parameter sets; otherwise the NEAREST shipped config's radix
    (an off-table n at 2^17 scale gets c=17/20 like its neighbors, not a
    toy c<=13 with a much larger h)."""
    n_exp = max(n.bit_length() - 1, 1)
    cfg = params.CONFIGS.get(n_exp_hint or n_exp)
    if cfg is not None and cfg.n == n:
        return cfg
    near = params.CONFIGS[min(max(n_exp, 8), 21)]
    return params.make_config(n_exp, c=near.c, h=near.h, ah=near.ah,
                              c_bgmw=near.c_bgmw, h_bgmw=near.h_bgmw)


def _ches_plan(curve, points_affine, n_exp_hint=None, *, ches=True,
               bgmw=False, device=None):
    """Fixed-point MSM plan for a facade call on `device`, memoized by the
    point list's value (_points_digest) and the device.

    Only the requested tables are built; a memo hit that lacks the newly
    requested table upgrades the plan in place from its own device points:
    the 3nh table, or the nh table (none when the CHES and BGMW radixes
    match: the BGMW query then reads the 3nh table's m=1 rows). The row
    layout of the plan's first build is kept."""
    from .msm.precompute import (_attach_ches_params, build_bgmw_table,
                                 build_bgmw_table_rows_streamed,
                                 build_ches_table,
                                 build_ches_table_rows_streamed)

    dev = _resolve(device)
    n = len(points_affine)
    key = (curve.name, n, _points_digest(points_affine), str(dev))
    plan = _PLAN_CACHE.get(key)
    need_ches = ches and (plan is None or plan.table3nh is None)
    need_bgmw = bgmw and (plan is None or (plan.table_nh is None
                                           and not plan.bgmw_stride3))
    if need_ches or need_bgmw:
        cfg = _facade_config(n, n_exp_hint)
        if plan is None:
            plan = build_plan(curve, _device_affine(curve, points_affine, dev),
                              cfg, ches=need_ches, bgmw=need_bgmw,
                              stock=False)
        else:
            c, pts = plan.curve, plan.points
            if need_ches:
                plan.table3nh = (
                    build_ches_table_rows_streamed(c, pts, cfg)
                    if plan.layout == "j"
                    else c.to_rows32(build_ches_table(c, pts, cfg)))
                _attach_ches_params(plan, cfg, dev)
            if need_bgmw:
                if (plan.table3nh is not None and cfg.c == cfg.c_bgmw
                        and cfg.h == cfg.h_bgmw):
                    plan.bgmw_stride3 = True  # alias the 3nh table's m=1 rows
                else:
                    plan.table_nh = (
                        build_bgmw_table_rows_streamed(c, pts, cfg)
                        if plan.layout == "j"
                        else c.to_rows32(build_bgmw_table(c, pts, cfg)))
        _PLAN_CACHE[key] = plan
    return plan


def _ches_run(curve, points_affine, scalars, device):
    dev = _resolve(device)
    plan = _ches_plan(curve, points_affine, device=dev)
    out = engine.msm_ches_device(plan, _scalars_device(scalars, dev))
    return _jac_ints(plan.curve, out)


def p1_tile_pippenger_d_CHES(points_affine: Sequence, scalars: Sequence[int],
                             *, device=None):
    """blst_p1_tile_pippenger_d_CHES (multi_scalar.c:643-655 -> :421-463):
    the CHES 'nh + 0.21q' fixed-point MSM, zero doublings, on the memo's
    plan (engine.msm_ches_device). A repeat call on the same points builds
    nothing."""
    return _ches_run(G1, points_affine, scalars, device)


def p2_tile_pippenger_d_CHES(points_affine: Sequence, scalars: Sequence[int],
                             *, device=None):
    return _ches_run(G2, points_affine, scalars, device)


def _bgmw_run(curve, points_affine, scalars, device):
    dev = _resolve(device)
    plan = _ches_plan(curve, points_affine, ches=False, bgmw=True, device=dev)
    out = engine.msm_bgmw_device(plan, _scalars_device(scalars, dev))
    return _jac_ints(plan.curve, out)


def p1_tile_pippenger_BGMW95(points_affine: Sequence, scalars: Sequence[int],
                             *, device=None):
    """blst_p1_tile_pippenger_BGMW95 (multi_scalar.c:778 -> :506-547)."""
    return _bgmw_run(G1, points_affine, scalars, device)


def p2_tile_pippenger_BGMW95(points_affine: Sequence, scalars: Sequence[int],
                             *, device=None):
    return _bgmw_run(G2, points_affine, scalars, device)


def p1_construct_nh_scalars_nh_points(scalars: Sequence[int], cfg=None):
    """blst_p1_construct_nh_scalars_nh_points (multi_scalar.c:748-775):
    the integral scalar conversion — standard q-ary digits to (bucket value,
    sign, point-slot) triples with carry, on the host in the native library
    (recode.ches_recode_host)."""
    n = len(scalars)
    if cfg is None:
        cfg = params.CONFIGS.get(max(n.bit_length() - 1, 1)) or \
            params.make_config(max(n.bit_length() - 1, 1), c=13, h=20)
    sc = recode.scalars_from_ints([s % R_ORDER for s in scalars])
    b, m, s = recode.ches_recode_host(sc, cfg.c, cfg.h, cfg.ah)
    i_idx = np.arange(n, dtype=np.int64)[:, None]
    j_idx = np.arange(cfg.h, dtype=np.int64)[None, :]
    slots = (3 * (i_idx * cfg.h + j_idx) + (m - 1)).astype(np.int32)
    return b, s, slots


def p2_construct_nh_scalars_nh_points(scalars: Sequence[int], cfg=None):
    """blst_p2_construct_nh_scalars_nh_points (multi_scalar.c:795-807 G2
    instantiation of :748-775). The conversion is scalar-side only — the
    digit/slot stream is identical for G1 and G2 (same layout formula
    3*(i*h+j)+m-1, main_p2.cpp mirrors main_p1.cpp mechanically)."""
    return p1_construct_nh_scalars_nh_points(scalars, cfg)


def p1s_mult_pippenger_scratch_sizeof(npoints: int) -> int:
    """Scratch sizing parity (multi_scalar.c:581-585): bytes of the XYZZ
    bucket array the reference would allocate (4 coords x 48 B)."""
    w = engine.pippenger_window_size(npoints)
    return (4 * 48) << (w - 1)


def p2s_mult_pippenger_scratch_sizeof(npoints: int) -> int:
    w = engine.pippenger_window_size(npoints)
    return (4 * 96) << (w - 1)


# ---------------------------------------------------------------------------
# field ops (blst_fp_* / blst_fp2_* / blst_fr_* — canonical ints, host side;
# batch device arithmetic lives in fields/)
# ---------------------------------------------------------------------------


def fp_add(a: int, b: int) -> int:
    return (a + b) % P


def fp_sub(a: int, b: int) -> int:
    return (a - b) % P


def fp_mul(a: int, b: int) -> int:
    return (a * b) % P


def fp_sqr(a: int) -> int:
    return (a * a) % P


def fp_cneg(a: int, flag: bool) -> int:
    return (-a) % P if flag else a % P


def fp_mul_by_3(a: int) -> int:
    return (3 * a) % P


def fp_mul_by_8(a: int) -> int:
    return (8 * a) % P


def fp_lshift(a: int, count: int) -> int:
    return (a << count) % P


def fp_inverse(a: int) -> int:
    """blst_fp_inverse (addition-chain Fermat, src/recip.c); 0 -> 0."""
    return pow(a, P - 2, P) if a % P else 0


fp_eucl_inverse = fp_inverse


def fp_sqrt(a: int) -> Optional[int]:
    """blst_fp_sqrt (src/sqrt.c, 3-mod-4 trick); None if non-residue."""
    r = h2c.sqrt_fp(_Fp(a))
    return r.v if r is not None else None


def fp_is_square(a: int) -> bool:
    return h2c.is_square_fp(_Fp(a))


def _t2(a):
    return _Fp2(_Fp(a[0]), _Fp(a[1]))


def _i2(a: _Fp2):
    return (a.c0.v, a.c1.v)


def fp2_add(a, b):
    return _i2(_t2(a) + _t2(b))


def fp2_sub(a, b):
    return _i2(_t2(a) - _t2(b))


def fp2_mul(a, b):
    return _i2(_t2(a) * _t2(b))


def fp2_sqr(a):
    return _i2(_t2(a).sqr())


def fp2_cneg(a, flag: bool):
    return _i2(-_t2(a)) if flag else (a[0] % P, a[1] % P)


def fp2_mul_by_3(a):
    return _i2(_t2(a).mul_small(3))


def fp2_mul_by_8(a):
    return _i2(_t2(a).mul_small(8))


def fp2_lshift(a, count: int):
    return ((a[0] << count) % P, (a[1] << count) % P)


def fp2_inverse(a):
    return _i2(_t2(a).inv()) if a != (0, 0) else (0, 0)


fp2_eucl_inverse = fp2_inverse


def fp2_sqrt(a):
    r = h2c.sqrt_fp2(_t2(a))
    return _i2(r) if r is not None else None


def fp2_is_square(a) -> bool:
    return h2c.is_square_fp2(_t2(a))


def fr_add(a: int, b: int) -> int:
    return (a + b) % R_ORDER


def fr_sub(a: int, b: int) -> int:
    return (a - b) % R_ORDER


def fr_mul(a: int, b: int) -> int:
    return (a * b) % R_ORDER


def fr_sqr(a: int) -> int:
    return (a * a) % R_ORDER


def fr_cneg(a: int, flag: bool) -> int:
    return (-a) % R_ORDER if flag else a % R_ORDER


def fr_mul_by_3(a: int) -> int:
    return (3 * a) % R_ORDER


def fr_lshift(a: int, count: int) -> int:
    return (a << count) % R_ORDER


def fr_rshift(a: int, count: int) -> int:
    """blst_fr_rshift: division by 2^count mod r (multiply by inverse)."""
    return (a * pow(pow(2, count, R_ORDER), R_ORDER - 2, R_ORDER)) % R_ORDER


def fr_inverse(a: int) -> int:
    return pow(a, R_ORDER - 2, R_ORDER) if a % R_ORDER else 0


fr_eucl_inverse = fr_inverse


# ---------------------------------------------------------------------------
# fp12 (blst_fp12_* — src/fp12_tower.c); elements are tower.Fp12 objects
# ---------------------------------------------------------------------------


fp12 = _Fp12T
fp6 = _Fp6T


def fp12_one():
    return _Fp12T.one()


def fp12_mul(a, b):
    return a * b


def fp12_sqr(a):
    return a.sqr()


def fp12_cyclotomic_sqr(a):
    return a.cyclotomic_sqr()


def fp12_inverse(a):
    return a.inv()


def fp12_conjugate(a):
    return a.conj()


def fp12_frobenius_map(a, n: int = 1):
    return a.frobenius_n(n)


def fp12_is_one(a) -> bool:
    return a.is_one()


def fp12_is_equal(a, b) -> bool:
    return a == b


def fp12_finalverify(gt1, gt2) -> bool:
    """blst_fp12_finalverify: final_exp(gt1) == final_exp(gt2)."""
    return pr.final_exp(gt1) == pr.final_exp(gt2)


def fp12_in_group(a) -> bool:
    """blst_fp12_in_group (src/fp12_tower.c): true GT-subgroup membership.

    Two-step test (Scott, 'A note on group membership tests for G1, G2 and
    GT' — the structure blst's own check uses):
      1. cyclotomic subgroup: a^(p^4 - p^2 + 1) == 1, evaluated without any
         exponentiation as frob^4(a) * a == frob^2(a);
      2. order r: on the cyclotomic subgroup Frobenius is exponentiation by
         p ≡ z (mod r), so a^p == a^z forces ord(a) | gcd(Φ12(p), p - z) = r.
    z = BLS_X < 0, and inverse = conjugate on cyclotomic elements, so
    a^z = conj(a^|z|).
    """
    if a.is_zero():
        return False
    if a.frobenius_n(4) * a != a.frobenius_n(2):
        return False
    return a.frobenius_n(1) == a.pow_int(-pr.BLS_X).conj()


def miller_loop(q_affine, p_affine):
    """blst_miller_loop(PT, Q in G2 affine, P in G1 affine)."""
    return pr.miller_loop(_a1(p_affine), _a2(q_affine))


def final_exp(f):
    return pr.final_exp(f)


# ---------------------------------------------------------------------------
# scalar / codec exports (src/exports.c)
# ---------------------------------------------------------------------------

scalar_from_bendian = ex.scalar_from_bendian
bendian_from_scalar = ex.scalar_to_bendian
scalar_from_lendian = ex.scalar_from_lendian
lendian_from_scalar = ex.scalar_to_lendian
scalar_from_uint32 = ex.scalar_from_uint32
scalar_from_uint64 = ex.scalar_from_uint64
scalar_from_hex = ex.scalar_from_hex
scalar_fr_check = ex.scalar_fr_check
sk_check = ex.sk_check
fr_from_scalar = ex.fr_from_scalar
fp_from_bendian = ex.fp_from_bendian
bendian_from_fp = ex.fp_to_bendian
fp_from_lendian = ex.fp_from_lendian
lendian_from_fp = ex.fp_to_lendian


def fp_from_uint32(words) -> int:
    return sum(int(w) << (32 * i) for i, w in enumerate(words)) % P


def fp_from_uint64(words) -> int:
    return sum(int(w) << (64 * i) for i, w in enumerate(words)) % P


# ---------------------------------------------------------------------------
# protocol (hash-to-curve, keygen, BLS core verify / aggregation)
# ---------------------------------------------------------------------------


# h2c's hash and encode functions return affine int tuples, which the JAX
# facade hands to G1_REF.from_affine as if they were field elements (it
# raises AttributeError); here they are lifted from ints.


def hash_to_g1(msg: bytes, dst: bytes = h2c.DST_G1_RO, aug: bytes = b""):
    return p1_from_affine(h2c.hash_to_g1(aug + msg, dst))


def hash_to_g2(msg: bytes, dst: bytes = h2c.DST_G2_RO, aug: bytes = b""):
    return p2_from_affine(h2c.hash_to_g2(aug + msg, dst))


def encode_to_g1(msg: bytes, dst: bytes = h2c.DST_G1_NU, aug: bytes = b""):
    return p1_from_affine(h2c.encode_to_g1(aug + msg, dst))


def encode_to_g2(msg: bytes, dst: bytes = h2c.DST_G2_NU, aug: bytes = b""):
    return p2_from_affine(h2c.encode_to_g2(aug + msg, dst))


def map_to_g1(u: int, v: Optional[int] = None):
    pts = [h2c.map_to_curve_g1(_Fp(u))]
    if v is not None:
        pts.append(h2c.map_to_curve_g1(_Fp(v)))
    acc = G1_REF.jac_inf()
    for pt in pts:
        acc = G1_REF.jac_add(acc, G1_REF.from_affine(pt))
    return _j1i(G1_REF.from_affine(h2c.clear_cofactor_g1(G1_REF.to_affine(acc))))


def map_to_g2(u, v=None):
    pts = [h2c.map_to_curve_g2(_t2(u))]
    if v is not None:
        pts.append(h2c.map_to_curve_g2(_t2(v)))
    acc = G2_REF.jac_inf()
    for pt in pts:
        acc = G2_REF.jac_add(acc, G2_REF.from_affine(pt))
    return _j2i(G2_REF.from_affine(h2c.clear_cofactor_g2(G2_REF.to_affine(acc))))


keygen = kg.keygen
keygen_v3 = kg.keygen_v3
derive_master_eip2333 = kg.derive_master_eip2333
derive_child_eip2333 = kg.derive_child_eip2333


def sk_to_pk_in_g1(sk: int):
    """min-pk public key (pk in G1)."""
    from .protocol import signatures as sig

    return _a1i(sig.sk_to_pk_g1(sk))


def sk_to_pk_in_g2(sk: int):
    from .protocol import signatures as sig

    return _a2i(sig.sk_to_pk_g2(sk))


def sign_pk_in_g1(hash_pt, sk: int):
    """blst_sign_pk_in_g1: signature = sk * H(m) in G2."""
    return p2_mult(hash_pt, sk)


def sign_pk_in_g2(hash_pt, sk: int):
    return p1_mult(hash_pt, sk)


def _core_verify(pk_affine, sig_affine, pk_in_g1: bool,
                 hash_or_encode: bool, msg: bytes, dst: bytes) -> bool:
    """e(pk, H(msg)) == e(G, sig), with pk and sig group-checked and pk not
    at infinity; H the hash (hash_or_encode) or the encoding to the
    signature's group. The JAX facade passes refimpl points and a
    `hash_or_encode` keyword to signatures.MinPk/MinSig.verify, which take
    int tuples and no such keyword (it raises TypeError)."""
    if pk_in_g1:
        ok = p1_affine_in_g1(pk_affine) and p2_affine_in_g2(sig_affine)
        inf = p1_affine_is_inf(pk_affine)
        to = h2c.hash_to_g2 if hash_or_encode else h2c.encode_to_g2
    else:
        ok = p2_affine_in_g2(pk_affine) and p1_affine_in_g1(sig_affine)
        inf = p2_affine_is_inf(pk_affine)
        to = h2c.hash_to_g1 if hash_or_encode else h2c.encode_to_g1
    if not ok or inf:
        return False
    if pk_in_g1:
        g = G1_REF.gen_affine
        pairs = [((g[0], -g[1]), _a2(sig_affine)),
                 (_a1(pk_affine), _a2(to(msg, dst)))]
    else:
        s = _a1(sig_affine)
        neg = s if p1_affine_is_inf(sig_affine) else (s[0], -s[1])
        pairs = [(neg, G2_REF.gen_affine),
                 (_a1(to(msg, dst)), _a2(pk_affine))]
    return pr.final_exp(pr.miller_loop_n(pairs)).is_one()


def core_verify_pk_in_g1(pk_affine, sig_affine, hash_or_encode: bool,
                         msg: bytes, dst: bytes, aug: bytes = b"") -> bool:
    """blst_core_verify_pk_in_g1 (src/aggregate.c): min-pk verification."""
    return _core_verify(pk_affine, sig_affine, True, hash_or_encode,
                        aug + msg, dst)


def core_verify_pk_in_g2(pk_affine, sig_affine, hash_or_encode: bool,
                         msg: bytes, dst: bytes, aug: bytes = b"") -> bool:
    return _core_verify(pk_affine, sig_affine, False, hash_or_encode,
                        aug + msg, dst)


def aggregate_in_g1(sigs_affine: Sequence):
    """blst_aggregate_in_g1: running aggregate of G1 points (group-checked)."""
    acc = G1_REF.jac_inf()
    for s in sigs_affine:
        if not p1_affine_in_g1(s):
            raise ValueError("point not in G1")
        acc = G1_REF.jac_add(acc, G1_REF.from_affine(_a1(s)))
    return _j1i(acc)


def aggregate_in_g2(sigs_affine: Sequence):
    acc = G2_REF.jac_inf()
    for s in sigs_affine:
        if not p2_affine_in_g2(s):
            raise ValueError("point not in G2")
        acc = G2_REF.jac_add(acc, G2_REF.from_affine(_a2(s)))
    return _j2i(acc)


__all__ = sorted(
    n for n, v in list(globals().items())
    if not n.startswith("_") and callable(v) or n in ("fp12", "fp6")
)
