"""K9's plain twin (msm/scan.py fold_segments_plain) and the integration
it serves, on the CPU.

* fold_segments_plain over contiguous, equal-length and indexed segments
  (empty segments, infinity lanes, P + P, P - P) against JAX msm/scan.py
  fold_xyzz per segment, in affine: exact.
* The twin against a straight loop that spells out the kernel's tiles,
  serial stage, tree and passes one thread and one add at a time, word for
  word: the order the card's word-exact check relies on.
* fold_schedule at the real CHES configs: tiles cover each segment once,
  one wave of tiles a pass.
* engine.integrate_gapped on a plan's gap groups against JAX's, in affine,
  at a config where every gap value up to the largest occurs (a small one:
  JAX's integration graph compiles for about 25 s at 8 buckets).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.constants import P
from msm_blst_tpu.curves import G1 as JG1
from msm_blst_tpu.msm import engine as jengine
from msm_blst_tpu.msm import scan as jscan
from msm_blst_tpu.refimpl import G1_REF
from msm_blst_tpu_torch.convert import fp_from_jax
from msm_blst_tpu_torch.curves import G1, XyzzPoint
from msm_blst_tpu_torch.fields.limb import array_to_ints
from msm_blst_tpu_torch.msm import params, scan
from msm_blst_tpu_torch.msm.engine import MsmPlan, integrate_gapped
from msm_blst_tpu_torch.msm.precompute import _attach_ches_params

torch.set_num_threads(1)
CPU = torch.device("cpu")  # the port's entry points default to the card

N = 400      # stream length
PAIRS = 29   # (k, k+1) equal and (k+2, k+3) opposite for k = 0, 29, ...
INF = 41     # infinity at 5, 46, 87, ...


def _stream(n, seed):
    """n doubled lifts of signed affine points (varied Z): equal and
    opposite neighbours every PAIRS, infinity every INF."""
    rng = random.Random(seed)
    gen = G1_REF.generator_jac()
    base = [G1_REF.to_affine(G1_REF.jac_mult(rng.randrange(1, 1 << 64), gen))
            for _ in range(12)]
    pts = [(x.v, y.v) for x, y in (base[rng.randrange(12)] for _ in range(n))]
    sgn = [rng.randrange(2) for _ in range(n)]
    for k in range(0, n - 3, PAIRS):
        pts[k + 1], sgn[k + 1] = pts[k], sgn[k]
        pts[k + 3], sgn[k + 3] = pts[k + 2], 1 - sgn[k + 2]
    for k in range(5, n, INF):
        pts[k] = (0, 0)
    lifted = JG1.xyzz_from_affine(JG1.affine_from_ints(pts),
                                  negate=jnp.asarray(sgn, dtype=bool))
    return jax.jit(JG1.xyzz_double)(lifted)


def _port(jpt):
    return XyzzPoint(*(fp_from_jax(np.asarray(c), CPU) for c in jpt))


def _affine_ints(pt):
    """xyzz words (port tensors, 12 x B) -> affine ints on the host."""
    r_inv = pow(1 << 384, -1, P)
    X, Y, ZZZ, ZZ = (array_to_ints(c.reshape(12, -1)) for c in pt)
    out = []
    for x, y, zzz, zz in zip(X, Y, ZZZ, ZZ):
        if zz == 0 and zzz == 0:
            out.append((0, 0))
            continue
        zz, zzz = zz * r_inv % P, zzz * r_inv % P
        out.append((x * r_inv * pow(zz, -1, P) % P,
                    y * r_inv * pow(zzz, -1, P) % P))
    return out


# (offsets, index) of each case; the index holds P, P (0, 1), P, -P (2, 3),
# three infinities and repeats
_RNG = np.random.default_rng(7)
CASES = {
    "contiguous": ([0, 0, 1, 2, 40, 40, N], None),
    "equal": (list(range(0, N + 1, 50)), None),
    "indexed": ([0, 2, 4, 4, 7, 307],
                np.concatenate([[0, 1, 2, 3, 5, 46, 87],
                                _RNG.integers(0, N, 300)])),
}
G_MAX, L_MAX = 8, 360  # one JAX compilation for every case


@pytest.fixture(scope="module")
def stream():
    return _stream(N, 1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fold_segments_plain_matches_jax(stream, case):
    offsets, index = CASES[case]
    G = len(offsets) - 1
    pos = np.arange(offsets[-1]) if index is None else index
    # segment g's elements, zero-padded to L_MAX (zero = infinity = identity)
    cols = np.full((G_MAX, L_MAX), -1)
    for g in range(G):
        seg = pos[offsets[g]:offsets[g + 1]]
        cols[g, :len(seg)] = seg
    padded = type(stream)(*(jnp.where(jnp.asarray(cols >= 0), c[:, cols], 0)
                            for c in stream))
    want = jax.jit(lambda p: jscan.fold_xyzz(JG1, p))(padded)
    got = scan.fold_segments_plain(
        G1, _port(stream), offsets,
        None if index is None else torch.as_tensor(index, dtype=torch.int64))
    assert got.X.shape == (12, G)
    want_aff = _affine_ints(_port(type(want)(*(c[:, :G, 0] for c in want))))
    assert _affine_ints(got) == want_aff
    if case == "indexed":  # P + P doubled, P - P and the infinities cancelled
        assert want_aff[0] != (0, 0)
        assert want_aff[1:4] == [(0, 0)] * 3


def _kernel_loop(curve, pts, offsets):
    """K9 one thread and one add at a time: for each pass and tile
    [start, end), thread j starts from element start + j (infinity past
    end) and adds start + j + i*T, i = 1..k-1, while before end; then for
    s = T/2 .. 1, thread j < s adds thread j + s's sum to its own; thread
    0's sum is the tile's partial."""
    T = scan.FOLD_THREADS
    inf = curve.xyzz_inf((1,), CPU)

    def dadd(a, b):
        return curve.xyzz_dadd_body(a, b, F=curve.F.plain)

    def elem(src, i):
        return XyzzPoint(*(c[..., i:i + 1] for c in src))

    src = pts
    for k, tiles in scan.fold_schedule(offsets):
        partials = []
        for start, end in tiles.tolist():
            acc = []
            for j in range(T):
                a = elem(src, start + j) if start + j < end else inf
                for i in range(1, k):
                    if start + j + i * T >= end:
                        break
                    a = dadd(a, elem(src, start + j + i * T))
                acc.append(a)
            s = T // 2
            while s >= 1:
                for j in range(s):
                    acc[j] = dadd(acc[j], acc[j + s])
                s //= 2
            partials.append(acc[0])
        src = XyzzPoint(*(torch.cat(cs, dim=-1) for cs in zip(*partials)))
    return src


def test_fold_order_is_the_kernels(stream, monkeypatch):
    """With a wave of four tiles, 302 elements take k = 2 and two passes,
    with partial tiles and an empty segment; the twin equals the loop word
    for word."""
    monkeypatch.setattr(scan, "FOLD_WAVE", 4)
    scan._fold_tiles.cache_clear()
    try:
        offsets = [0, 300, 302, 302]
        sched = scan.fold_schedule(offsets)
        assert [k for k, _ in sched] == [2, 1] and len(sched[0][1]) == 4
        pts = XyzzPoint(*(c[..., :302] for c in _port(stream)))
        got = scan.fold_segments_plain(G1, pts, offsets)
        want = _kernel_loop(G1, pts, offsets)
    finally:
        scan._fold_tiles.cache_clear()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_log", [14, 16, 21])
def test_fold_schedule_at_the_ches_configs(n_log):
    """The integration's gap groups: every pass's tiles cover each segment
    once, in order, within one wave; the last pass leaves one partial a
    segment; CONFIGS[16] takes k = 4 and two passes."""
    cfg = params.CONFIGS[n_log]
    gaps = np.diff(cfg.bucket_set())
    lengths = np.array([(gaps == g).sum() for g in range(1, cfg.d_max + 1)])
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    sched = scan.fold_schedule(offsets)
    for k, tiles in sched:
        assert len(tiles) <= scan.FOLD_WAVE
        assert (tiles[:, 1] - tiles[:, 0] <= k * scan.FOLD_THREADS).all()
        assert (tiles[1:, 0] == tiles[:-1, 1]).all()  # contiguous, in order
        assert tiles[0, 0] == 0 and tiles[-1, 1] == offsets[-1]
        lengths = np.bincount(np.searchsorted(offsets, tiles[:, 0], "right") - 1,
                              minlength=len(lengths))
        offsets = np.concatenate([[0], np.cumsum(lengths)])
    assert (lengths == 1).all()
    if n_log == 16:
        assert [(k, len(t)) for k, t in sched] == [(4, 216), (1, 6)]


def test_integrate_gapped_matches_jax():
    cfg = params.make_config(6, c=5, h=52)  # |B| = 8, gaps 1..4 all occur
    gaps = np.diff(cfg.bucket_set()).astype(np.int32)
    assert set(gaps.tolist()) == set(range(1, gaps.max() + 1))
    js = _stream(cfg.b_size, 2)
    want = jax.jit(lambda b: jengine.integrate_gapped(JG1, b, gaps))(js)
    plan = MsmPlan(curve=G1, cfg=cfg)
    _attach_ches_params(plan, cfg, CPU)
    assert plan.gap_groups.offsets[-1] == len(gaps)
    got = integrate_gapped(G1, _port(js), plan.gap_groups)
    assert _affine_ints(got) == _affine_ints(_port(want))
