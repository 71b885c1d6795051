"""K2's two launches of the CHES query on the CPU: the plain twins of the
bucket boundaries (curves/cuda_point.py bucket_diffs) and of the Horner
combine (gap_horner), through the port's own callers, which take the twins
for CPU tensors.

* prefix_pipeline.buckets_from_boundaries on a G1 level of c = 7 columns
  over n_ch = 16 lanes against JAX's prefix_pipeline.buckets_from_boundaries
  on the same level (jitted on the CPU, compiled once), in affine,
  and against the integer oracle's bucket sums: a key-sorted stream of 109
  digits over 40 buckets with empty buckets, buckets whose range crosses
  a lane (the level's chunk of c elements), a doubling and a cancellation
  inside a bucket and a bucket that sums to infinity, and empty buckets at
  the end; starting at bucket 0
  ("bucket0") or with the first buckets empty, their right boundary at
  stream position 0 ("empty_head"). The two associate the tails' scan
  otherwise, so their xyzz words differ.
* engine.integrate_gapped against JAX's, in affine: gaps up to d_max = 6
  with no gap of 4 (an absent group), and d_max = 1 (one group, no Horner
  step).
* The same on G2 against the oracle only (JAX's G2 graphs compile for
  minutes on a CPU).
* gap_horner_plain with no group present is infinity, and with one group
  is that group's sum, word for word.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.curves import G1 as JG1
from msm_blst_tpu.curves.ops import AffinePoint as JAffine
from msm_blst_tpu.curves.ops import XyzzPoint as JXyzz
from msm_blst_tpu.msm import engine as jengine
from msm_blst_tpu.msm import prefix_pipeline as jpp
from msm_blst_tpu_torch import refimpl
from msm_blst_tpu_torch.convert import fp_from_jax, fp_to_jax
from msm_blst_tpu_torch.curves import G1, G2, XyzzPoint, cuda_point
from msm_blst_tpu_torch.msm import cuda_scan, prefix_pipeline
from msm_blst_tpu_torch.msm.engine import gap_groups, integrate_gapped

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

C, N_CH = 7, 16  # JAX scans 16 tails in one column walk: a short compile
N_STREAM = 109  # the level holds C * N_CH = 112: pads in the last lane
N_BUCKETS = 40
N_TABLE = 24


def _table(name):
    """(i + 1) G for i < N_TABLE, affine ints."""
    ref = refimpl.CURVES[name]
    pts, acc = [], ref.INF
    for _ in range(N_TABLE):
        acc = ref.add(acc, ref.GENERATOR)
        pts.append(acc)
    return pts


def _stream(head: str):
    """(slots, signs, keys) numpy, key-sorted: runs of 1 to 9 digits a used
    bucket value (every value but most multiples of 3: empty buckets),
    cut to N_STREAM; one run P, P, -P, P (a doubling and a cancellation:
    2P), one run P, -P (infinity)."""
    rng = np.random.default_rng(11)
    used = [k for k in range(N_BUCKETS) if k % 3 or k % 9 == 0]
    used = [k for k in used if k >= 4] if head == "empty_head" else used
    runs = rng.integers(1, 10, len(used))
    runs[5], runs[10] = 4, 2
    keys = np.repeat(used, runs)[:N_STREAM]
    slots = rng.integers(0, N_TABLE, len(keys))
    signs = rng.integers(0, 2, len(keys))
    for i, pattern in ((5, (0, 0, 1, 0)), (10, (0, 1))):
        at = np.nonzero(keys == used[i])[0]
        slots[at], signs[at] = slots[at[0]], pattern
    return slots, signs, keys.astype(np.int32)


def _oracle_buckets(name, table, slots, signs, keys):
    ref = refimpl.CURVES[name]
    out = [ref.INF] * N_BUCKETS
    for s, g, k in zip(slots, signs, keys):
        x, y = table[s]
        out[k] = ref.add(out[k], (x, ref.F.sub(ref.F.zero, y)) if g else (x, y))
    return out


def _affine(curve, pts: XyzzPoint):
    return curve.affine_to_ints(curve.jac_to_affine(curve.xyzz_to_jac(pts)))


def _port_level(curve, table, slots, signs):
    """The K3 level (its plain twin) of the stream at (C, N_CH)."""
    rows = curve.to_rows32(curve.affine_from_ints(table, device=CPU))
    slots_cm, signs_cm = prefix_pipeline.column_major_streams(
        torch.as_tensor(slots, dtype=torch.int32), torch.as_tensor(signs != 0),
        C, N_CH)
    rx, ry = prefix_pipeline.gather_rows(curve, rows, slots_cm, C, N_CH)
    return cuda_scan.affine_prefix_level(curve, rx, ry,
                                         signs_cm.reshape(C, N_CH))


def _port_buckets(curve, local, tails, keys):
    return prefix_pipeline.buckets_from_boundaries(
        curve, local, tails, torch.as_tensor(keys), N_BUCKETS, C, N_CH)


# JAX's boundary differences at the level's shape, compiled once for the
# file
_jax_boundaries = jax.jit(lambda local, tails, keys: jpp.buckets_from_boundaries(
    JG1, local, tails, keys, N_BUCKETS, C, N_CH, "cols"))


def _jax_buckets(local, tails, keys):
    """JAX's buckets_from_boundaries on the port's level (K3's plain twin,
    the words of JAX's local_prefix: tests/test_torch_scan.py), its
    (c, n_ch, 4W) rows moved to JAX's (c, 24, n_ch) limbs a coordinate."""
    W = G1.F.n_words
    cols = JXyzz(*(jnp.asarray(np.moveaxis(
        fp_to_jax(local[..., i * W:(i + 1) * W].permute(2, 0, 1)), 0, 1))
        for i in range(4)))
    jtails = JXyzz(*(jnp.asarray(fp_to_jax(t)) for t in tails))
    out = _jax_boundaries(cols, jtails, jnp.asarray(keys))
    return XyzzPoint(*(fp_from_jax(np.asarray(x), CPU) for x in out))


def _check_stream(slots, signs, keys, head):
    right = np.searchsorted(keys, np.arange(N_BUCKETS), side="right")
    empty = np.diff(np.concatenate([[0], right])) == 0
    lanes = np.maximum(right - 1, 0) // C
    assert empty.sum() > 5
    assert (lanes[1:] > lanes[:-1]).any()  # a bucket crossing a lane
    if head == "empty_head":
        assert (right[:4] == 0).all()
    else:
        assert keys[0] == 0 and right[0] > 0


@pytest.mark.parametrize("head", ["bucket0", "empty_head"])
def test_bucket_boundaries_match_jax_and_the_oracle(head):
    table = _table("G1")
    stream = _stream(head)
    _check_stream(*stream, head)
    want = _oracle_buckets("G1", table, *stream)
    local, tails = _port_level(G1, table, *stream[:2])
    got = _affine(G1, _port_buckets(G1, local, tails, stream[2]))
    assert got == want
    assert got == _affine(G1, _jax_buckets(local, tails, stream[2]))
    used = np.unique(stream[2])
    assert want[used[10]] == refimpl.G1.INF
    assert want[used[5]] == refimpl.G1.add(*[table[stream[0][
        np.nonzero(stream[2] == used[5])[0][0]]]] * 2)


def test_g2_bucket_boundaries_match_the_oracle():
    table = _table("G2")
    stream = _stream("empty_head")
    local, tails = _port_level(G2, table, *stream[:2])
    got = _affine(G2, _port_buckets(G2, local, tails, stream[2]))
    assert got == _oracle_buckets("G2", table, *stream)


# gaps up to 6 with none of 4: group 4 absent; and every gap 1
GAPS = {"d6_absent": np.array([2, 6, 1, 5, 3], dtype=np.int32),
        "d1": np.ones(4, dtype=np.int32)}


def _buckets_ints(name, n, seed):
    """n bucket points as affine ints: random multiples of the generator,
    with infinity at bucket 2 (so one suffix sum repeats the next)."""
    ref = refimpl.CURVES[name]
    rng = random.Random(seed)
    pts = [ref.mult(rng.randrange(1, 1 << 32)) for _ in range(n)]
    pts[2] = ref.INF
    return pts


def _lifted(curve, pts):
    """The points' doubles in xyzz (varied Z) on the CPU."""
    aff = curve.affine_from_ints(pts, device=CPU)
    return cuda_point.xyzz_double_plain(curve, curve.xyzz_from_affine(aff))


def _oracle_integral(name, pts, gaps):
    """sum_j B_j (2 P_j), B_j the sum of the gaps before bucket j."""
    ref = refimpl.CURVES[name]
    weights = np.concatenate([[0], np.cumsum(gaps)])
    acc = ref.INF
    for w, p in zip(weights, pts):
        acc = ref.add(acc, ref.mult(2 * int(w), p))
    return acc


@pytest.mark.parametrize("case", sorted(GAPS))
def test_integrate_gapped_matches_jax_and_the_oracle(case):
    gaps = GAPS[case]
    groups = gap_groups(gaps, CPU)
    present = np.diff(groups.offsets) > 0
    assert len(present) == gaps.max()
    if case == "d6_absent":
        assert not present[3] and present.sum() == 5
    pts = _buckets_ints("G1", len(gaps) + 1, 3)
    b = _lifted(G1, pts)
    got = _affine(G1, integrate_gapped(G1, b, groups))
    jb = JXyzz(*(jnp.asarray(fp_to_jax(x)) for x in b))
    want = jax.jit(lambda b: jengine.integrate_gapped(JG1, b, gaps))(jb)
    assert got == _affine(G1, XyzzPoint(*(fp_from_jax(np.asarray(x), CPU)
                                          for x in want)))
    assert got == [_oracle_integral("G1", pts, gaps)]


@pytest.mark.parametrize("case", sorted(GAPS))
def test_g2_integrate_gapped_matches_the_oracle(case):
    gaps = GAPS[case]
    pts = _buckets_ints("G2", len(gaps) + 1, 4)
    got = integrate_gapped(G2, _lifted(G2, pts), gap_groups(gaps, CPU))
    assert _affine(G2, got) == [_oracle_integral("G2", pts, gaps)]


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_gap_horner_plain_edges(name):
    """No group present: infinity; one group: its sum, word for word."""
    curve = G1 if name == "G1" else G2
    sums = _lifted(curve, _buckets_ints(name, 3, 5))
    none = cuda_point.gap_horner(curve, sums, [False, False, False])
    assert all(not bool(c.any()) for c in none)
    one = cuda_point.gap_horner(curve, XyzzPoint(*(c[..., :1] for c in sums)),
                                [True])
    assert all(torch.equal(a, b[..., :1]) for a, b in zip(one, sums))
