"""The port's CUDA kernels on a card, G1 and G2 instances: each against its
plain version, and the CHES, host-recode CHES, BGMW95 and stock queries
against the oracle; K6 (the SOS multiply) at every stage and the CHES
query on it, and the drivers' K7 and K8 (K8 against torch.take at table
and index sizes, index patterns and unaligned views).
Every test carries the `gpu` marker and takes the `dev` fixture, which
skips it without a CUDA device. On a machine with one:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX, which that machine need
not have; these tests import no JAX.)
"""

import numpy as np
import pytest
import torch

from msm_blst_tpu.constants import P, R_ORDER
from msm_blst_tpu.refimpl import G1_REF, G2_REF

pytestmark = pytest.mark.gpu
CURVES = ("G1", "G2")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _curve(name):
    from msm_blst_tpu_torch import curves

    return getattr(curves, name)


def _ints(x):
    return (x.c0.v, x.c1.v) if hasattr(x, "c0") else x.v


def _oracle(name, total):
    ref = G1_REF if name == "G1" else G2_REF
    x, y = ref.to_affine(ref.jac_mult(total, ref.generator_jac()))
    return _ints(x), _ints(y)


def _points(n, dev, name="G1"):
    ref = G1_REF if name == "G1" else G2_REF
    return _curve(name).affine_from_ints(
        [(_ints(x), _ints(y)) for x, y in ref.fixed_points(n)], device=dev)


def test_mont_mul_kernel_matches_plain(dev):
    from msm_blst_tpu_torch.fields import FP, cuda_mont

    rng = np.random.default_rng(1)
    xs = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(1000)]
    xs[:3] = [0, 1, P - 1]
    a = FP.from_ints(xs, device=dev)
    b = FP.from_ints(xs[::-1], device=dev)
    got = cuda_mont.mont_mul(a, b, FP)
    assert torch.equal(got, cuda_mont.mont_mul_plain(a, b, FP))
    assert torch.equal(got.cpu(), cuda_mont.mont_mul(a.cpu(), b.cpu(), FP))


def _edge_words(curve, p: "XyzzPoint", dev):
    """p with lanes 5.. 12 set to words at p - 1 and 0: X, Y, ZZZ or ZZ of
    p - 1 in turn (lanes 5-8; p - 1 in both components on G2), every
    coordinate p - 1 (lane 9), X and Y 0 with ZZZ and ZZ 1 (lane 10), every
    coordinate 0 but X = p - 1 (lane 11) and Y = p - 1 (lane 12): the
    operands at which the carry-chain product's every carry and borrow
    fire, or none."""
    from msm_blst_tpu_torch.curves import XyzzPoint

    F = curve.F
    pm1 = F.from_ints([P - 1], device=dev) if len(F.lead) == 1 else \
        F.from_int_pairs([(P - 1, P - 1)], device=dev)
    one = F.one_mont((1,), dev)
    cols = [c.clone() for c in p]
    for i in range(4):
        cols[i][..., 5 + i:6 + i] = pm1
    for c in cols:
        c[..., 9:10] = pm1
        c[..., 11:13] = 0
    cols[0][..., 10:11] = 0
    cols[1][..., 10:11] = 0
    cols[2][..., 10:11] = one
    cols[3][..., 10:11] = one
    cols[0][..., 11:12] = pm1
    cols[1][..., 12:13] = pm1
    return XyzzPoint(*cols)


@pytest.mark.parametrize("name", CURVES)
def test_point_kernels_match_plain(dev, name):
    """K2's three formulas on lanes of infinity, P + P, P - P, and words at
    p - 1 and 0 in each operand (the carry-chain product's edges)."""
    from msm_blst_tpu_torch.curves import AffinePoint, cuda_point

    curve = _curve(name)
    B = 64
    pts = _points(B, dev, name)
    lane = torch.arange(B, device=dev)
    base = curve.xyzz_from_affine(pts)
    acc = curve.select(lane == 0, curve.xyzz_inf((B,), dev),
                       curve.xyzz_double(base))
    acc = curve.select((lane == 1) | (lane == 2), base, acc)
    acc = _edge_words(curve, acc, dev)
    signs = lane % 3 == 2
    other = _edge_words(curve, curve.xyzz_from_affine(pts, negate=signs), dev)
    other = type(other)(*(c.roll(3, -1) for c in other))
    edge = _edge_words(curve, curve.xyzz_from_affine(pts), dev)
    pts = AffinePoint(edge.X, edge.Y)
    pairs = [
        (cuda_point.xyzz_dadd_affine(curve, acc, pts, signs),
         cuda_point.xyzz_dadd_affine_plain(curve, acc, pts, signs)),
        (cuda_point.xyzz_dadd(curve, acc, other),
         cuda_point.xyzz_dadd_plain(curve, acc, other)),
        (cuda_point.xyzz_double(curve, acc),
         cuda_point.xyzz_double_plain(curve, acc)),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize("c, n_ch", [(7, 256), (5, 1000), (28, 32768)])
def test_scan_kernels_match_plain(dev, name, c, n_ch):
    """K3 against its plain version word for word: 7 columns of two
    blocks, a ragged shape (1,000 lanes, not a multiple of the block) and
    the CHES level's (28 columns over 32,768 lanes), lane 0 running P, 2P,
    P, infinity."""
    from msm_blst_tpu_torch.msm import cuda_scan

    curve = _curve(name)
    W = curve.F.n_words
    rows = curve.to_rows32(_points(32, dev, name)).XY
    rng = np.random.default_rng(2)
    slots = torch.as_tensor(rng.integers(0, 32, size=c * n_ch), device=dev)
    slots[torch.arange(4, device=dev) * n_ch] = 7
    g = rows.index_select(0, slots)
    rx = g[:, :W].reshape(c, n_ch, W).contiguous()
    ry = g[:, W:].reshape(c, n_ch, W).contiguous()
    sg = torch.as_tensor(rng.integers(0, 2, size=(c, n_ch)), device=dev)
    sg[:2, 0] = 0
    sg[2:4, 0] = 1
    local, tails = cuda_scan.affine_prefix_level(curve, rx, ry, sg)
    wl, wt = cuda_scan.affine_prefix_level_plain(curve, rx, ry, sg)
    assert torch.equal(local, wl)
    assert all(torch.equal(a, b) for a, b in zip(tails, wt))
    assert not bool(local[3, 0, 2 * W:].any())  # P + P - P - P: ZZZ = ZZ = 0


@pytest.mark.parametrize("name", CURVES)
def test_point_kernels_keep_their_blocks(dev, name):
    """K2's wide kernels as built keep the resident blocks an SM their
    launch bounds ask for (csrc/point_ops.cuh MIN_BLOCKS), two or more."""
    from msm_blst_tpu_torch import kernels

    blocks = kernels.occupancy(name, "point_bucket_diffs")
    asked = kernels.point_min_blocks()
    assert asked >= 2
    assert len(blocks) == 4 and min(blocks) >= asked


def _boundary_case(curve, nb, dev):
    """A key-sorted stream of 8 nb digits over nb buckets on a level of 7
    columns: the first four buckets and bucket nb // 2 empty (the first
    four's right boundary at 0), runs that cross lanes and one P, P, -P, P
    run; its level (K3), the tails' scan (K4) and the right boundaries, as
    buckets_from_boundaries forms them."""
    from msm_blst_tpu_torch.msm import cuda_scan, prefix_pipeline, scan

    rng = np.random.default_rng(nb)
    c = 7
    N = max(8 * nb, 40)
    keys = np.sort(rng.integers(min(4, nb - 1), nb, N))
    if nb > 8:  # bucket nb // 2 empty too
        keys = np.where(keys == nb // 2, nb // 2 + 1, keys)
    keys = keys.astype(np.int32)
    slots = rng.integers(0, 32, N)
    signs = rng.integers(0, 2, N)
    slots[30:34], keys[30:34], signs[30:34] = slots[30], keys[30], (0, 0, 1, 0)
    n_ch = -(-N // c)
    rows = curve.to_rows32(_points(32, dev, curve.name))
    slots_cm, signs_cm = prefix_pipeline.column_major_streams(
        torch.as_tensor(slots, dtype=torch.int32, device=dev),
        torch.as_tensor(signs != 0, device=dev), c, n_ch)
    rx, ry = prefix_pipeline.gather_rows(curve, rows, slots_cm, c, n_ch)
    local, tails = cuda_scan.affine_prefix_level(curve, rx, ry,
                                                 signs_cm.reshape(c, n_ch))
    incl = scan.prefix_scan_xyzz(curve, tails)
    right = torch.searchsorted(
        torch.as_tensor(keys, device=dev),
        torch.arange(nb, dtype=torch.int32, device=dev), right=True,
        out_int32=True)
    return right, local, incl, c, n_ch


@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize("nb", [1, 127, 128, 129, 20000, 109244])
def test_bucket_diffs_kernel_matches_plain(dev, name, nb):
    """K2's boundary launch against its plain twin word for word, from one
    bucket to the CHES query's 109,244, across the 127-bucket tiles."""
    from msm_blst_tpu_torch.curves import cuda_point
    from msm_blst_tpu_torch.kernels import CURVE_KERNELS

    curve = _curve(name)
    right, local, incl, c, n_ch = _boundary_case(curve, nb, dev)
    if nb > 4:
        assert (right[:4] == 0).all() and bool((right[1:] == right[:-1]).any())
    kernel = CURVE_KERNELS[name]["point_bucket_diffs"]
    before = kernel.launches
    got = cuda_point.bucket_diffs(curve, right, local, incl, c, n_ch)
    assert kernel.launches == before + 1
    want = cuda_point.bucket_diffs_plain(curve, right, local, incl, c, n_ch)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize("present", [[1], [1, 1], [0, 1], [1, 1, 1, 1, 1, 1],
                                     [1, 1, 1, 0, 1, 1], [0, 0, 1, 0, 0, 1],
                                     [0, 0, 0]])
def test_gap_horner_kernel_matches_plain(dev, name, present):
    """K2's Horner launch against its plain twin word for word at d_max =
    1, 2 and 6, with groups absent, all absent (infinity), and a repeated
    group (a doubling inside a part)."""
    from msm_blst_tpu_torch.curves import XyzzPoint, cuda_point

    curve = _curve(name)
    base = curve.xyzz_double(curve.xyzz_from_affine(_points(8, dev, name)))
    sums = XyzzPoint(*(c[..., :len(present)].clone() for c in base))
    if len(present) == 6:
        for c in sums:  # groups 1 and 3 equal: bit 0's part doubles
            c[..., 2] = c[..., 0]
    flags = [bool(p) for p in present]
    got = cuda_point.gap_horner(curve, sums, flags)
    want = cuda_point.gap_horner_plain(curve, sums, flags)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", CURVES)
def test_level_kernels_fill_the_wave(dev, name):
    """K3 and K4's three kernels as built keep as many blocks resident an
    SM as the wave the host schedules for (msm/scan.py FOLD_WAVE)."""
    from msm_blst_tpu_torch import kernels
    from msm_blst_tpu_torch.msm import scan

    per_sm = scan.FOLD_WAVE // 132
    assert kernels.occupancy(name, "affine_prefix_level")[0] >= per_sm
    assert min(kernels.occupancy(name, "xyzz_prefix_scan")) >= per_sm


@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize("N", [100, 700, 20000])
def test_block_scan_kernel_matches_plain(dev, name, N):
    """K4 against its plain twin word for word: one tile (100: k = 1), six
    tiles (700) and 157 tiles whose carry pass takes two totals a thread
    (20000), over repeats (doublings), a P, -P pair and infinity."""
    from msm_blst_tpu_torch.curves import XyzzPoint
    from msm_blst_tpu_torch.msm import scan

    curve = _curve(name)
    base = curve.xyzz_double(curve.xyzz_from_affine(_points(32, dev, name)))
    rng = np.random.default_rng(8)
    pts = XyzzPoint(*(c[..., torch.as_tensor(rng.integers(0, 32, N),
                                             device=dev)] for c in base))
    for c in pts:
        c[..., 1] = c[..., 0]
        c[..., 3] = c[..., 2]
        c[..., 5::97] = 0
    pts.Y[..., 3] = curve.F.plain.neg(pts.Y[..., 2:3])[..., 0]
    k, n_tiles, k_carry = scan.scan_schedule(N)
    assert (n_tiles > 1, k_carry) == {100: (False, 0), 700: (True, 1),
                                      20000: (True, 2)}[N]
    got = scan.prefix_scan_xyzz(curve, pts)
    want = scan.prefix_scan_xyzz_plain(curve, pts)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _seg_stream(curve, N, n_buckets, seed, dev):
    """A key-sorted signed stream over n_buckets of 32 fixed points' rows:
    a point four times in one run (a doubling), a cancellation, pads."""
    from msm_blst_tpu_torch.curves import PackedRows32

    rng = np.random.default_rng(seed)
    rows = curve.to_rows32(_points(32, dev, curve.name)).XY
    slots = rng.integers(0, 32, N)
    keys = np.sort(rng.integers(0, n_buckets, N))
    signs = rng.integers(0, 2, N)
    slots[10:14] = slots[10]
    keys[10:14] = keys[10]
    signs[12] = 1 - signs[11]
    keys[-5:] = n_buckets
    return (PackedRows32(rows[torch.as_tensor(slots, device=dev)]),
            torch.as_tensor(signs, device=dev),
            torch.as_tensor(keys, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("name", CURVES)
def test_seg_kernels_match_plain(dev, name):
    """K5's affine level and segmented scan on sorted duplicate-heavy keys
    with a doubling, a cancellation and pads, at the port's level shapes:
    the level's stream, its keys and the bucket array it updates in place,
    then the bucket array after the scan, equal the plain versions'; the
    scan's stream takes one tile (700 elements), 24 (3,000), and 196 with
    a carry pass of two totals a thread (50,000: 25,000 heads and
    tails)."""
    from msm_blst_tpu_torch.curves import XyzzPoint
    from msm_blst_tpu_torch.msm import cuda_scan, scan

    curve = _curve(name)
    for N, n_buckets, tiles in ((700, 40, 1), (3000, 300, 24),
                                (50000, 2000, 196)):
        pts, sg, ky = _seg_stream(curve, N, n_buckets, N, dev)
        cols, scols, kcols = cuda_scan.level_cols(curve, pts, sg, ky, n_buckets)
        levels = []
        for fn in (cuda_scan.seg_level, cuda_scan.seg_level_plain):
            buckets = cuda_scan.bucket_array(curve, n_buckets, dev)
            out, out_key = fn(curve, cols, scols, kcols, buckets, n_buckets)
            levels.append((out, out_key, buckets))
        (out, out_key, b1), (out2, key2, b2) = levels
        assert all(torch.equal(a, b) for a, b in zip(out, out2))
        assert torch.equal(out_key, key2)
        assert all(torch.equal(a, b) for a, b in zip(b1, b2))
        assert scan.scan_schedule(out_key.shape[0]).n_tiles == tiles
        sums = []
        for fn in (cuda_scan.seg_scan, cuda_scan.seg_scan_plain):
            buckets = XyzzPoint(*(c.clone() for c in b1))
            fn(curve, out, out_key, buckets, n_buckets)
            sums.append(buckets)
        assert all(torch.equal(a, b) for a, b in zip(*sums))
        assert bool((sums[0].ZZ != 0).any())  # some run reached a bucket


@pytest.mark.parametrize("name", CURVES)
def test_seg_scan_kernel_at_the_bgmw_shape(dev, name):
    """K5 at BGMW's level shape at n = 2^16 (983,040 digits over 65,537
    buckets: 30 columns over 32,768 lanes, then a scan of 65,536 heads and
    tails in 256 tiles of two elements a thread, two totals a thread in
    its carry pass), one launch of each, equal to the plain versions."""
    from msm_blst_tpu_torch import kernels
    from msm_blst_tpu_torch.curves import XyzzPoint
    from msm_blst_tpu_torch.msm import cuda_scan, scan

    curve = _curve(name)
    N, n_buckets = 983040, 65537
    pts, sg, ky = _seg_stream(curve, N, n_buckets, 9, dev)
    cols, scols, kcols = cuda_scan.level_cols(curve, pts, sg, ky, n_buckets)
    assert tuple(kcols.shape) == (30, 32768)
    ks = kernels.CURVE_KERNELS[name]
    before = {op: ks[op].launches for op in ("seg_level_affine", "seg_scan")}
    b1 = cuda_scan.bucket_array(curve, n_buckets, dev)
    out, out_key = cuda_scan.seg_level(curve, cols, scols, kcols, b1, n_buckets)
    b2 = cuda_scan.bucket_array(curve, n_buckets, dev)
    out2, key2 = cuda_scan.seg_level_plain(curve, cols, scols, kcols, b2,
                                           n_buckets)
    assert all(torch.equal(a, b) for a, b in zip(list(out) + list(b1),
                                                 list(out2) + list(b2)))
    assert torch.equal(out_key, key2)
    assert tuple(scan.scan_schedule(65536)) == (2, 256, 2)
    got = XyzzPoint(*(c.clone() for c in b1))
    cuda_scan.seg_scan(curve, out, out_key, got, n_buckets)
    cuda_scan.seg_scan_plain(curve, out, out_key, b2, n_buckets)
    assert all(torch.equal(a, b) for a, b in zip(got, b2))
    assert {op: ks[op].launches - before[op] for op in before} == {
        "seg_level_affine": 1, "seg_scan": 1}


@pytest.mark.parametrize("name", CURVES)
def test_seg_kernels_keep_their_blocks(dev, name):
    """K5's level and its scan's four kernels keep two blocks an SM, the
    wave their shapes are picked for."""
    from msm_blst_tpu_torch import kernels

    assert min(kernels.occupancy(name, "seg_level_affine")) >= 2


@pytest.mark.parametrize("name", CURVES)
def test_msm_algorithms_on_the_card(dev, name):
    """Host-recode CHES, BGMW95 (the r - a fold: c'=5, h'=51) and stock
    Pippenger (window 8), each with both bucket strategies."""
    from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list,
                                        msm_bgmw_device, msm_ches_host_recode,
                                        msm_stock_pippenger, params, recode)

    curve = _curve(name)
    n = 64
    plan = build_plan(curve, fixed_point_list(curve, n, device=dev),
                      params.make_config(6, c=8, h=32, c_bgmw=5, h_bgmw=51))
    ints = recode.scalars_to_ints(recode.random_scalars(n, seed=2))
    ints[0], ints[1], ints[2] = 0, R_ORDER - 1, ints[3]
    host = recode.scalars_from_ints(ints)
    sc = recode.to_device(host, dev)
    total = sum(s * pow(2, i + 1, R_ORDER) for i, s in enumerate(ints)) % R_ORDER
    for impl in ("prefix", "segmented"):
        for jac in (msm_ches_host_recode(plan, host, bucket_impl=impl),
                    msm_bgmw_device(plan, sc, bucket_impl=impl),
                    msm_stock_pippenger(plan, sc, window=8, bucket_impl=impl)):
            got = curve.affine_to_ints(curve.jac_to_affine(jac))[0]
            assert got == _oracle(name, total)


@pytest.mark.parametrize("name", CURVES)
def test_msm_ches_device_on_the_card(dev, name):
    from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list,
                                        msm_ches_device, params, recode)

    curve = _curve(name)
    n = 64
    plan = build_plan(curve, fixed_point_list(curve, n, device=dev),
                      params.make_config(6, c=8, h=32))
    ints = recode.scalars_to_ints(recode.random_scalars(n, seed=1))
    ints[0], ints[1], ints[2] = 0, R_ORDER - 1, ints[3]
    jac = msm_ches_device(plan, recode.to_device(
        recode.scalars_from_ints(ints), dev))
    total = sum(s * pow(2, i + 1, R_ORDER) for i, s in enumerate(ints)) % R_ORDER
    got = curve.affine_to_ints(curve.jac_to_affine(jac))[0]
    assert got == _oracle(name, total)


def _random_fp(n, seed, dev):
    from msm_blst_tpu_torch.fields import FP

    rng = np.random.default_rng(seed)
    xs = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]
    xs[:3] = [0, 1, P - 1]
    return FP.from_ints(xs, device=dev)


# K6's edge pairs: zero, one, p - 1, R mod p, and 2^192 * 2^192, whose full
# product is 0 mod R (so m = 0)
_SOS_EDGES = [(0, 5), (7, 0), (1, P - 1), (P - 1, P - 1), ((1 << 384) % P,
              (1 << 384) % P), (1 << 192, 1 << 192), (P - 1, 1),
              (1 << 380, 16)]


@pytest.mark.parametrize("stage", ["prod", "bytes", "mm1", "full"])
def test_sos_kernel_matches_plain(dev, stage):
    """K6 at each stage, equal to its plain version word for word (and the
    full stage to K1): on batches that are not a multiple of a warp (the
    tail lanes stay in the warp and store nothing), at the batch
    inversion's column shape (10,752) and on more groups than the
    persistent grid has warps (100,003), and on the edge pairs."""
    from msm_blst_tpu_torch.fields import FP, cuda_mont, sos

    cases = [(_random_fp(n, 4, dev), _random_fp(n, 5, dev).flip(1).contiguous())
             for n in (1000, 10752, 100003)]
    cases.append(tuple(FP.from_ints([e[i] for e in _SOS_EDGES], mont=False,
                                    device=dev) for i in (0, 1)))
    for a, b in cases:
        got = sos.sos_stage(a, b, FP, stage)
        assert torch.equal(got, sos.sos_stage_plain(a, b, FP, stage))
        if stage == "full":
            assert torch.equal(got, cuda_mont.mont_mul(a, b, FP))


def test_sos_kernel_occupancy(dev):
    """Every K6 stage keeps the resident blocks an SM its persistent grid
    is sized for."""
    from msm_blst_tpu_torch import kernels

    assert min(kernels.sos_occupancy()) >= kernels.sos_min_blocks()


@pytest.mark.parametrize("dtype", ["uint32", "int32", "float32"])
def test_madd_chain_kernel_matches_plain(dev, dtype):
    from msm_blst_tpu_torch.drivers import microbench

    a, b = microbench.madd_chain_inputs(dtype, (64, 96), dev)
    got = microbench.madd_chain(a, b, 8, dtype)
    assert torch.equal(got, microbench.madd_chain_plain(a, b, 8, dtype))


def test_gather_smem_kernel_matches_take(dev):
    from msm_blst_tpu_torch.drivers import gather_bench

    d = gather_bench.inputs(65537, 1 << 14, dev)
    got = gather_bench.gather_smem(d["table"], d["idx"])
    assert torch.equal(got, torch.take(d["table"], d["idx64"]))


def _gather_case(T, N, seed, dev):
    rng = np.random.default_rng(seed)
    table = torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, size=T,
                                         dtype=np.int64).astype(np.int32),
                            device=dev)
    idx = torch.as_tensor(rng.integers(0, T, size=N).astype(np.int32),
                          device=dev)
    return table, idx


@pytest.mark.parametrize("N", [1, 3, 1023, (1 << 14) + 3, 1 << 19])
@pytest.mark.parametrize("T", [1, 5, 4097, 65537, "max"])
def test_gather_smem_shapes_match_take(dev, T, N):
    """K8 equals torch.take word for word, from a one-entry table to the
    most a 2-CTA cluster holds, with N on and off the kernel's four-index
    steps."""
    from msm_blst_tpu_torch.drivers import gather_bench
    from msm_blst_tpu_torch.kernels import GATHER_SMEM

    T = gather_bench.MAX_TABLE if T == "max" else T
    table, idx = _gather_case(T, N, T + N, dev)
    before = GATHER_SMEM.launches
    got = gather_bench.gather_smem(table, idx)
    assert GATHER_SMEM.launches == before + 1
    assert torch.equal(got, torch.take(table, idx.to(torch.int64)))


@pytest.mark.parametrize("pattern", ["first", "last", "sorted", "bench"])
def test_gather_smem_index_patterns(dev, pattern):
    """K8 on the gather bench's table (T = 65,537, N = 2^19): indices all in
    CTA 0's slice, all in CTA 1's (the plain-loaded tail included), sorted,
    and the bench's own."""
    from msm_blst_tpu_torch.drivers import gather_bench

    d = gather_bench.inputs(device=dev)
    table, idx = d["table"], d["idx"]
    T, N = table.numel(), idx.numel()
    slice_ = -(-T // 8) * 4  # CTA 0 holds [0, slice_), CTA 1 the rest
    rng = np.random.default_rng(2)
    if pattern == "first":
        idx = torch.as_tensor(rng.integers(0, slice_, size=N).astype(
            np.int32), device=dev)
    elif pattern == "last":
        idx = torch.as_tensor(rng.integers(slice_, T, size=N).astype(
            np.int32), device=dev)
        idx[-4:] = T - 1
    elif pattern == "sorted":
        idx = torch.sort(idx).values
    assert gather_bench.cluster_capacity(T) >= 1
    got = gather_bench.gather_smem(table, idx)
    assert torch.equal(got, torch.take(table, idx.to(torch.int64)))


def test_gather_smem_refuses(dev):
    """No fallback: a table above what the cluster holds raises, and
    launches nothing."""
    from msm_blst_tpu_torch.drivers import gather_bench
    from msm_blst_tpu_torch.kernels import GATHER_SMEM

    table, idx = _gather_case(gather_bench.MAX_TABLE + 1, 1024, 3, dev)
    before = GATHER_SMEM.launches
    with pytest.raises(ValueError):
        gather_bench.gather_smem(table, idx)
    assert GATHER_SMEM.launches == before


@pytest.mark.parametrize("head", [1, 2, 3])
def test_gather_smem_unaligned_views(dev, head):
    """Views that start off the kernel's 16-byte step (the table, the
    indices, or both) still give torch.take's words through K8."""
    from msm_blst_tpu_torch.drivers import gather_bench
    from msm_blst_tpu_torch.kernels import GATHER_SMEM

    table, idx = _gather_case(4097 + head, 1023 + head, head, dev)
    idx = idx % 4097
    before = GATHER_SMEM.launches
    for t, i in ((table[head:], idx), (table, idx[head:]),
                 (table[head:], idx[head:])):
        got = gather_bench.gather_smem(t, i)
        assert torch.equal(got, torch.take(t, i.to(torch.int64)))
    assert GATHER_SMEM.launches == before + 3


@pytest.mark.parametrize("name", CURVES)
def test_msm_ches_device_sos_on_the_card(dev, name):
    """The CHES query with every unfused product on K6, the plan built
    under it too, against the oracle; K1 never launches."""
    from msm_blst_tpu_torch import kernels
    from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list,
                                        msm_ches_device, params, recode)

    n = 64
    kernels.MONT_MUL.launches = kernels.SOS_MUL["full"].launches = 0
    plan = build_plan(_curve(name),
                      fixed_point_list(_curve(name), n, device=dev,
                                       mul_impl="sos"),
                      params.make_config(6, c=8, h=32), mul_impl="sos")
    ints = recode.scalars_to_ints(recode.random_scalars(n, seed=3))
    ints[0], ints[1] = 0, R_ORDER - 1
    jac = msm_ches_device(plan, recode.to_device(
        recode.scalars_from_ints(ints), dev))
    total = sum(s * pow(2, i + 1, R_ORDER) for i, s in enumerate(ints)) % R_ORDER
    got = plan.curve.affine_to_ints(plan.curve.jac_to_affine(jac))[0]
    assert got == _oracle(name, total)
    assert kernels.MONT_MUL.launches == 0
    assert kernels.SOS_MUL["full"].launches > 0


@pytest.mark.parametrize("name", CURVES)
def test_fold_kernel_matches_plain(dev, name):
    """K9 over 60,005 elements in five segments, two of them empty and one
    read through an index: k = 2 and three passes (the long segments leave
    157 and 79 partials, then 2 and 1); equal to the plain twin word for
    word, with and without the index."""
    from msm_blst_tpu_torch.curves import XyzzPoint
    from msm_blst_tpu_torch.msm import scan

    curve = _curve(name)
    base = curve.xyzz_double(curve.xyzz_from_affine(_points(64, dev, name)))
    rng = np.random.default_rng(6)
    pts = XyzzPoint(*(c[..., torch.as_tensor(rng.integers(0, 64, 60005),
                                             device=dev)] for c in base))
    offsets = [0, 0, 5, 40000, 40000, 60005]
    assert [(k, len(t)) for k, t in scan.fold_schedule(offsets)] == \
        [(2, 239), (1, 6), (1, 5)]
    index = torch.as_tensor(rng.permutation(60005), device=dev)
    for idx in (None, index):
        got = scan.fold_segments(curve, pts, offsets, index=idx)
        want = scan.fold_segments_plain(curve, pts, offsets, index=idx)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert not bool(got.ZZ[..., 0].any()) and bool(got.ZZ[..., 2].any())


@pytest.mark.parametrize("name", CURVES)
def test_integrate_gapped_on_the_card(dev, name):
    """The CHES integration through K9 on the card equals the CPU twin's
    point, on a plan's gap groups (c=10, h=26: 218 buckets, every gap)."""
    from msm_blst_tpu_torch.curves import XyzzPoint
    from msm_blst_tpu_torch.msm import params
    from msm_blst_tpu_torch.msm.engine import MsmPlan, integrate_gapped
    from msm_blst_tpu_torch.msm.precompute import _attach_ches_params

    curve = _curve(name)
    cfg = params.make_config(6, c=10, h=26)
    base = curve.xyzz_double(curve.xyzz_from_affine(_points(64, dev, name)))
    rng = np.random.default_rng(7)
    buckets = XyzzPoint(*(c[..., torch.as_tensor(
        rng.integers(0, 64, cfg.b_size), device=dev)] for c in base))
    out = {}
    for d in (dev, torch.device("cpu")):
        plan = MsmPlan(curve=curve, cfg=cfg)
        _attach_ches_params(plan, cfg, d)
        acc = integrate_gapped(curve, XyzzPoint(*(c.to(d) for c in buckets)),
                               plan.gap_groups)
        out[d.type] = curve.affine_to_ints(
            curve.jac_to_affine(curve.xyzz_to_jac(acc)))
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("name", CURVES)
def test_streamed_build_on_the_card_matches_cpu(dev, name):
    """The window-major builders on the card (the point split by the free
    memory, and in 3 parts) equal their CPU build word for word."""
    import dataclasses

    from msm_blst_tpu_torch.msm import (build_bgmw_table_rows_streamed,
                                        build_ches_table_rows_streamed,
                                        params)

    curve = _curve(name)
    cpu_pts = _points(40, torch.device("cpu"), name)
    card_pts = type(cpu_pts)(*(c.to(dev) for c in cpu_pts))
    cfg = dataclasses.replace(params.make_config(6, c=8, h=32), h=3, h_bgmw=2)
    for build in (build_ches_table_rows_streamed,
                  build_bgmw_table_rows_streamed):
        want = build(curve, cpu_pts, cfg).XY
        for parts in (None, 3):
            got = build(curve, card_pts, cfg, parts=parts).XY
            assert torch.equal(got.cpu(), want), (build.__name__, parts)


@pytest.mark.parametrize("name", CURVES)
def test_msm_bign_on_the_card(dev, name):
    """A streamed plan on the card; msm_bign (CHES and BGMW95) at the chunk
    count the free memory gives and at 3, msm_ches_device, the bucket sums
    with the stream split in 3 by position against one pass, and the plan's
    cache round trip."""
    import tempfile

    from msm_blst_tpu_torch.msm import (build_plan, engine, fixed_point_list,
                                        load_plan, msm_bign, msm_ches_device,
                                        params, prefix_pipeline, recode,
                                        save_plan)

    curve = _curve(name)
    n = 64
    cfg = params.make_config(6, c=8, h=32)
    plan = build_plan(curve, fixed_point_list(curve, n, device=dev), cfg,
                      streamed=True, stock=False)
    assert plan.layout == "j" and plan.bgmw_stride3
    ints = recode.scalars_to_ints(recode.random_scalars(n, seed=4))
    ints[0], ints[1], ints[2] = 0, R_ORDER - 1, ints[3]
    sc = recode.to_device(recode.scalars_from_ints(ints), dev)
    total = sum(s * pow(2, i + 1, R_ORDER) for i, s in enumerate(ints)) % R_ORDER
    want = _oracle(name, total)

    def affine(jac):
        return curve.affine_to_ints(curve.jac_to_affine(jac))[0]

    for algo in ("ches", "bgmw"):
        for K in (None, 3):
            assert affine(msm_bign(plan, sc, algo, n_chunks=K)) == want
    assert affine(msm_ches_device(plan, sc)) == want
    keys_s, slots_s, signs_s = engine._sort_stream(
        *engine._ches_streams(plan, sc))
    sums = [prefix_pipeline.bucket_sums_prefix(
        curve, plan.table3nh, slots_s, signs_s, keys_s, cfg.b_size,
        chunks=chunks) for chunks in (1, 3)]
    assert len({tuple(curve.affine_to_ints(curve.jac_to_affine(
        curve.xyzz_to_jac(b)))) for b in sums}) == 1
    with tempfile.TemporaryDirectory() as d:
        save_plan(plan, d)
        loaded = load_plan(curve, cfg, n, d, device=dev)
    assert loaded.layout == "j" and loaded.bgmw_stride3
    assert torch.equal(loaded.table3nh.XY, plan.table3nh.XY)
    assert affine(msm_bign(loaded, sc, "bgmw")) == want


def test_hash_to_g1_device_on_the_card(dev):
    """hash_to_g1_device through K1 and K2 equals the port's host oracle,
    and the pairs whose maps double and cancel in K2's add too."""
    from msm_blst_tpu_torch.curves import G1
    from msm_blst_tpu_torch.fields import FP
    from msm_blst_tpu_torch.protocol import device_map as dm
    from msm_blst_tpu_torch.protocol import hash_to_curve as h2c
    from msm_blst_tpu_torch.refimpl import G1_REF as ref
    from msm_blst_tpu_torch.refimpl import Fp

    msgs = [b"", b"abc", bytes(range(40))]
    got = G1.affine_to_ints(dm.hash_to_g1_device(msgs, device=dev))
    assert got == [h2c.hash_to_g1(m) for m in msgs]
    u = 0x1234567890ABCDEF
    pairs = [(u, u), (u, P - u), (0, 0)]
    got = G1.affine_to_ints(dm._run_hash_to_g1(FP.from_ints(
        [x for pair in pairs for x in pair], device=dev)))
    for (u0, u1), pt in zip(pairs, got):
        q = ref.jac_add(*(ref.from_affine(h2c.map_to_curve_g1(Fp(x)))
                          for x in (u0, u1)))
        w = h2c.clear_cofactor_g1(ref.to_affine(q))
        assert pt == (w[0].v, w[1].v)
    assert got[1] == (0, 0)


def test_map_to_g2_device_on_the_card(dev):
    from msm_blst_tpu_torch.curves import G2
    from msm_blst_tpu_torch.fields import FP2
    from msm_blst_tpu_torch.protocol import device_map as dm
    from msm_blst_tpu_torch.protocol import hash_to_curve as h2c
    from msm_blst_tpu_torch.refimpl import Fp2

    us = [(0, 0), (0, 5), (7, 0), (123456789, 987654321)]
    got = G2.affine_to_ints(dm.map_to_g2_device(
        FP2.from_int_pairs(us, device=dev), device=dev))
    for u, pt in zip(us, got):
        x, y = h2c.map_to_curve_g2(Fp2(*u))
        assert pt == ((x.c0.v, x.c1.v), (y.c0.v, y.c1.v))
