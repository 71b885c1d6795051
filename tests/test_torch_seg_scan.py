"""K5's segmented scan (msm/cuda_scan.py seg_scan_plain), its affine level's
shape (seg_level_shape) and the whole segmented reduction over them, on
the CPU (against the JAX package's fused reduction:
tests/test_torch_seg_jax.py).

* The twin against a loop that spells out the kernel's up, carry and down
  steps one thread and one add at a time, word for word, on G1 and G2:
  one tile of one element a thread and of two, and (a block of four
  threads and a wave of eight, patched in as tests/test_torch_block_scan.py
  patches them) seven tiles whose carry pass takes two totals a thread,
  with a run across tiles and, on G1, one that spans every tile.
* seg_level_shape at the CHES, BGMW95 (n·h') and stock-window (n) streams
  of CONFIGS[14], [16] and [21]: c columns of n_ch lanes hold the stream
  with no lane to spare, n_ch fits one wave, and no other column count
  gives a level of less modelled depth c + scan_depth(scan_schedule(2
  n_ch)), nor of the same depth over fewer lanes. CONFIGS[16]: BGMW
  (30, 32,768), 51 adds; a stock window (4, 16,384), 23 (the JAX
  package's first levels: 60 x 16,384 and 32 x 2,048). Below 1024
  elements the shape is the JAX package's pick_chunk columns.
* The reduction's edges against the integer oracle, G1 and G2, with the
  real block and with the small one (the level then takes 38 columns of
  32 lanes and the scan a carry pass): a lane's tail and the next lane's
  head one point (the scan doubles) and opposite points (it cancels),
  lanes that are one run (infinite heads inside a run of five lanes), a
  run across a tile of the scan, empty buckets, pad keys (n_buckets)
  after the last real bucket, which must not reach it, and every element
  one key.
"""

import numpy as np
import pytest
import torch

from msm_blst_tpu.msm import pallas_scan
from msm_blst_tpu_torch import refimpl
from msm_blst_tpu_torch.curves import G1, G2, XyzzPoint
from msm_blst_tpu_torch.msm import cuda_scan, fixed_point_list, params, scan
from msm_blst_tpu_torch.msm.scan import segmented_reduce_affine
from msm_blst_tpu_torch.utils.scans import pick_chunk

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card
N_BASE = 24


def _base_ints(curve):
    """(i + 1) G for i < N_BASE, affine ints: row 1 is twice row 0."""
    ref = refimpl.CURVES[curve.name]
    pts, acc = [], ref.INF
    for _ in range(N_BASE):
        acc = ref.add(acc, ref.GENERATOR)
        pts.append(acc)
    return pts


def _oracle(curve, base, slots, signs, keys, n_buckets):
    ref = refimpl.CURVES[curve.name]
    F = ref.F
    out = [ref.INF] * n_buckets
    for s, g, k in zip(slots, signs, keys):
        if 0 <= k < n_buckets:
            x, y = base[s]
            out[k] = ref.add(out[k], (x, F.sub(F.zero, y)) if g else (x, y))
    return out


def same_points(curve, pts: XyzzPoint, want) -> bool:
    """The xyzz buckets `pts` are the oracle's affine points `want`: X =
    x ZZ and Y = y ZZZ with ZZ nonzero, or ZZ = ZZZ = 0 for infinity (no
    inversion, which the plain field runs as hundreds of products)."""
    ref = refimpl.CURVES[curve.name]
    F = ref.F
    conv = curve.F.to_ints if curve.name == "G1" else curve.F.to_int_pairs
    for (X, Y, ZZZ, ZZ), w in zip(zip(*(conv(c) for c in pts)), want):
        if w == ref.INF:
            if ZZ != F.zero or ZZZ != F.zero:
                return False
        elif (ZZ == F.zero or X != F.mul(w[0], ZZ)
              or Y != F.mul(w[1], ZZZ)):
            return False
    return len(want) == pts.X.shape[-1]


def _reduce(curve, base, slots, signs, keys, n_buckets):
    rows = curve.to_rows32(curve.affine_from_ints(base, device=CPU))
    stream = type(rows)(rows.XY[torch.as_tensor(slots)])
    return segmented_reduce_affine(curve, stream, torch.as_tensor(signs) != 0,
                                   torch.as_tensor(keys, dtype=torch.int32),
                                   n_buckets)


@pytest.fixture
def small_blocks(monkeypatch):
    """A block of four threads and a wave of eight tiles."""
    monkeypatch.setattr(scan, "FOLD_THREADS", 4)
    monkeypatch.setattr(scan, "FOLD_WAVE", 8)
    scan.scan_schedule.cache_clear()
    yield
    scan.scan_schedule.cache_clear()


# ---- the twin against the kernel's loop ------------------------------------


def _kernel_loop(curve, pts, keys, buckets, n_buckets):
    """K5's scan one thread and one add at a time (csrc/seg_scan.cuh):
    thread pairs of k elements in order, the segmented Kogge-Stone levels
    (a flagged thread adds nothing), then each thread's k values from its
    offset, each run's last one stored; with more than one tile the same
    one-block scan over the tile totals and their flags gives the carries,
    and a thread whose first element continues a run takes thread j - 1's
    pair put after carry[t - 1] as its offset."""
    T = scan.FOLD_THREADS
    M = keys.shape[0]
    k, n_tiles, k_carry = scan.scan_schedule(M)
    inf = curve.xyzz_inf((1,), CPU)
    kl = keys.tolist()

    def dadd(a, b):
        return curve.xyzz_dadd_body(a, b, F=curve.F.plain)

    def elem(src, i):
        return XyzzPoint(*(c[..., i:i + 1] for c in src))

    def thread_pair(src, flags, n, first, k):
        if first >= n:
            return inf, False
        a, f = elem(src, first), flags[first]
        for e in range(1, k):
            if first + e >= n:
                break
            if flags[first + e]:
                a, f = elem(src, first + e), True
            else:
                a = dadd(a, elem(src, first + e))
        return a, f

    def emit(run, src, flags, n, first, k, sink):
        for e in range(k):
            i = first + e
            if i >= n:
                break
            run = elem(src, i) if flags[i] else dadd(run, elem(src, i))
            sink(run, i)

    def block_inclusive(pairs):
        d = 1
        while d < T:
            prev = list(pairs)
            for j in range(d, T):
                if not prev[j][1]:
                    pairs[j] = (dadd(prev[j - d][0], prev[j][0]),
                                prev[j - d][1])
            d *= 2
        return pairs

    def tile(src, flags, n, k, sink):
        incl = block_inclusive([thread_pair(src, flags, n, j * k, k)
                                for j in range(T)])
        for j in range(T):
            emit(incl[j - 1][0] if j else inf, src, flags, n, j * k, k, sink)

    def store(run, i):
        if (i + 1 == M or kl[i + 1] != kl[i]) and 0 <= kl[i] < n_buckets:
            for bc, rc in zip(buckets, run):
                bc[..., kl[i]] = rc[..., 0]

    flags = [i == 0 or kl[i] != kl[i - 1] for i in range(M)]
    if n_tiles == 1:
        tile(pts, flags, M, k, store)
        return
    part = [block_inclusive([thread_pair(pts, flags, M, (t * T + j) * k, k)
                             for j in range(T)]) for t in range(n_tiles)]
    tot = XyzzPoint(*(torch.cat(cs, dim=-1) for cs in zip(*(p[-1][0]
                                                            for p in part))))
    carry = []
    tile(tot, [p[-1][1] for p in part], n_tiles, k_carry,
         lambda run, i: carry.append(run))
    for t in range(n_tiles):
        for j in range(T):
            first = (t * T + j) * k
            if first >= M:
                continue
            if flags[first]:
                off = inf
            elif j and (t == 0 or part[t][j - 1][1]):
                off = part[t][j - 1][0]
            else:
                off = carry[t - 1] if t else inf
                if j:
                    off = dadd(off, part[t][j - 1][0])
            emit(off, pts, flags, M, first, k, store)


def _heads_tails(curve, M, n_keys, seed):
    """A key-sorted xyzz stream of M doubled lifts of signed points: equal
    neighbours (a doubling) and opposite ones (a cancellation) inside runs,
    infinity now and then, keys n_keys apart on average runs of 2."""
    rng = np.random.default_rng(seed)
    base = curve.xyzz_double(curve.xyzz_from_affine(
        fixed_point_list(curve, 8, device=CPU)))
    idx = torch.as_tensor(rng.integers(0, 8, M))
    pts = XyzzPoint(*(c[..., idx].clone() for c in base))
    for c in pts:
        c[..., 5] = c[..., 4]
        c[..., 9] = c[..., 8]
        c[..., 13::29] = 0
    pts.Y[..., 9] = curve.F.plain.neg(pts.Y[..., 9:10])[..., 0]
    keys = np.sort(rng.integers(0, n_keys, M)).astype(np.int32)
    keys[3:6] = keys[4]
    keys[7:10] = keys[8]
    return pts, torch.as_tensor(keys)


def _twin_and_loop(curve, pts, keys, n_buckets):
    out = []
    for fn in (cuda_scan.seg_scan_plain, _kernel_loop):
        buckets = cuda_scan.bucket_array(curve, n_buckets, CPU)
        fn(curve, pts, keys, buckets, n_buckets)
        out.append(buckets)
    for a, b in zip(*out):
        assert torch.equal(a, b)
    return out[0]


@pytest.mark.parametrize("M,k", [(100, 1), (200, 2)])
def test_seg_scan_order_is_the_kernels_one_tile(M, k):
    pts, keys = _heads_tails(G1, M, M // 2, M)
    keys[-3:] = M // 2  # pads
    assert tuple(scan.scan_schedule(M)) == (k, 1, 0)
    got = _twin_and_loop(G1, pts, keys, M // 2)
    assert bool(got.ZZ.any())


@pytest.mark.parametrize("curve", [G1, G2], ids=["G1", "G2"])
def test_seg_scan_order_is_the_kernels_carry_pass(curve, small_blocks):
    """Seven tiles of 4 x 4 elements, the last one partial, two totals a
    thread in the carry pass; one run crosses tiles 2 to 4, and on G1 in a
    second stream one key holds every element."""
    M = 100
    assert scan.scan_schedule(M) == scan.ScanSchedule(4, 7, 2)
    pts, keys = _heads_tails(curve, M, 40, 3)
    keys[30:70] = keys[30]
    keys[70:] = torch.maximum(keys[70:], keys[30] + 1)
    _twin_and_loop(curve, pts, keys, 40)
    if curve is G1:  # every add happens: the loop's costliest stream
        _twin_and_loop(curve, pts, torch.full((M,), 7, dtype=torch.int32), 40)


# ---- the level's shape -------------------------------------------------------


def _config_streams():
    for n_log in (14, 16, 21):
        cfg, n = params.CONFIGS[n_log], 1 << n_log
        yield pytest.param(n * cfg.h, id=f"ches-{n_log}")
        yield pytest.param(n * cfg.h_bgmw, id=f"bgmw-{n_log}")
        yield pytest.param(n, id=f"stock-{n_log}")


def _depth(c, n_ch):
    return c + scan.scan_depth(scan.scan_schedule(2 * n_ch))


@pytest.mark.parametrize("N", _config_streams())
def test_seg_level_shape_at_the_configs(N):
    c, n_ch = cuda_scan.seg_level_shape(N)
    wave = scan.FOLD_WAVE * scan.FOLD_THREADS
    assert c >= 2
    assert c * n_ch >= N > (c - 1) * n_ch
    assert (n_ch - 1) * c < N  # every lane holds a stream element
    assert n_ch <= wave
    best = (_depth(c, n_ch), n_ch)
    # the scan is at least one add deep: a level of more columns than
    # `best`'s depth is deeper
    for cc in range(max(2, -(-N // wave)), best[0] + 1):
        lanes = -(-N // cc)
        assert (_depth(-(-N // lanes), lanes), lanes) >= best
    want = {params.CONFIGS[16].h_bgmw << 16: (30, 32768, 51),
            1 << 16: (4, 16384, 23)}
    if N in want:
        assert (c, n_ch, best[0]) == want[N]
        # the JAX package's first level: 60 x 16,384 (BGMW), 32 x 2,048
        assert pallas_scan._shape_stream(N)[:2] == {
            983040: (60, 16384), 65536: (32, 2048)}[N]


@pytest.mark.parametrize("N", [1, 16, 17, 500, 1023])
def test_small_streams_keep_the_jax_columns(N):
    c = pick_chunk(N)
    assert cuda_scan.seg_level_shape(N) == (c, -(-N // c))


# ---- the reduction's edges ---------------------------------------------------


def _edge_stream(N, c, n_buckets, cross, seed):
    """A key-sorted stream (slots, signs, keys) over n_buckets with lanes of
    c elements: the last two elements of lane 2 and the first two of lane
    3 one point and one key of their own (2P meets 2P in the scan), the
    same at lanes 5 and 6 with the second pair negated (2P meets -2P);
    lanes 8 to 10 one run with the last element of lane 7 and the first of
    lane 11 (infinite heads inside it); lanes [cross[0], cross[1]) one run
    across a tile boundary of the scan; then the last real bucket right
    before seven pads (key n_buckets). Key 0 is left empty."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, N_BASE, N)
    signs = rng.integers(0, 2, N)
    keys = 2 * np.sort(rng.integers(1, n_buckets // 2 - 4, N))

    def own(lo, hi):  # elements [lo, hi) alone hold one (odd) key
        v = keys[lo] + 1
        keys[lo:hi] = v
        keys[hi:] = np.maximum(keys[hi:], v + 1)

    for lane, flip in ((2, 0), (5, 1)):
        i = (lane + 1) * c
        own(i - 2, i + 2)
        slots[i - 2:i + 2] = slots[i]
        signs[i - 2:i + 2] = (0, 0, flip, flip)
    own(8 * c - 1, 11 * c + 1)
    own(cross[0] * c, cross[1] * c)
    keys[-9:-7] = n_buckets - 1
    keys[-7:] = n_buckets
    return slots, signs, keys.astype(np.int32)


@pytest.mark.parametrize("curve", [G1, G2], ids=["G1", "G2"])
@pytest.mark.parametrize("blocks", ["real", "small"])
def test_segmented_reduce_edges_match_the_oracle(curve, blocks, monkeypatch):
    """The real block: 1,500 elements in a level of 2 columns over 750
    lanes, a scan of 1,500 heads and tails in 12 tiles (lanes 60-69 cross
    the first boundary); the small one: 1,200 elements in 38 columns over
    32 lanes, a scan of 64 in 8 tiles of 8 with a carry pass of two totals
    a thread (lanes 14-17 cross one)."""
    if blocks == "small":
        monkeypatch.setattr(scan, "FOLD_THREADS", 4)
        monkeypatch.setattr(scan, "FOLD_WAVE", 8)
    scan.scan_schedule.cache_clear()
    try:
        N, n_buckets = {"real": 1500, "small": 1200}[blocks], 400
        c, n_ch = cuda_scan.seg_level_shape(N)
        assert (c, n_ch) == {"real": (2, 750), "small": (38, 32)}[blocks]
        k, n_tiles, k_carry = scan.scan_schedule(2 * n_ch)
        assert (n_tiles, k_carry) == {"real": (12, 1), "small": (8, 2)}[blocks]
        cross = {"real": (60, 70), "small": (14, 18)}[blocks]
        span = scan.FOLD_THREADS * k  # a tile of the scan: span / 2 lanes
        assert 2 * cross[0] // span < (2 * cross[1] - 1) // span
        base = _base_ints(curve)
        slots, signs, keys = _edge_stream(N, c, n_buckets, cross, 11)
        want = _oracle(curve, base, slots, signs, keys, n_buckets)
        assert same_points(curve, _reduce(curve, base, slots, signs, keys,
                                          n_buckets), want)
        ref = refimpl.CURVES[curve.name]
        assert want[keys[3 * c]] == ref.mult(4, base[slots[3 * c]])
        assert want[keys[6 * c]] == ref.INF
        assert want[0] == ref.INF and want[n_buckets - 1] != ref.INF
    finally:
        scan.scan_schedule.cache_clear()


@pytest.mark.parametrize("curve", [G1, G2], ids=["G1", "G2"])
def test_segmented_reduce_of_one_key(curve, small_blocks):
    """Every element one key: each lane is one run (infinite heads), and the
    scan's one run spans all its tiles (400 elements: the JAX package's 16
    columns over 25 lanes, then 50 heads and tails in 7 tiles of the small
    block, two totals a thread in the carry pass)."""
    base = _base_ints(curve)
    N = 400
    assert cuda_scan.seg_level_shape(N) == (16, 25)
    assert scan.scan_schedule(50) == scan.ScanSchedule(2, 7, 2)
    rng = np.random.default_rng(2)
    slots, signs = rng.integers(0, N_BASE, N), rng.integers(0, 2, N)
    keys = np.full(N, 3, dtype=np.int32)
    got = _reduce(curve, base, slots, signs, keys, 5)
    assert same_points(curve, got, _oracle(curve, base, slots, signs, keys, 5))
