"""K4's plain twin (msm/scan.py prefix_scan_xyzz_plain), its schedule and
the suffix scan over it, on the CPU.

* The twin against JAX utils/scans prefix_scan, in affine (the sums
  associate otherwise): N in {1, 2, 127, 128, 129, 600} (one tile of 128
  threads, k = 1, 2 or 5), and a stream of seven tiles, the last one
  partial, whose carry pass takes two totals a thread (a block of four
  threads and a wave of eight, patched in).
  The stream repeats points (the adds double), follows points by their
  negations (they cancel), holds infinity and starts P, P, -2P (the running
  sum cancels). One JAX compilation: each N is a prefix of one stream.
* The twin against a loop that spells out the kernel's up, carry and down
  steps one thread and one add at a time, word for word, on G1 and G2: the
  order the card's word-exact check relies on.
* scan_schedule at the CHES configs' suffix and tail scans: tiles within
  one wave, covering [0, N) once and in order, the least depth.
* suffix_scan_xyzz over one stream (a batch of streams is refused), and
  the refusal of a tensor that is neither on the CPU nor on a card.
* G2's stream against JAX is in test_torch_g2_block_scan.py (its JAX
  compilation would take this file past a minute).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.constants import P
from msm_blst_tpu.curves import G1 as JG1
from msm_blst_tpu.refimpl import G1_REF
from msm_blst_tpu.utils import scans as jscans
from msm_blst_tpu_torch.convert import fp_from_jax
from msm_blst_tpu_torch.curves import G1, G2, XyzzPoint
from msm_blst_tpu_torch.fields.limb import array_to_ints
from msm_blst_tpu_torch.msm import fixed_point_list, params, prefix_pipeline, scan
from msm_blst_tpu_torch.utils import scans

torch.set_num_threads(1)
CPU = torch.device("cpu")  # the port's entry points default to the card

L = 600      # the stream; every case scans a prefix of it
PAIRS = 29   # (k, k+1) equal and (k+2, k+3) opposite for k = 3, 32, ...
INF = 41     # infinity at 5, 46, 87, ...


def _stream(n, seed):
    """n doubled lifts of signed affine points (varied Z): P, P, -2P first,
    then equal and opposite neighbours every PAIRS, infinity every INF."""
    rng = random.Random(seed)
    gen = G1_REF.generator_jac()

    def affine(s):
        x, y = G1_REF.to_affine(G1_REF.jac_mult(s, gen))
        return x.v, y.v

    scalars = [rng.randrange(1, 1 << 64) for _ in range(12)]
    base = [affine(s) for s in scalars]
    pts = [base[rng.randrange(12)] for _ in range(n)]
    sgn = [rng.randrange(2) for _ in range(n)]
    for k in range(3, n - 3, PAIRS):
        pts[k + 1], sgn[k + 1] = pts[k], sgn[k]
        pts[k + 3], sgn[k + 3] = pts[k + 2], 1 - sgn[k + 2]
    for k in range(5, n, INF):
        pts[k] = (0, 0)
    pts[0], pts[1], pts[2] = base[0], base[0], affine(2 * scalars[0])
    sgn[0], sgn[1], sgn[2] = 0, 0, 1
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


def _head(pts, n):
    return XyzzPoint(*(c[..., :n].contiguous() for c in pts))


@pytest.fixture(scope="module")
def stream():
    """The port's stream and JAX's prefix sums of it, in affine."""
    js = _stream(L, 1)
    want = jax.jit(lambda p: jscans.prefix_scan(JG1.xyzz_dadd, p))(js)
    return _port(js), _affine_ints(_port(want))


@pytest.fixture
def small_blocks(monkeypatch):
    """A block of four threads and a wave of eight tiles."""
    monkeypatch.setattr(scan, "FOLD_THREADS", 4)
    monkeypatch.setattr(scan, "FOLD_WAVE", 8)
    scan.scan_schedule.cache_clear()
    yield
    scan.scan_schedule.cache_clear()


@pytest.mark.parametrize("N", [1, 2, 127, 128, 129, 600])
def test_prefix_scan_plain_matches_jax(stream, N):
    pts, want = stream
    assert scan.scan_schedule(N).n_tiles == 1
    got = scan.prefix_scan_xyzz_plain(G1, _head(pts, N))
    assert got.X.shape == (12, N)
    assert _affine_ints(got) == want[:N]


def test_prefix_scan_plain_carry_pass_matches_jax(stream, small_blocks):
    """Seven tiles of 4 x 4 elements, the last one partial; the carry pass
    takes two tile totals a thread."""
    pts, want = stream
    assert scan.scan_schedule(100) == scan.ScanSchedule(4, 7, 2)
    got = scan.prefix_scan_xyzz_plain(G1, _head(pts, 100))
    assert _affine_ints(got) == want[:100]
    assert want[2] == (0, 0)  # P + P - 2P


def _kernel_loop(curve, pts):
    """K4 one thread and one add at a time (csrc/block_scan.cuh): thread
    sums of k elements in order, the Kogge-Stone levels, then each thread's
    k sums from its offset; with more than one tile the same one-block scan
    over the tile totals gives the carries, and a thread's offset is
    carry[t - 1] + prefix[t, j - 1]."""
    T = scan.FOLD_THREADS
    N = pts.X.shape[-1]
    k, n_tiles, k_carry = scan.scan_schedule(N)
    inf = curve.xyzz_inf((1,), CPU)

    def dadd(a, b):
        return curve.xyzz_dadd_body(a, b, F=curve.F.plain)

    def elem(src, i, n):
        return XyzzPoint(*(c[..., i:i + 1] for c in src)) if i < n else inf

    def thread_sum(src, n, first, k):
        a = elem(src, first, n)
        for e in range(1, k):
            if first + e >= n:
                break
            a = dadd(a, elem(src, first + e, n))
        return a

    def emit(run, src, n, first, k, out):
        for e in range(k):
            if first + e >= n:
                break
            run = dadd(run, elem(src, first + e, n))
            out.append(run)

    def block_inclusive(acc):
        d = 1
        while d < T:
            prev = list(acc)
            for j in range(d, T):
                acc[j] = dadd(prev[j - d], prev[j])
            d *= 2
        return acc

    def cat(pts_list):
        return XyzzPoint(*(torch.cat(cs, dim=-1) for cs in zip(*pts_list)))

    def tile_scan(src, n, k):
        incl = block_inclusive([thread_sum(src, n, j * k, k) for j in range(T)])
        out = []
        for j in range(T):
            emit(incl[j - 1] if j else inf, src, n, j * k, k, out)
        return cat(out)

    if n_tiles == 1:
        return tile_scan(pts, N, k)
    part = [block_inclusive([thread_sum(pts, N, (t * T + j) * k, k)
                             for j in range(T)]) for t in range(n_tiles)]
    carry = tile_scan(cat([p[-1] for p in part]), n_tiles, k_carry)
    out = []
    for t in range(n_tiles):
        for j in range(T):
            first = (t * T + j) * k
            if first >= N:
                continue
            off = elem(carry, t - 1, n_tiles) if t else inf
            if j:
                off = dadd(off, part[t][j - 1]) if t else part[t][j - 1]
            emit(off, pts, N, first, k, out)
    return cat(out)


def _assert_words_equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_prefix_scan_order_is_the_kernels_one_tile(stream):
    """129 elements: one tile of 128 threads, two elements a thread."""
    pts = _head(stream[0], 129)
    assert scan.scan_schedule(129) == scan.ScanSchedule(2, 1, 0)
    _assert_words_equal(scan.prefix_scan_xyzz_plain(G1, pts),
                        _kernel_loop(G1, pts))


def test_prefix_scan_order_is_the_kernels_carry_pass(stream, small_blocks):
    pts = _head(stream[0], 100)
    _assert_words_equal(scan.prefix_scan_xyzz_plain(G1, pts),
                        _kernel_loop(G1, pts))


def test_prefix_scan_g2_order_and_sums(small_blocks):
    """G2 (Fp2 coordinates): the twin equals the loop word for word and
    the port's chunked scan (utils/scans, held to JAX's elsewhere) as
    points, over repeats, negations and infinity."""
    base = G2.xyzz_double(G2.xyzz_from_affine(fixed_point_list(G2, 8, device=CPU)))
    rng = np.random.default_rng(4)
    idx = torch.as_tensor(rng.integers(0, 8, 70))
    pts = XyzzPoint(*(c[..., idx].clone() for c in base))
    for c in pts:
        c[..., 11] = c[..., 10]
        c[..., 13] = c[..., 12]
        c[..., 7::23] = 0
    pts.Y[..., 13] = G2.F.neg(pts.Y[..., 13:14])[..., 0]
    assert scan.scan_schedule(70) == scan.ScanSchedule(3, 6, 2)
    got = scan.prefix_scan_xyzz_plain(G2, pts)
    _assert_words_equal(got, _kernel_loop(G2, pts))

    def affine(p):
        return G2.affine_to_ints(G2.jac_to_affine(G2.xyzz_to_jac(p)))

    assert affine(got) == affine(scans.prefix_scan(G2.xyzz_dadd, pts))


def _ches_scans(n_log):
    """The CHES query's K4 streams: the integration's suffix scan over the
    buckets but the first, and the K3 level's chunk tails."""
    cfg = params.CONFIGS[n_log]
    _, n_ch = prefix_pipeline.stream_shape((1 << n_log) * cfg.h)
    return cfg.b_size - 1, n_ch


def _schedule(N, k):
    """The tiles and carry pass of k elements a thread."""
    n_tiles = -(-N // (scan.FOLD_THREADS * k))
    return scan.ScanSchedule(
        k, n_tiles, 0 if n_tiles == 1 else -(-n_tiles // scan.FOLD_THREADS))


@pytest.mark.parametrize("n_log", [14, 16, 21])
def test_scan_schedule_at_the_ches_configs(n_log):
    """Tiles within one wave cover [0, N) once, in order, none empty; the
    carry pass's block holds every tile total; no k gives less depth.
    CONFIGS[16]: the suffix scan takes k = 4 and 214 tiles (25 adds deep),
    the level's 32,768 tails k = 1 and 256 tiles (19 adds)."""
    T = scan.FOLD_THREADS
    for N in _ches_scans(n_log):
        s = scan.scan_schedule(N)
        span = T * s.k
        assert s.n_tiles <= scan.FOLD_WAVE
        assert (s.n_tiles - 1) * span < N <= s.n_tiles * span
        assert s.k_carry == (0 if s.n_tiles == 1 else -(-s.n_tiles // T))
        depths = [scan.scan_depth(_schedule(N, k))
                  for k in range(1, -(-N // T) + 1)
                  if _schedule(N, k).n_tiles <= scan.FOLD_WAVE]
        assert scan.scan_depth(s) == min(depths)
    if n_log == 16:
        suffix, tails = _ches_scans(16)
        assert (suffix, tails) == (109243, 32768)
        assert scan.scan_schedule(suffix) == scan.ScanSchedule(4, 214, 2)
        assert scan.scan_depth(scan.scan_schedule(suffix)) == 25
        assert scan.scan_schedule(tails) == scan.ScanSchedule(1, 256, 2)
        assert scan.scan_depth(scan.scan_schedule(tails)) == 19


def test_suffix_scan_over_a_batch(stream):
    """A 1-D stream of 60: its suffix sums, as the chunked suffix scan
    gives them, in affine; a (3, 20) batch of streams is refused (every
    caller scans one stream); the empty stream stays empty."""
    line = _head(stream[0], 60)
    got = scan.suffix_scan_xyzz(G1, line)
    assert got.X.shape == (12, 60)
    assert _affine_ints(got) == _affine_ints(
        scans.suffix_scan(G1.xyzz_dadd, line))
    grid = XyzzPoint(*(c.reshape(12, 3, 20) for c in line))
    with pytest.raises(ValueError, match="1-D"):
        scan.suffix_scan_xyzz(G1, grid)
    empty = XyzzPoint(*(c[..., :0] for c in stream[0]))
    assert scan.suffix_scan_xyzz(G1, empty).X.shape == (12, 0)


def test_prefix_scan_refuses_a_tensor_off_the_cpu_and_the_card(stream):
    """Not on the CPU: the kernel's checks run (here they refuse a meta
    tensor); the plain version is never taken instead."""
    meta = XyzzPoint(*(c[..., :10].to("meta") for c in stream[0]))
    with pytest.raises(ValueError, match="CUDA"):
        scan.prefix_scan_xyzz(G1, meta)
