"""The K3 level's shape (prefix_pipeline.stream_shape) and the bucket sums
of the prefix pipeline over it, against the JAX package and the oracle.

* The schedule at the CHES, BGMW95 (n·h') and stock-window (n) streams of
  CONFIGS[14], [16] and [21]: c columns of n_ch lanes hold the stream with
  no column and no lane to spare, n_ch fits one wave of K3's blocks
  (scan.FOLD_WAVE x scan.FOLD_THREADS), and no other column count gives a
  level of less modelled depth c + scan_depth(scan_schedule(n_ch)), nor of
  the same depth over fewer lanes. CONFIGS[16]'s CHES stream takes
  (28, 32,768), 47 adds deep (the JAX package's shape: (112, 8,192), 129).
  Below 1024 elements the shape is the JAX package's.
* bucket_sums_prefix (CPU: K3's and K4's plain versions) on a ragged G1
  stream of 2,999 elements, whose level the port shapes otherwise than
  JAX ((24, 125)), with the wave patched small as
  tests/test_torch_block_scan.py patches it, so that the level takes more
  than one column (the real wave gives one column of 2,999 lanes): a wave
  of two blocks (12 columns of 250 lanes, K4 in one tile), and a block of
  four threads with a wave of eight tiles (94 columns of 32 lanes, K4 with
  a carry pass). Its buckets
  equal, in affine, JAX's bucket_sums_prefix on the same table and stream
  and the integer oracle's sums (the two pipelines associate the adds
  otherwise, so their xyzz words differ). The stream starts G, G, -2G, G:
  lane 0 doubles, then cancels to infinity.
* The same on G2 against the oracle only: JAX's G2 bucket_sums_prefix
  takes about 160 s to compile on a CPU (G1's about 25 s), beyond this
  file's minute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.curves import G1 as JG1
from msm_blst_tpu.curves.ops import PackedRows32 as JPackedRows32
from msm_blst_tpu.msm import prefix_pipeline as jpp
from msm_blst_tpu_torch import refimpl
from msm_blst_tpu_torch.convert import fp_from_jax
from msm_blst_tpu_torch.curves import G1, G2, XyzzPoint
from msm_blst_tpu_torch.msm import params, prefix_pipeline, scan
from msm_blst_tpu_torch.utils.scans import pick_chunk

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

N_STREAM = 2999
N_TABLE = 24
N_BUCKETS = 300


def _config_streams():
    for n_log in (14, 16, 21):
        cfg, n = params.CONFIGS[n_log], 1 << n_log
        yield pytest.param(n * cfg.h, id=f"ches-{n_log}")
        yield pytest.param(n * cfg.h_bgmw, id=f"bgmw-{n_log}")
        yield pytest.param(n, id=f"stock-{n_log}")


def _depth(c, n_ch):
    return c + scan.scan_depth(scan.scan_schedule(n_ch))


@pytest.mark.parametrize("N", _config_streams())
def test_level_schedule_at_the_configs(N):
    c, n_ch = prefix_pipeline.stream_shape(N)
    wave = scan.FOLD_WAVE * scan.FOLD_THREADS
    assert c * n_ch >= N > (c - 1) * n_ch
    assert (n_ch - 1) * c < N  # every lane holds a stream element
    assert n_ch <= wave
    best = (_depth(c, n_ch), n_ch)
    # K4 is at least one add deep: a level of more columns than `best`'s
    # depth is deeper
    for cc in range(-(-N // wave), best[0] + 1):
        lanes = -(-N // cc)
        assert (_depth(-(-N // lanes), lanes), lanes) >= best
    want = {params.CONFIGS[16].h << 16: (28, 32768, 47),
            params.CONFIGS[16].h_bgmw << 16: (30, 32768, 49),
            1 << 16: (4, 16384, 21),
            params.CONFIGS[14].h << 14: (8, 32768, 27)}
    if N in want:
        assert (c, n_ch, best[0]) == want[N]
    if N == params.CONFIGS[16].h << 16:
        assert scan.scan_schedule(n_ch) == scan.ScanSchedule(1, 256, 2)
        assert jpp.stream_shape(N) == (112, 8192)


@pytest.mark.parametrize("N", [1, 16, 17, 500, 1023])
def test_small_streams_keep_the_jax_shape(N):
    c = pick_chunk(N)
    assert prefix_pipeline.stream_shape(N) == (c, -(-N // c))
    assert prefix_pipeline.stream_shape(N) == jpp.stream_shape(N)


def _table_ints(curve):
    """(i + 1) G for i < N_TABLE, affine ints: row 1 is twice row 0."""
    ref = refimpl.CURVES[curve.name]
    pts, acc = [], ref.INF
    for _ in range(N_TABLE):
        acc = ref.add(acc, ref.GENERATOR)
        pts.append(acc)
    return pts


def _stream():
    """A key-sorted stream of N_STREAM (slot, sign, key) over N_BUCKETS
    buckets (some empty) that starts G, G, -2G, G."""
    rng = np.random.default_rng(17)
    slots = rng.integers(0, N_TABLE, N_STREAM)
    signs = rng.integers(0, 2, N_STREAM)
    keys = np.sort(rng.integers(0, N_BUCKETS, N_STREAM))
    slots[:4], signs[:4] = (0, 0, 1, 0), (0, 0, 1, 0)
    return slots, signs, keys


def _oracle_buckets(curve, table, slots, signs, keys):
    ref = refimpl.CURVES[curve.name]
    F = ref.F
    out = [ref.INF] * N_BUCKETS
    for s, g, k in zip(slots, signs, keys):
        x, y = table[s]
        out[k] = ref.add(out[k], (x, F.sub(F.zero, y)) if g else (x, y))
    return out


def _affine(curve, pts: XyzzPoint):
    return curve.affine_to_ints(curve.jac_to_affine(curve.xyzz_to_jac(pts)))


def _port_buckets(curve, table, slots, signs, keys):
    rows = curve.to_rows32(curve.affine_from_ints(table, device=CPU))
    return prefix_pipeline.bucket_sums_prefix(
        curve, rows, torch.as_tensor(slots, dtype=torch.int32),
        torch.as_tensor(signs != 0), torch.as_tensor(keys, dtype=torch.int32),
        N_BUCKETS)


@pytest.fixture(scope="module")
def g1_case():
    """The G1 table and stream, the oracle's buckets and JAX's, affine."""
    table = _table_ints(G1)
    slots, signs, keys = _stream()
    rows = G1.to_rows32(G1.affine_from_ints(table, device=CPU)).XY
    jtable = JPackedRows32(jnp.asarray(rows.numpy().view(np.uint32)))
    jout = jax.jit(lambda sl, sg, ky: jpp.bucket_sums_prefix(
        JG1, jtable, sl, sg, ky, N_BUCKETS))(
        jnp.asarray(slots, dtype=jnp.int32), jnp.asarray(signs != 0),
        jnp.asarray(keys, dtype=jnp.int32))
    jax_affine = _affine(G1, XyzzPoint(*(fp_from_jax(np.asarray(x), CPU)
                                         for x in jout)))
    want = _oracle_buckets(G1, table, slots, signs, keys)
    assert jax_affine == want
    return table, (slots, signs, keys), want


@pytest.fixture(params=["wave_of_2", "small_blocks"])
def blocks(request, monkeypatch):
    """A wave of two blocks, or a block of four threads and a wave of eight
    tiles."""
    if request.param == "wave_of_2":
        monkeypatch.setattr(scan, "FOLD_WAVE", 2)
    if request.param == "small_blocks":
        monkeypatch.setattr(scan, "FOLD_THREADS", 4)
        monkeypatch.setattr(scan, "FOLD_WAVE", 8)
    scan.scan_schedule.cache_clear()
    yield request.param
    scan.scan_schedule.cache_clear()


def test_bucket_sums_match_jax_and_the_oracle(g1_case, blocks):
    table, stream, want = g1_case
    c, n_ch = prefix_pipeline.stream_shape(N_STREAM)
    assert (c, n_ch) == {"wave_of_2": (12, 250),
                         "small_blocks": (94, 32)}[blocks]
    assert (c, n_ch) != jpp.stream_shape(N_STREAM)
    if blocks == "small_blocks":
        assert scan.scan_schedule(n_ch).n_tiles > 1
    assert _affine(G1, _port_buckets(G1, table, *stream)) == want


def test_g2_bucket_sums_match_the_oracle(blocks):
    table = _table_ints(G2)
    stream = _stream()
    got = _affine(G2, _port_buckets(G2, table, *stream))
    assert got == _oracle_buckets(G2, table, *stream)
