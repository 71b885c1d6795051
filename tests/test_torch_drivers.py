"""The port's measurement drivers and profiling module on the CPU.

* K7's plain chain (drivers/microbench.py madd_chain_plain), for each dtype
  at a short chain, equals a numpy evaluation of the JAX driver's kernel
  body (drivers/microbench.py:51-60, acc = acc * b + a from acc = a) with
  its inputs (:72-77). The JAX bench_vpu_mul returns only a rate, so that
  body is the reference. Integer types wrap in numpy's own uint32 / int32
  arithmetic: exact. float32: K7 is a fused multiply-add (one rounding a
  step), so the reference rounds each step's exact float64 value once:
  exact; against numpy's two roundings a step (the body as written) the
  chain agrees to a relative 1e-5 (at most one float32 ulp, 6e-8, a step
  over 32 steps).
* K8's plain gather equals numpy's take, through K8's wrapper too (which
  takes it on CPU tensors); MAX_TABLE fits the kernel's 2-CTA split.
* utils/profiling.py's op counts and report equal msm_blst_tpu's for
  CONFIGS[16].
* Each driver runs end to end at tiny sizes on the CPU, its checks
  included.
"""

import numpy as np
import pytest
import torch

from msm_blst_tpu.msm import params as jparams
from msm_blst_tpu.utils import profiling as jprof
from msm_blst_tpu_torch.drivers import gather_bench, microbench, mxu_experiment
from msm_blst_tpu_torch.msm import params
from msm_blst_tpu_torch.utils import profiling

CPU = torch.device("cpu")  # the port's entry points default to the card
SHAPE = (8, 128)
STEPS = 2  # of microbench.CHAIN multiply-adds: a chain of 32


def _numpy_body(dtype: str, fused: bool):
    """The JAX kernel body on its inputs, in numpy."""
    if dtype == "float32":
        a = np.full(SHAPE, 1.0000001, np.float32)
        b = np.full(SHAPE, 0.9999999, np.float32)
    else:
        a = np.full(SHAPE, 3, dtype)
        b = np.full(SHAPE, 5, dtype)
    acc = a
    for _ in range(STEPS * microbench.CHAIN):
        if fused:
            acc = (acc.astype(np.float64) * b.astype(np.float64)
                   + a.astype(np.float64)).astype(np.float32)
        else:
            acc = acc * b + a
    return acc


@pytest.mark.parametrize("dtype", microbench.DTYPES)
def test_madd_chain_plain_matches_numpy_body(dtype):
    a, b = microbench.madd_chain_inputs(dtype, SHAPE, CPU)
    got = microbench.madd_chain(a, b, STEPS, dtype).numpy()
    if dtype == "float32":
        assert np.array_equal(got, _numpy_body(dtype, fused=True))
        np.testing.assert_allclose(got, _numpy_body(dtype, fused=False),
                                   rtol=1e-5)
    else:
        assert np.array_equal(got.view(np.dtype(dtype)),
                              _numpy_body(dtype, fused=False))
        assert got.dtype == np.int32  # the words, as K7 takes them


def test_madd_chain_plain_wraps_like_uint32():
    """Large words, where int64 products would overflow without the
    16-bit split of b."""
    rng = np.random.default_rng(7)
    a = rng.integers(0, 2 ** 32, SHAPE, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, SHAPE, dtype=np.uint64).astype(np.uint32)
    acc = a.copy()
    for _ in range(STEPS * microbench.CHAIN):
        acc = acc * b + a
    got = microbench.madd_chain_plain(torch.as_tensor(a.view(np.int32)),
                                      torch.as_tensor(b.view(np.int32)),
                                      STEPS, "uint32")
    assert np.array_equal(got.numpy().view(np.uint32), acc)


def test_gather_plain_matches_numpy_take():
    d = gather_bench.inputs(4097, 1 << 12, CPU)
    got = gather_bench.gather_smem(d["table"], d["idx"])
    want = np.take(d["table"].numpy(), d["idx"].numpy())
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(torch.take(d["table"], d["idx64"]), got)


@pytest.mark.parametrize("N", [1, 3, 1023, (1 << 14) + 3])
@pytest.mark.parametrize("T", [1, 5, 4097, 65537, gather_bench.MAX_TABLE])
def test_gather_smem_on_cpu_matches_numpy_take(T, N):
    """On CPU tensors K8's wrapper takes the plain gather: numpy's take at
    the card tests' shapes, on whole tensors and on views that start off
    16 bytes."""
    rng = np.random.default_rng(T + N)
    table = rng.integers(-(1 << 31), 1 << 31, size=T + 1,
                         dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, T, size=N + 1).astype(np.int32)
    t, i = torch.as_tensor(table), torch.as_tensor(idx)
    for tt, ii, want in ((t[:T], i[:N], table[:T][idx[:N]]),
                         (t[1:], i[1:], table[1:][idx[1:]])):
        got = gather_bench.gather_smem(tt, ii)
        assert got.dtype == torch.int32 and got.shape == (N,)
        assert np.array_equal(got.numpy(), want)


def test_gather_max_table_fits_the_cluster():
    """MAX_TABLE is the largest table whose slices the kernel's rule (CTA 0
    holds 4 * ceil(T / 8) entries, a multiple of the bulk copy's 4) fits in
    one CTA's shared memory each."""
    def slice_of(T):
        return -(-T // 8) * 4

    M = gather_bench.MAX_TABLE
    assert gather_bench.CLUSTER == 2 and M == 2 * gather_bench.SLICE_MAX
    assert slice_of(M) <= gather_bench.SLICE_MAX < slice_of(M + 1)
    assert gather_bench.SLICE_MAX % 4 == 0
    assert 4 * gather_bench.SLICE_MAX + 16 <= 232448  # 227 KB a CTA
    for T in (1, 5, 4097, 65537, M):  # the least multiple of 4 >= T / 2
        assert T <= 2 * slice_of(T) < T + 8


@pytest.mark.parametrize("algo", ["ches", "bgmw", "stock"])
def test_op_counts_match_jax(algo):
    n, cfg, jcfg = 1 << 16, params.CONFIGS[16], jparams.CONFIGS[16]
    if algo == "stock":
        got, want = profiling.stock_op_counts(n, 13), jprof.stock_op_counts(n, 13)
    else:
        got = getattr(profiling, f"{algo}_op_counts")(n, cfg)
        want = getattr(jprof, f"{algo}_op_counts")(n, jcfg)
    assert (got.accum_adds, got.integ_adds, got.doublings, got.fp_muls) == (
        want.accum_adds, want.integ_adds, want.doublings, want.fp_muls)
    for kw in ({}, {"device_muls_per_s": 1.25e11}, {"g2": True}):
        assert profiling.report("q", 0.0123, got, **kw) == jprof.report(
            "q", 0.0123, want, **kw)


def test_span_and_print_report(capsys):
    results = {}
    with profiling.span("x", results, verbose=True):
        pass
    rec = profiling.print_report("m", 0.5, profiling.OpCounts(3, 2, 1))
    out = capsys.readouterr().out
    assert "[span] x" in out and '"model_fp_muls": 65' in out
    assert results["x"] >= 0 and rec["model_fp_muls"] == 65


def test_microbench_runs_on_cpu(capsys):
    recs = microbench.run(device=CPU, quick=True)
    assert [r["metric"] for r in recs] == (
        [f"madd_chain_{d}_ops_per_s" for d in microbench.DTYPES]
        + [f"matmul_{k}_macs_per_s" for k in microbench._MATMUL]
        + ["fp_mont_mul_per_s"] * 2 + ["xyzz_dadd_affine_per_s"])
    assert all(r["device"] == "cpu" and r["value"] > 0 for r in recs)
    assert len(capsys.readouterr().out.strip().splitlines()) == len(recs)


def test_mxu_experiment_runs_on_cpu():
    recs = mxu_experiment.run(B=300, reps=1, loops=1, device=CPU)
    assert [r["variant"] for r in recs] == list(mxu_experiment.VARIANTS)


def test_gather_bench_runs_on_cpu():
    recs = gather_bench.run(4097, 1 << 12, device=CPU, reps=1)
    assert [r["row"] for r in recs] == ["t1d", "t1d_sort", "row96",
                                        "row_pair", "kern_smem"]
