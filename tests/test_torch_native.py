"""The port's native host library (msm_blst_tpu_torch/native.py over its own
copy of the C++ source, msm_blst_tpu_torch/host/recode.cpp) against its
numpy twins (msm/recode.py and msm/params.py with use_native=False) and
against the JAX package's native library (msm_blst_tpu.native, imported in
the test only), word for word:

* the build at first use into _build/, its reuse, a build by racing
  processes, and the errors of a failed build (no fallback to numpy);
* qary_digits, the CHES recode and the BGMW95 recode with and without the
  r - a fold over seeded scalars (tests/test_native.py's draw) and over
  hypothesis scalars with the edge values, and the leading-digit errors;
* the bucket set and the digit conversion table at CONFIGS[8, 16, 21];
* the port's scalars_from_ints (one bytes join) and
  check_bucket_set_validity against the JAX package's.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

from msm_blst_tpu import native as jnative
from msm_blst_tpu.msm import params as jparams
from msm_blst_tpu.msm import recode as jrecode
from msm_blst_tpu_torch import native
from msm_blst_tpu_torch.constants import R_ORDER
from msm_blst_tpu_torch.msm import params, recode

ROOT = Path(__file__).resolve().parents[1]
N = 2048
EDGES = [0, 1, 2, R_ORDER - 1, R_ORDER, R_ORDER + 1, (1 << 255) - 1]


@pytest.fixture(scope="module")
def scalars():
    return recode.random_scalars(N, seed=0xC0FFEE)


def _equal(a, b):
    return all(np.array_equal(x, y) and x.dtype == y.dtype
               for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------


def test_build_lands_in_build_dir_and_is_reused():
    so = native.build()
    assert so.parent == native.BUILD_DIR and so.exists()
    assert so.name.startswith("libmsm_host_") and so.suffix == ".so"
    mtime = so.stat().st_mtime_ns
    assert native.build() == so and so.stat().st_mtime_ns == mtime
    lib = native.load()
    assert native.load() is lib
    assert Path(lib._name) == so  # never native/libmsm_host.so


def test_library_name_follows_source_and_flags(monkeypatch):
    base = native.library_path()
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != base


_BUILD_IN = """
import sys
from pathlib import Path
from msm_blst_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
print(native.build())
"""


def test_racing_first_use_builds_once(tmp_path):
    """Four processes asking for the library at once: one compiles under
    the lock, all get the same finished file, no temporary is left."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_IN, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert len({o.strip() for o, _ in outs}) == 1
    assert sorted(f.name for f in tmp_path.iterdir()) == [
        "libmsm_host.lock", native.library_path().name]


def test_failed_build_raises_with_the_compilers_message(tmp_path,
                                                        monkeypatch):
    bad = tmp_path / "recode.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.load()
    assert not native.available()
    sc = recode.scalars_from_ints([5, 7])
    cfg = params.CONFIGS[8]
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        recode.ches_recode_host(sc, cfg.c, cfg.h, cfg.ah)  # no fallback
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        recode.bgmw_recode_host(sc, cfg.c_bgmw, cfg.h_bgmw)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        params.construct_bucket_set(1 << 5, 3)  # not cached: a new pair
    b, m, s = recode.ches_recode_host(sc, cfg.c, cfg.h, cfg.ah,
                                      use_native=False)  # asked for
    assert b.shape == (2, cfg.h)
    assert list((tmp_path / "build").glob("*.so*")) == []


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load()


# ---------------------------------------------------------------------------
# the recodes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,h", [(8, 32), (13, 20), (16, 16), (19, 14),
                                 (22, 12)])
def test_qary_digits(scalars, c, h):
    got = native.qary_digits(scalars, c, h)  # [h, n]
    assert np.array_equal(got, recode.qary_digits_host(scalars, c, h).T)
    assert np.array_equal(got, jnative.qary_digits(scalars, c, h))


@pytest.mark.parametrize("key", [8, 10, 13, 16, 21])
def test_ches_recode(scalars, key):
    cfg = params.CONFIGS[key]
    args = (scalars, cfg.c, cfg.h, cfg.ah)
    got = recode.ches_recode_host(*args)
    assert _equal(got, recode.ches_recode_host(*args, use_native=False))
    assert _equal(got, jrecode.ches_recode_host(*args, use_native=True))
    assert _equal(got, jrecode.ches_recode_host(*args, use_native=False))


@pytest.mark.parametrize("key", [10, 13, 16, 21])
def test_bgmw_recode(scalars, key):
    """The BGMW95 recode at the configs' c', h' (CONFIGS[16] and [21] are
    tight, c'h' <= 255: the r - a fold; 10 and 13 are not)."""
    cfg = params.CONFIGS[key]
    args = (scalars, cfg.c_bgmw, cfg.h_bgmw)
    got = recode.bgmw_recode_host(*args)
    assert _equal(got, recode.bgmw_recode_host(*args, use_native=False))
    assert _equal(got, jrecode.bgmw_recode_host(*args, use_native=True))
    assert _equal(got, jrecode.bgmw_recode_host(*args, use_native=False))


@pytest.mark.parametrize("fold", [False, True])
def test_native_bgmw_with_and_without_the_fold(scalars, fold):
    """native.bgmw_recode's fold switch at c = 13, h = 20 (c h = 260, where
    the recode needs no fold): without it the digits are the signed q/2
    twin's (bgmw_recode_host_nofold); with it the folded scalars' digits,
    every sign flipped, equal to JAX's native pass."""
    c, h = 13, 20
    absd, sign = native.bgmw_recode(scalars, c, h, fold)
    ja, js = jnative.bgmw_recode(scalars, c, h, fold)
    assert np.array_equal(absd, ja) and np.array_equal(sign, js)
    if not fold:
        ta, ts = recode.bgmw_recode_host_nofold(scalars, c, h)
        assert np.array_equal(absd, ta.T) and np.array_equal(sign, ts.T)
    ints = recode.scalars_to_ints(scalars)
    q = 1 << c
    for j in (0, 5, N - 1):
        val = sum((-1 if sign[k, j] else 1) * int(absd[k, j]) * q ** k
                  for k in range(h))
        assert val % R_ORDER == ints[j] % R_ORDER


@pytest.mark.parametrize("c", [4, 13, 17])
def test_booth_and_nofold_twins(scalars, c):
    h = -(-256 // c)
    got = recode.booth_recode_host(scalars, c)
    assert _equal(got, jrecode.booth_recode_host(scalars, c))
    assert _equal(got, recode.bgmw_recode_host_nofold(scalars, c, h))
    assert _equal(got, jrecode.bgmw_recode_host_nofold(scalars, c, h))


_SCALAR = st.one_of(st.sampled_from(EDGES),
                    st.integers(min_value=0, max_value=(1 << 255) - 1))


@settings(max_examples=25, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(_SCALAR, min_size=1, max_size=40))
def test_recodes_on_hypothesis_scalars(ints):
    """Scalars below 2^255 (the recodes' domain: one subtraction of r
    reduces them), the edges 0, 1, r - 1, r, r + 1 and 2^255 - 1 among the
    draws: native, numpy twin and JAX's native pass agree."""
    sc = recode.scalars_from_ints(ints)
    cfg = params.CONFIGS[16]
    ches = recode.ches_recode_host(sc, cfg.c, cfg.h, cfg.ah)
    assert _equal(ches, recode.ches_recode_host(sc, cfg.c, cfg.h, cfg.ah,
                                                use_native=False))
    assert _equal(ches, jrecode.ches_recode_host(sc, cfg.c, cfg.h, cfg.ah,
                                                 use_native=True))
    bgmw = recode.bgmw_recode_host(sc, cfg.c_bgmw, cfg.h_bgmw)
    assert _equal(bgmw, recode.bgmw_recode_host(sc, cfg.c_bgmw, cfg.h_bgmw,
                                                use_native=False))
    assert _equal(bgmw, jrecode.bgmw_recode_host(sc, cfg.c_bgmw, cfg.h_bgmw,
                                                 use_native=True))
    assert np.array_equal(native.qary_digits(sc, 19, 14),
                          recode.qary_digits_host(sc, 19, 14).T)


def test_ches_leading_carry_raises():
    """c = 8 with h = 31 windows and a top digit whose conversion is q - m b
    (alpha 1: a carry out of the top window): native and twin raise
    ValueError, as JAX's native pass does."""
    c, h, ah = 8, 31, 7
    m_t, b_t, a_t, _ = params.digit_conversion_table(1 << c, ah)
    d = int(np.nonzero(a_t[: 1 << c] == 1)[0][-1])
    sc = recode.scalars_from_ints([d << 240])
    for use_native in (None, False):
        with pytest.raises(ValueError, match="carry"):
            recode.ches_recode_host(sc, c, h, ah, use_native=use_native)
    with pytest.raises(ValueError, match="carry"):
        jnative.ches_recode(sc, c, h, m_t, b_t, a_t)


def test_bgmw_leading_digit_raises():
    """c = 8, h = 31 with no fold: a top digit of 200 > q/2 = 128."""
    sc = recode.scalars_from_ints([200 << 240])
    with pytest.raises(ValueError, match="q/2"):
        native.bgmw_recode(sc, 8, 31, False)
    with pytest.raises(ValueError, match="q/2"):
        recode.bgmw_recode_host_nofold(sc, 8, 31)
    with pytest.raises(ValueError, match="q/2"):
        jnative.bgmw_recode(sc, 8, 31, False)


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", [8, 16, 21])
def test_tables(key):
    cfg = params.CONFIGS[key]
    q, ah = cfg.q, cfg.ah
    bs = params.construct_bucket_set(q, ah)
    assert len(bs) == cfg.b_size and bs.dtype == np.int32
    assert np.array_equal(bs, params.construct_bucket_set(q, ah, False))
    assert np.array_equal(bs, jparams.construct_bucket_set(q, ah))
    got = params.digit_conversion_table(q, ah)
    assert got[3].all()
    assert _equal(got, params.digit_conversion_table(q, ah, False))
    assert _equal(got, jparams.digit_conversion_table(q, ah))
    m_t, b_t, a_t, missing = native.digit_conversion_table(q, bs)
    assert missing == 0
    assert _equal((m_t, b_t, a_t), jnative.digit_conversion_table(q, bs)[:3])


def test_check_bucket_set_validity_at_every_shipped_config():
    for cfg in params.CONFIGS.values():
        params.check_bucket_set_validity(cfg.q, cfg.ah)
        jparams.check_bucket_set_validity(cfg.q, cfg.ah)


def test_check_bucket_set_validity_raises_where_jax_raises(monkeypatch):
    """No small q/ah pair misses a digit (q = 2^2..2^9, ah < 40), so the
    gap check is the one that fires: with D_MAX_DIFF patched to 1 both
    raise on the same configs and pass on none."""
    monkeypatch.setattr(params, "D_MAX_DIFF", 1)
    monkeypatch.setattr(jparams, "D_MAX_DIFF", 1)
    for key in (8, 12, 16):
        cfg = params.CONFIGS[key]
        with pytest.raises(ValueError, match="d_MAX_DIFF=1"):
            params.check_bucket_set_validity(cfg.q, cfg.ah)
        with pytest.raises(ValueError, match="d_MAX_DIFF=1"):
            jparams.check_bucket_set_validity(cfg.q, cfg.ah)
    for c in range(2, 10):
        for ah in range(40):
            assert params.digit_conversion_table(1 << c, ah)[3].all()


# ---------------------------------------------------------------------------
# scalars_from_ints, one bytes join
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ints", [
    [], [0], [R_ORDER - 1], [(1 << 256) - 1],
    [0, 1, R_ORDER - 1, R_ORDER, (1 << 256) - 1, 1 << 255, 12345],
], ids=["n0", "zero", "r-1", "2^256-1", "edges"])
def test_scalars_from_ints_matches_jax(ints):
    got = recode.scalars_from_ints(ints)
    want = jrecode.scalars_from_ints(ints)
    assert got.shape == want.shape == (8, len(ints))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.flags["C_CONTIGUOUS"] and got.flags["WRITEABLE"]
    assert recode.scalars_to_ints(got) == ints


def test_scalars_from_ints_seeded_and_out_of_range():
    ints = jrecode.scalars_to_ints(jrecode.random_scalars(300, seed=9))
    assert np.array_equal(recode.scalars_from_ints(ints),
                          jrecode.scalars_from_ints(ints))
    assert np.array_equal(recode.random_scalars(300, 9),
                          jrecode.random_scalars(300, 9))
    for bad in (-1, 1 << 256):
        with pytest.raises(OverflowError):
            recode.scalars_from_ints([bad])
