"""The field operations the device maps add to the port, against the JAX
package's, word for word, and the port's copy of utils/exports.py against
JAX's.

* Fp `eq`, `to_mont`, `from_mont` (each one product by a constant) and
  `is_square` (Euler's criterion, 0 and a non-residue among the inputs).
* Fp2 `pow_int` at the exponents the square root runs — 0, 1, (p-3)/4 and
  (p-1)/2 — on random values, 0, 1 and -1. JAX squares and selects a
  product on every bit, the port multiplies only on set bits: the words
  are equal all the same.
* Every converter of utils/exports.py, and the device batch ingest on CPU
  tensors.

The JAX functions run jitted on their CPU path, the port's on CPU tensors
(the plain twin of K1).
"""

import jax
import numpy as np
import pytest
import torch

from msm_blst_tpu.fields.fp2 import FP2 as JFP2
from msm_blst_tpu.fields.limb import FP as JFP
from msm_blst_tpu.utils import exports as jex
from msm_blst_tpu_torch.constants import P, R_ORDER
from msm_blst_tpu_torch.convert import (fp2_from_jax, fp2_to_jax, fp_from_jax,
                                        fp_to_jax)
from msm_blst_tpu_torch.fields import FP, FP2
from msm_blst_tpu_torch.utils import exports as ex

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

NON_RESIDUE = P - 1  # p = 3 mod 4: -1 is not a square


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    xs = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]
    xs[:4] = [0, 1, NON_RESIDUE, 4]
    return xs


def _port(xs, mont=True):
    return FP.from_ints(xs, mont=mont, device=CPU)


def _jax(xs, mont=True):
    return JFP.from_ints(xs, mont=mont)


def test_eq():
    xs = _ints(8, 1)
    ys = list(xs)
    ys[5] = (ys[5] + 1) % P
    ys[6] = (ys[6] + (1 << 300)) % P  # differs in a high word only
    want = np.asarray(jax.jit(JFP.eq)(_jax(xs), _jax(ys)))
    got = FP.eq(_port(xs), _port(ys))
    assert got.tolist() == want.tolist()
    assert got.tolist() == [x == y for x, y in zip(xs, ys)]


@pytest.mark.parametrize("fn", ["to_mont", "from_mont"])
def test_mont_conversions(fn):
    xs = _ints(8, 2) + [P - 2]
    want = fp_from_jax(np.asarray(jax.jit(getattr(JFP, fn))(
        _jax(xs, mont=False))), device=CPU)
    got = getattr(FP, fn)(_port(xs, mont=False))
    assert torch.equal(got, want)
    if fn == "to_mont":
        assert FP.to_ints(got) == xs
    else:
        assert FP.to_ints(got, mont=False) == [x * pow(FP.R, -1, P) % P
                                               for x in xs]


def test_from_mont_undoes_to_mont_over_a_2d_batch():
    xs = _ints(6, 3)
    a = _port(xs, mont=False).reshape(12, 2, 3)
    assert torch.equal(FP.from_mont(FP.to_mont(a)), a)


def test_is_square():
    xs = _ints(10, 4)
    want = np.asarray(jax.jit(JFP.is_square)(_jax(xs)))
    got = FP.is_square(_port(xs))
    assert got.tolist() == want.tolist()
    assert got.tolist() == [x == 0 or pow(x, (P - 1) // 2, P) == 1
                            for x in xs]
    assert got[:4].tolist() == [True, True, False, True]  # 0, 1, -1, 4


@pytest.mark.parametrize("e", [0, 1, (P - 3) // 4, (P - 1) // 2],
                         ids=["0", "1", "(p-3)/4", "(p-1)/2"])
def test_fp2_pow_int(e):
    rng = np.random.default_rng(5)
    pairs = [(0, 0), (1, 0), (P - 1, 0), (0, 1)] + [
        tuple(int.from_bytes(rng.bytes(48), "little") % P for _ in range(2))
        for _ in range(3)]
    a_j = JFP2.from_int_pairs(pairs)
    want = np.asarray(jax.jit(lambda a: JFP2.pow_int(a, e))(a_j))
    a = fp2_from_jax(np.asarray(a_j), device=CPU)
    got = FP2.pow_int(a, e)
    assert np.array_equal(fp2_to_jax(got), want)
    assert torch.equal(got, fp2_from_jax(want, device=CPU))


# ---- utils/exports.py ---------------------------------------------------------


def _scalar_bytes(seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.bytes(32) for _ in range(n)] + [bytes(32), b"\xff" * 32]


@pytest.mark.parametrize("name", [
    "scalar_from_bendian", "scalar_from_lendian", "fp_from_bendian",
    "fp_from_lendian"])
def test_exports_from_bytes(name):
    size = 48 if name.startswith("fp") else 32
    rng = np.random.default_rng(6)
    cases = [rng.bytes(size) for _ in range(4)] + [bytes(size)]
    if size == 48:  # canonical inputs, and p itself (rejected)
        cases = [ex.fp_to_bendian(int.from_bytes(b, "big") % P)
                 for b in cases]
        order = "little" if name.endswith("lendian") else "big"
        cases = [int.from_bytes(b, "big").to_bytes(48, order) for b in cases]
        cases.append(P.to_bytes(48, order))
    for b in cases + [bytes(size - 1)]:
        outs = []
        for mod in (ex, jex):
            try:
                outs.append(getattr(mod, name)(b))
            except ValueError as err:
                outs.append(("ValueError", str(err)))
        assert outs[0] == outs[1], b.hex()


@pytest.mark.parametrize("name", [
    "scalar_to_bendian", "scalar_to_lendian", "scalar_to_uint32",
    "scalar_to_uint64", "fr_from_scalar", "fp_to_bendian", "fp_to_lendian",
    "scalar_fr_check", "sk_check"])
def test_exports_from_ints(name):
    rng = np.random.default_rng(7)
    xs = [0, 1, R_ORDER - 1, R_ORDER, (1 << 256) - 1, P - 1, P] + [
        int.from_bytes(rng.bytes(32), "big") for _ in range(4)]
    for x in xs:
        assert getattr(ex, name)(x) == getattr(jex, name)(x), (name, x)


def test_exports_word_round_trips():
    rng = np.random.default_rng(8)
    xs = [0, (1 << 256) - 1] + [int.from_bytes(rng.bytes(32), "big")
                                for _ in range(4)]
    for x in xs:
        w32, w64 = ex.scalar_to_uint32(x), ex.scalar_to_uint64(x)
        assert ex.scalar_from_uint32(w32) == jex.scalar_from_uint32(w32) == x
        assert ex.scalar_from_uint64(w64) == jex.scalar_from_uint64(w64) == x
        assert ex.scalar_from_hex(hex(x)) == jex.scalar_from_hex(hex(x)) == x
    for mod in (ex, jex):
        with pytest.raises(ValueError):
            mod.scalar_from_uint32([1] * 7)
        with pytest.raises(ValueError):
            mod.scalar_from_uint64([1] * 5)


def test_exports_batches():
    bs = _scalar_bytes(9)
    got = ex.scalars_from_bendian_batch(bs)
    want = jex.scalars_from_bendian_batch(bs)
    assert got.dtype == np.uint32 and np.array_equal(got, np.asarray(want))
    assert ex.scalars_to_bendian_batch(got) == jex.scalars_to_bendian_batch(
        want) == bs
    xs = _ints(6, 10)
    for mont in (True, False):
        dev = ex.fp_batch_to_device(xs, mont=mont, device=CPU)
        assert dev.device == CPU and dev.dtype == torch.int32
        assert np.array_equal(fp_to_jax(dev), np.asarray(
            jex.fp_batch_to_device(xs, mont=mont)))
        assert ex.fp_batch_from_device(dev, mont=mont) == xs
