"""The port's Fp arithmetic against the JAX package's, bit for bit.

Inputs are made from numpy seeds and include the SKILL probes 0, 1, p-1 and
the non-canonical p (which from_ints must reduce to 0). The JAX functions
run jitted on their CPU path; the port's run on CPU tensors, where the
multiply takes its plain version (fields/cuda_mont.py). Field values are
canonical on both sides, so words compare exactly through convert.py.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.fields import FP as JFP
from msm_blst_tpu.fields.limb import resolve_limbs as j_resolve_limbs
from msm_blst_tpu_torch.convert import fp_from_jax, fp_to_jax
from msm_blst_tpu_torch.fields import FP
from msm_blst_tpu_torch.fields import cuda_mont
from msm_blst_tpu_torch.fields.limb import (ints_to_array, resolve_limbs,
                                            words_to_limbs)

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

P = JFP.modulus
CSRC = Path(__file__).resolve().parents[1] / "msm_blst_tpu_torch" / "csrc"


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    xs = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]
    xs[:4] = [0, 1, P - 1, P]  # P is non-canonical: from_ints reduces it
    return xs


def _pair(xs):
    """The same Montgomery batch on both sides: (jax uint32[24, B], port)."""
    return JFP.from_ints(xs), FP.from_ints(xs, device=CPU)


def test_converters_roundtrip():
    xs = _ints(33, 1)
    for mont in (True, False):
        j = np.asarray(JFP.from_ints(xs, mont=mont))
        t = FP.from_ints(xs, mont=mont, device=CPU)
        assert torch.equal(fp_from_jax(j, CPU), t)
        assert np.array_equal(fp_to_jax(t), j)
    assert FP.to_ints(FP.from_ints(xs, device=CPU)) == [x % P for x in xs]


def test_from_ints_canonicalizes_p():
    assert torch.equal(FP.from_ints([P], device=CPU), FP.zeros((1,)))
    assert FP.to_ints(FP.from_ints([P, P + 5], device=CPU)) == [0, 5]


@pytest.mark.parametrize("op", ["add", "sub", "neg", "mul", "double", "mul3"])
def test_field_op_matches_jax(op):
    ja, ta = _pair(_ints(40, 2))
    jb, tb = _pair(_ints(40, 3)[::-1])
    if op in ("neg", "double", "mul3"):
        want = jax.jit(getattr(JFP, op))(ja)
        got = getattr(FP, op)(ta)
    else:
        want = jax.jit(getattr(JFP, op))(ja, jb)
        got = getattr(FP, op)(ta, tb)
    assert np.array_equal(fp_to_jax(got), np.asarray(want))


def test_mul_matches_montgomery_oracle():
    xs, ys = _ints(64, 4), _ints(64, 5)[::-1]
    a = FP.from_ints(xs, mont=False, device=CPU)
    b = FP.from_ints(ys, mont=False, device=CPU)
    r_inv = pow(1 << 384, -1, P)
    got = FP.to_ints(cuda_mont.mont_mul_plain(a, b, FP), mont=False)
    assert got == [x % P * (y % P) * r_inv % P for x, y in zip(xs, ys)]


def test_inv_and_batch_inv_match_jax():
    ja, ta = _pair(_ints(24, 6))  # lanes 0 and 3 are zero: inverse 0
    assert np.array_equal(fp_to_jax(FP.inv(ta)),
                          np.asarray(jax.jit(JFP.inv)(ja)))
    assert np.array_equal(fp_to_jax(FP.batch_inv(ta)),
                          np.asarray(jax.jit(JFP.batch_inv)(ja)))
    vals = FP.to_ints(FP.batch_inv(ta))
    assert [v * x % P for v, x in zip(vals, _ints(24, 6))][4:] == [1] * 20


def test_resolve_limbs_matches_jax():
    rng = np.random.default_rng(7)
    s = rng.integers(0, 2 ** 32, size=(24, 50), dtype=np.uint64)
    s[23] >>= 17  # value fits 25 limbs
    want = np.asarray(jax.jit(j_resolve_limbs)(jnp.asarray(s.astype(np.uint32))))
    got = resolve_limbs(torch.as_tensor(s.astype(np.int64)), bits=32)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_word_and_limb_layouts_agree():
    xs = [x % P for x in _ints(10, 8)]
    limbs = words_to_limbs(torch.as_tensor(ints_to_array(xs, 12)))
    j = np.asarray(JFP.from_ints(xs, mont=False))
    assert np.array_equal(limbs.numpy(), j.astype(np.int64))


def test_constants_match_jax():
    from msm_blst_tpu import constants as jc
    from msm_blst_tpu_torch import constants as tc

    for name in ("P", "R_ORDER", "B_G1", "G1_X", "G1_Y"):
        assert getattr(tc, name) == getattr(jc, name), name


@pytest.mark.parametrize("case", ["add", "double", "cancel", "inf", "mult"])
def test_host_oracle_matches_jax(case):
    """msm_blst_tpu_torch.refimpl.G1 (affine ints) against the JAX package's
    Jacobian oracle G1_REF, in affine."""
    from msm_blst_tpu.refimpl import G1_REF
    from msm_blst_tpu_torch.refimpl import G1 as ref

    def jref(k):
        x, y = G1_REF.to_affine(G1_REF.jac_mult(k, G1_REF.generator_jac()))
        return x.v, y.v

    rng = np.random.default_rng(10)
    k1, k2 = (int.from_bytes(rng.bytes(32), "little") for _ in range(2))
    p1, p2 = ref.mult(k1), ref.mult(k2)
    assert ref.is_on_curve(p1) and p1 == jref(k1)
    got, want = {
        "add": (ref.add(p1, p2), jref(k1 + k2)),
        "double": (ref.add(p1, p1), jref(2 * k1)),
        "cancel": (ref.add(p1, (p1[0], -p1[1] % P)), ref.INF),
        "inf": (ref.add(ref.INF, p2), p2),
        "mult": (ref.mult(0), jref(0)),
    }[case]
    assert got == want


def _header_switch(text, fn):
    body = re.search(fn + r"\(int i\) \{(.*?default: return 0x[0-9a-f]+u;)",
                     text, re.S).group(1)
    return [int(v, 16) for v in re.findall(r"return (0x[0-9a-f]+)u;", body)]


def test_cuda_header_constants():
    """The constants written into csrc/fp.cuh's Modulus<12> are p, R mod p
    and -p^-1 mod 2^32."""
    text = (CSRC / "fp.cuh").read_text()
    words = lambda x: [(x >> (32 * i)) & 0xFFFFFFFF for i in range(12)]  # noqa: E731
    assert _header_switch(text, "word") == words(P)
    assert _header_switch(text, "one_mont") == words((1 << 384) % P)
    n0 = int(re.search(r"n0 = (0x[0-9a-f]+)u;", text).group(1), 16)
    assert n0 == (-pow(P, -1, 1 << 32)) % (1 << 32)
