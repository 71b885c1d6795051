"""The port's SOS multiply (fields/sos.py) against the JAX package's, word
for word (no tolerance: every value is a canonical residue or an integer
mod R).

* The port's copy of build_sos_consts equals pallas_mont.build_sos_consts.
* The plain SOS multiply equals a jit of JAX's _mont_mul_body_sos and
  make_mont_mul(impl="sos") in interpret mode (as tests/test_pallas.py
  runs it), through convert.fp_to_jax / fp_from_jax.
* Each plain stage of drivers/mxu_experiment.py equals the integer mod R
  that JAX's composition of _full_product, _bytes3 and _dotf gives (the
  driver's bodies are closures inside its main() and cannot be imported).
* K6's constant operand is the byte Toeplitz of P' and p, and a field with
  mul_impl="sos" multiplies as FP does.

Inputs: 300 values from a numpy seed, with 0, 1 and p-1 among them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.constants import P, R_ORDER
from msm_blst_tpu.fields import pallas_mont as pm
from msm_blst_tpu.fields.limb import FP as JFP
from msm_blst_tpu_torch.convert import fp_from_jax, fp_to_jax
from msm_blst_tpu_torch.fields import FP, LimbField, fp_for, sos
from msm_blst_tpu_torch.fields.limb import array_to_ints

CPU = torch.device("cpu")  # the port's entry points default to the card
L = 24
R = 1 << 384
B = 300


@pytest.fixture(scope="module")
def operands():
    """(JAX uint32[24, B] limbs, port int32[12, B] words) for a and b."""
    rng = np.random.default_rng(44)
    xs = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(B)]
    ys = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(B)]
    xs[:4] = [0, 1, P - 1, P - 1]
    ys[:4] = [P - 1, P - 1, P - 1, 1]
    ja, jb = JFP.from_ints(xs), JFP.from_ints(ys)
    return (np.asarray(ja), np.asarray(jb),
            fp_from_jax(np.asarray(ja), CPU), fp_from_jax(np.asarray(jb), CPU))


def _limb_ints(rows) -> list:
    """uint32[K, B] rows of any size -> [sum_k rows[k] 2^(16k) mod R]."""
    rows = np.asarray(rows).astype(object)
    return [sum(int(v) << (16 * k) for k, v in enumerate(rows[:, j])) % R
            for j in range(rows.shape[1])]


@pytest.mark.parametrize("L_, mod", [(24, P), (16, R_ORDER)], ids=["fp", "fr"])
def test_build_sos_consts_matches_jax(L_, mod):
    got = sos.build_sos_consts(L_, mod)
    want = pm.build_sos_consts(L_, mod)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k


def test_kernel_consts_are_the_byte_toeplitz():
    pp = (-pow(P, -1, R)) % R
    ppb = [(pp >> (8 * i)) & 0xFF for i in range(48)]
    pb = [(P >> (8 * i)) & 0xFF for i in range(48)]
    want = np.zeros((144, 64), dtype=np.uint8)
    for r in range(48):
        for k in range(r + 1):
            want[r, k] = ppb[r - k]
    for r in range(96):
        for k in range(max(0, r - 47), min(r, 47) + 1):
            want[48 + r, k] = pb[r - k]
    assert np.array_equal(sos.kernel_consts(P), want)


def test_plain_sos_matches_jax_body(operands):
    ja, jb, ta, tb = operands
    c = pm.build_sos_consts(L, P)
    not_p = np.array([((R - P) >> (16 * i)) & 0xFFFF for i in range(L)],
                     np.uint32).reshape(L, 1)
    body = jax.jit(lambda a, b: pm._mont_mul_body_sos(
        a, b, L, *(jnp.asarray(c[k]).astype(jnp.bfloat16)
                   for k in pm.SOS_CONST_NAMES), jnp.asarray(not_p)))
    want = np.asarray(body(jnp.asarray(ja), jnp.asarray(jb)))
    got = sos.sos_mul_plain(ta, tb, FP)
    assert np.array_equal(fp_to_jax(got), want)
    assert torch.equal(fp_from_jax(want, CPU), got)


def test_plain_sos_matches_jax_kernel_interpret(operands):
    from jax.experimental.pallas import tpu as pltpu

    ja, jb, ta, tb = operands
    mul = pm.make_mont_mul(L, int(JFP.p0), P, block_b=128, impl="sos")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(mul(jnp.asarray(ja), jnp.asarray(jb)))
    assert np.array_equal(fp_to_jax(sos.sos_mul_plain(ta, tb, FP)), want)


def _jax_stages(ja, jb) -> dict:
    """The staged bodies of drivers/mxu_experiment.py, composed from
    pallas_mont's parts: each stage's integer mod R."""
    c = pm.build_sos_consts(L, P)
    bf = jnp.bfloat16
    w1e, w1o = (jnp.asarray(c[k]).astype(bf) for k in ("W1E", "W1O"))

    @jax.jit
    def stages(a, b):
        U = pm._full_product(a, b, L)
        ub = pm._bytes3(U[:L])
        ml = pm._f32_to_u32(pm._dotf(w1e, ub)) + (
            pm._f32_to_u32(pm._dotf(w1o, ub)) << 8)
        return U[:L], pm._f32_to_u32(ub.astype(jnp.float32)), ml

    prod, planes, ml = (np.asarray(x) for x in stages(jnp.asarray(ja),
                                                       jnp.asarray(jb)))
    planes = planes.astype(object)
    bytes_rows = planes[:L] + (planes[L:2 * L] << 8) + (planes[2 * L:] << 16)
    return {"prod": _limb_ints(prod), "bytes": _limb_ints(bytes_rows),
            "mm1": _limb_ints(ml)}


@pytest.mark.parametrize("stage", ["prod", "bytes", "mm1", "full"])
def test_plain_stages_match_jax(operands, stage):
    ja, jb, ta, tb = operands
    got = array_to_ints(sos.sos_stage_plain(ta, tb, FP, stage))
    if stage == "full":  # the Montgomery product of the residues
        r_inv = pow(R, -1, P)
        want = [x * y * r_inv % P
                for x, y in zip(_limb_ints(ja), _limb_ints(jb))]
    else:
        want = _jax_stages(ja, jb)[stage]
    assert got == want


def test_sos_field_multiplies_as_fp(operands):
    _, _, ta, tb = operands
    F = fp_for("sos")
    assert F.mul_impl == "sos" and F.plain.mul_impl == "sos"
    assert fp_for("cios") is FP
    assert torch.equal(F.mul(ta, tb), FP.mul(ta, tb))
    assert torch.equal(F.sqr(ta), FP.sqr(ta))
    # the scalar field takes the same plain path at 16 limbs
    Fr, Fr_cios = LimbField(R_ORDER, mul_impl="sos"), LimbField(R_ORDER)
    x, y = ta[:8, :8] & 0x7FFFFFF, tb[:8, :8] & 0x7FFFFFF  # below r
    assert torch.equal(Fr.mul(x, y), Fr_cios.mul(x, y))
    with pytest.raises(ValueError):
        LimbField(P, mul_impl="montgomery")
    with pytest.raises(ValueError):
        sos.sos_stage_plain(ta, tb, FP, "mm2")
