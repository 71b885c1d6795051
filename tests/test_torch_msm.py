"""The port's host tables, device recode and CHES query against the JAX
package, the pure-integer oracle and the reference binary's golden vectors.

* params: every table the port's numpy copy builds equals the JAX module's.
* recode: the host scalar helpers and the device recode (edge scalars 0, 1,
  r-1, r, r+1, 2^255-1 included) equal JAX's, word for word.
* msm_ches_device at n=16 (test_e2e_fast.py's scalars: 0, r-1 and a repeated
  scalar), n=64 and n=128 (the G1 golden cases with n <= 128) with c=8,
  h=32: the affine result equals the oracle (sum s_i 2^(i+1) mod r) * G and
  serializes to the golden bytes. tests/test_torch_e2e.py holds the same
  query against JAX's msm_ches_device itself.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.constants import R_ORDER
from msm_blst_tpu.curves import serialize
from msm_blst_tpu.msm import params as jparams
from msm_blst_tpu.msm import recode as jrecode
from msm_blst_tpu.refimpl import G1_REF
from msm_blst_tpu_torch.curves import G1
from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list,
                                    msm_ches_device, params, recode)

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures",
                        "golden_msm.json")
SMALL = dict(c=8, h=32, c_bgmw=8, h_bgmw=32)


def _configs():
    return [params.make_config(4, **SMALL), params.CONFIGS[16]]


@pytest.mark.parametrize(
    "cfg", _configs() + [params.CONFIGS[8], params.CONFIGS[13]],
    ids=["c8h32", "n16", "n8", "n13"])
def test_params_tables_match_jax(cfg):
    q, ah = cfg.q, cfg.ah
    assert np.array_equal(params.construct_bucket_set(q, ah),
                          jparams.construct_bucket_set(q, ah))
    for a, b in zip(params.digit_conversion_table(q, ah),
                    jparams.digit_conversion_table(q, ah)):
        assert np.array_equal(a, b)
    for name in ("packed_digit_table", "packed_digit_table_pairs",
                 "bucket_value_to_index"):
        assert np.array_equal(getattr(params, name)(q, ah),
                              getattr(jparams, name)(q, ah)), name


def test_configs_match_jax():
    assert ({k: dataclasses.astuple(v) for k, v in params.CONFIGS.items()}
            == {k: dataclasses.astuple(v) for k, v in jparams.CONFIGS.items()})
    assert (dataclasses.astuple(params.make_config(6, **SMALL))
            == dataclasses.astuple(jparams.make_config(6, **SMALL)))


def test_host_scalar_helpers_match_jax():
    a = recode.random_scalars(40, seed=3)
    assert np.array_equal(a, jrecode.random_scalars(40, seed=3))
    ints = recode.scalars_to_ints(a)
    assert ints == jrecode.scalars_to_ints(a)
    assert np.array_equal(recode.scalars_from_ints(ints),
                          jrecode.scalars_from_ints(ints))


EDGES = [0, 1, R_ORDER - 1, R_ORDER, R_ORDER + 1, (1 << 255) - 1]


@pytest.mark.parametrize("cfg", _configs(), ids=["c8h32", "n16"])
def test_recode_matches_jax(cfg):
    ints = recode.scalars_to_ints(recode.random_scalars(58, seed=9)) + EDGES
    host = recode.scalars_from_ints(ints)
    table = params.packed_digit_table_pairs(cfg.q, cfg.ah)
    t = recode.to_device(host, CPU)
    got = recode.ches_recode_device_packed(t, cfg.c, cfg.h,
                                           torch.as_tensor(table))
    want = jax.jit(lambda s, tb: jrecode.ches_recode_device_packed(
        s, cfg.c, cfg.h, tb))(jnp.asarray(host), jnp.asarray(table))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    red = recode.reduce_mod_r_device(t)
    assert np.array_equal(red.numpy().view(np.uint32),
                          np.asarray(jrecode.reduce_mod_r_device(
                              jnp.asarray(host))))
    assert np.array_equal(
        recode.qary_digits_device(red, cfg.c, cfg.h).numpy(),
        np.asarray(jrecode.qary_digits_device(jnp.asarray(
            np.asarray(red.numpy()).view(np.uint32)), cfg.c, cfg.h)))


def _oracle(ints):
    total = sum(s * pow(2, i + 1, R_ORDER) for i, s in enumerate(ints)) % R_ORDER
    x, y = G1_REF.to_affine(G1_REF.jac_mult(total, G1_REF.generator_jac()))
    return (x.v, y.v)


def _cases():
    with open(FIXTURES) as f:
        golden = [c for c in json.load(f) if c["group"] == 1 and c["n"] <= 128]
    return [{"n": 16, "seed": 51, "serialized": None}] + golden


@pytest.mark.parametrize("case", _cases(), ids=lambda c: f"n{c['n']}")
def test_msm_matches_oracle_and_golden(case):
    n = case["n"]
    ints = recode.scalars_to_ints(recode.random_scalars(n, seed=case["seed"]))
    if case["serialized"] is None:   # test_e2e_fast.py's adversarial edges
        ints[0], ints[1] = 0, R_ORDER - 1
        ints[2] = ints[3]
    cfg = params.make_config(max(n.bit_length() - 1, 1), **SMALL)
    plan = build_plan(G1, fixed_point_list(G1, n, device=CPU), cfg)
    jac = msm_ches_device(plan, recode.to_device(
        recode.scalars_from_ints(ints), CPU))
    aff = G1.affine_to_ints(G1.jac_to_affine(jac))[0]
    assert aff == _oracle(ints)
    if case["serialized"] is not None:
        assert serialize.g1_serialize(aff).hex() == case["serialized"]
