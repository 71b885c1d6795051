"""The port's hash_to_g1_device, cleared G1 map and G2 map against the JAX
package's traced device functions, word for word, on CPU tensors (the
plain twins of K1 and K2). JAX's traces of these take 45-60 s each on a
CPU core, so the file is `slow`; tier 1 holds the same functions against
JAX's host maps (tests/test_torch_device_map.py) and the uncleared G1 map
against its trace (tests/test_torch_device_map_jax.py).
"""

import random

import jax
import numpy as np
import pytest
import torch

from msm_blst_tpu.fields.fp2 import FP2 as JFP2
from msm_blst_tpu.fields.limb import FP as JFP
from msm_blst_tpu.protocol import device_map as jdm
from msm_blst_tpu_torch.constants import P
from msm_blst_tpu_torch.convert import fp2_from_jax, fp_from_jax
from msm_blst_tpu_torch.protocol import device_map as dm

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

pytestmark = pytest.mark.slow

rng = random.Random(0x510)


def _same(got, want, from_jax):
    for g, w in zip(got, want):
        assert torch.equal(g, from_jax(np.asarray(w), device=CPU))


def test_hash_to_g1_device_words_equal_jax():
    msgs = [b"", b"abc", b"batched hash to curve", bytes(range(64))]
    _same(dm.hash_to_g1_device(msgs, device=CPU),
          jdm.hash_to_g1_device(msgs), fp_from_jax)


def test_hash_to_g1_body_words_equal_jax_on_doubling_and_cancelling():
    u, v = rng.randrange(P), rng.randrange(P)
    us = [u, u, v, P - v, 0, 0]
    u_j = JFP.from_ints(us)
    _same(dm._run_hash_to_g1(fp_from_jax(np.asarray(u_j), device=CPU)),
          jdm._run_hash_to_g1(u_j), fp_from_jax)


def test_cleared_g1_map_words_equal_jax_trace():
    us = [0, 1, P - 1] + [rng.randrange(P) for _ in range(3)]
    u_j = JFP.from_ints(us)
    want = jax.jit(lambda u: jdm.map_to_g1_device(u, clear_cofactor=True))(
        u_j)
    _same(dm.map_to_g1_device(fp_from_jax(np.asarray(u_j), device=CPU),
                              device=CPU), want, fp_from_jax)


def test_g2_map_words_equal_jax_trace():
    us = [(0, 0), (0, 5), (7, 0)] + [(rng.randrange(P), rng.randrange(P))
                                     for _ in range(3)]
    u_j = JFP2.from_int_pairs(us)
    want = jax.jit(jdm.map_to_g2_device)(u_j)
    _same(dm.map_to_g2_device(fp2_from_jax(np.asarray(u_j), device=CPU),
                              device=CPU), want, fp2_from_jax)
