"""The port's stage profilers and its flagship entry on the CPU at the tiny
config (n = 64, c = 8, h = 32).

* drivers/profile_stages.py: the six cumulative prefixes of
  msm_ches_device, each timed, in one JSON line; the full prefix returns
  the query's point.
* drivers/bign_profile.py, CHES and BGMW95: the four cumulative prefixes
  of msm_bign, in one JSON line.
* entry.entry(device="cpu"): its example scalars are the JAX entry's
  (random_scalars(64, seed=7)) word for word, and fn(*example_args)
  equals the oracle (sum s_i 2^(i+1) mod r) * G.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from msm_blst_tpu.msm import recode as jrecode
from msm_blst_tpu_torch import refimpl
from msm_blst_tpu_torch.constants import R_ORDER
from msm_blst_tpu_torch.curves import G1
from msm_blst_tpu_torch.drivers import bign_profile, profile_stages
from msm_blst_tpu_torch.entry import entry
from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list,
                                    msm_ches_device, params, recode)

torch.set_num_threads(1)  # small tensors: threads add contention, not speed

STAGES = ["recode", "sort", "gather", "prefix-scan", "buckets",
          "integrate+full"]
BIGN_STAGES = ["recode", "recode+sort", "recode+sort+starts", "full query"]


def _quiet(fn, argv):
    """fn(argv) with its stdout captured: (record, the stdout lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        record = fn(argv)
    return record, out.getvalue().splitlines()


def _oracle(ints):
    total = sum(s * pow(2, i + 1, R_ORDER) for i, s in enumerate(ints)) % R_ORDER
    return refimpl.G1.mult(total)


def test_profile_stages_end_to_end():
    record, lines = _quiet(profile_stages.main, [
        "--config", "tiny", "--device", "cpu", "--reps", "1", "--loops", "1"])
    assert json.loads(lines[-1]) == record
    assert (record["n"], record["c"], record["h"]) == (64, 8, 32)
    assert list(record["stages"]) == STAGES
    cum = [s["cum_ms"] for s in record["stages"].values()]
    assert all(t > 0 for t in cum)
    deltas = [s["delta_ms"] for s in record["stages"].values()]
    assert np.allclose(np.cumsum(deltas), cum)


@pytest.mark.parametrize("algo", ["ches", "bgmw"])
def test_bign_profile_end_to_end(algo):
    record, lines = _quiet(bign_profile.main, [
        "--config", "tiny", "--algo", algo, "--device", "cpu", "--reps", "1",
        "--loops", "1"])
    assert json.loads(lines[-1]) == record
    assert (record["n"], record["algo"]) == (64, algo)
    assert list(record["stages"]) == BIGN_STAGES
    assert all(s["cum_ms"] > 0 for s in record["stages"].values())


def test_profile_stages_full_prefix_is_the_query():
    cfg = params.make_config(4, c=8, h=32, c_bgmw=8, h_bgmw=32)
    plan = build_plan(G1, fixed_point_list(G1, 16, device="cpu"), cfg,
                      bgmw=False, stock=False)
    sc = recode.to_device(recode.random_scalars(16, seed=3), "cpu")
    full = dict(profile_stages.stages(plan))["integrate+full"](sc)
    want = msm_ches_device(plan, sc)
    assert all(torch.equal(a, b) for a, b in zip(full, want))


def test_entry_on_the_cpu():
    fn, args = entry(device="cpu")
    (scalars,) = args
    want = jrecode.random_scalars(64, seed=7)
    assert np.array_equal(scalars.numpy().view(np.uint32), want)
    out = fn(*args)
    assert G1.affine_to_ints(G1.jac_to_affine(out))[0] == _oracle(
        recode.scalars_to_ints(want))
