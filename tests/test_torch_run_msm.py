"""The port's MSM harness, drivers/run_msm.py, end to end on the CPU at the
tiny config (n = 64, c = 8, h = 32; BGMW aliased into the 3nh table),
run once through main() as `python -m msm_blst_tpu_torch.drivers.run_msm
--config tiny --device cpu --reps 1 --oracle --json` runs it:

* it times the five methods of the JAX driver, in its order, and their
  results agree (a disagreement exits 1) and equal the oracle;
* its last line is the JSON record with the JAX driver's keys (n, group,
  means_us, conversion_us), and main() returns the same record;
* `around(name)` is entered around each method's warm-up and timed loop.

The stock method dominates the time here (64 windows of 4 bits, each a
bucket pass of plain point adds): about 40 s alone.
"""

import contextlib
import io
import json

import pytest
import torch

from msm_blst_tpu_torch.drivers import run_msm

torch.set_num_threads(1)  # small tensors: threads add contention, not speed

JAX_METHODS = ["CHES q/5 (host conversion)",
               "CHES q/5 (integral device conversion)",
               "CHES q/5 noindexhash", "BGMW95 q/2",
               "stock Pippenger (no precompute)"]


@pytest.fixture(scope="module")
def run():
    """(stdout lines, returned record, methods entered by `around`)."""
    entered = []

    @contextlib.contextmanager
    def around(name):
        entered.append(name)
        yield

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        record = run_msm.main(["--config", "tiny", "--device", "cpu",
                               "--reps", "1", "--oracle", "--json"], around)
    return out.getvalue().splitlines(), record, entered


def test_methods_in_the_jax_drivers_order(run):
    assert [name for name, _ in run_msm.METHODS] == JAX_METHODS


@pytest.mark.parametrize("name", JAX_METHODS)
def test_each_method_timed(run, name):
    lines, record, entered = run
    assert record["means_us"][name] > 0
    assert entered.count(name) == 2  # its warm-up and its timed loop
    assert any(line.startswith(name) and line.endswith("us/query")
               for line in lines)


def test_methods_agree_with_the_oracle(run):
    lines, _, _ = run
    assert "# set 0: oracle check OK" in lines
    assert any(line.startswith("# result x = 0x") and "(all methods agree)"
               in line for line in lines)
    assert not any("MISMATCH" in line for line in lines)


def test_json_line_has_the_jax_keys(run):
    lines, record, _ = run
    last = json.loads(lines[-1])
    assert set(last) == {"n", "group", "means_us", "conversion_us"}
    assert last == record
    assert (last["n"], last["group"]) == (64, 1)
    assert list(last["means_us"]) == JAX_METHODS
    assert last["conversion_us"] > 0


@pytest.mark.parametrize("name, n", [("tiny", 64), ("16", 1 << 16),
                                     ("16b", 1 << 16), ("21", 1 << 21)])
def test_config_names(name, n):
    cfg, got_n = run_msm.config_of(name)
    assert got_n == n and cfg.n_exp == n.bit_length() - 1
