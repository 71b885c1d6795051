"""The port stands apart from JAX and from the JAX package, its entry
points (the measurement drivers among them) refuse to run without a card
unless the caller asks for the CPU, and its chip smoke refuses to run
without a card or without the repository. Its kernel table binds C entry
points that its CUDA sources define.

The import checks run in subprocesses, so this test process's own imports
(pytest's conftest imports jax) do not count.
"""

import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from msm_blst_tpu_torch import kernels

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import msm_blst_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for root in ("jax", "msm_blst_tpu"):
    found = sorted(m for m in sys.modules if m == root or m.startswith(root + "."))
    assert not found, found
print(len(names))
"""


def test_port_modules_never_import_jax():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 51  # every module of the package


def _refuses_without_a_card(curve: str):
    code = (f"from msm_blst_tpu_torch.curves import {curve}\n"
            "from msm_blst_tpu_torch.msm import fixed_point_list\n"
            f"fixed_point_list({curve}, 4)\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "RuntimeError" in r.stderr and "no CUDA device" in r.stderr, r.stderr


def test_entry_points_default_to_the_card():
    _refuses_without_a_card("G1")


def test_g2_entry_points_default_to_the_card():
    _refuses_without_a_card("G2")


@pytest.mark.parametrize("name", ["microbench", "mxu_experiment",
                                  "gather_bench", "run_msm", "profile_stages",
                                  "bign_profile", "sharded_bign",
                                  "scaling_model", "dcn_sim"])
def test_drivers_default_to_the_card(name):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m",
                        f"msm_blst_tpu_torch.drivers.{name}"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "RuntimeError" in r.stderr and "no CUDA device" in r.stderr, r.stderr


_PROTOCOL_ENTRIES = {
    "hash_to_g1_device": "hash_to_g1_device([b'abc'])",
    "map_to_g1_device": "map_to_g1_device(FP.from_ints([5], device='cpu'))",
    "map_to_g2_device":
        "map_to_g2_device(FP2.from_int_pairs([(1, 2)], device='cpu'))",
}


@pytest.mark.parametrize("name", sorted(_PROTOCOL_ENTRIES))
def test_device_maps_default_to_the_card(name):
    """The batched hash-to-curve maps run on the card unless given
    device="cpu", even on CPU inputs."""
    code = ("from msm_blst_tpu_torch.fields import FP, FP2\n"
            f"from msm_blst_tpu_torch.protocol.device_map import {name}\n"
            f"{_PROTOCOL_ENTRIES[name]}\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "RuntimeError" in r.stderr and "no CUDA device" in r.stderr, r.stderr


def test_new_modules_are_walked():
    """The modules of this slice are among those the import check walks."""
    import pkgutil

    import msm_blst_tpu_torch as pkg

    names = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                     pkg.__name__ + ".")}
    for mod in ("fields.sos", "utils.profiling", "drivers.microbench",
                "drivers.mxu_experiment", "drivers.gather_bench", "msm.cache",
                "curves.mult", "drivers.run_msm", "drivers.profile_stages",
                "drivers.bign_profile", "entry", "refimpl.ints",
                "refimpl.field", "refimpl.curve", "protocol.iso_constants",
                "protocol.tower", "protocol.hash_to_curve",
                "protocol.device_map", "protocol.pairing", "protocol.glv",
                "protocol.keygen", "protocol.signatures", "curves.serialize",
                "utils.exports", "api", "native", "parallel",
                "parallel.sharded", "parallel.ranks", "drivers.sharded_bign",
                "drivers.scaling_model", "drivers.dcn_sim"):
        assert f"msm_blst_tpu_torch.{mod}" in names


def test_entry_defaults_to_the_card():
    code = ("from msm_blst_tpu_torch.entry import entry\n"
            "entry()\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "RuntimeError" in r.stderr and "no CUDA device" in r.stderr, r.stderr


def test_dryrun_multichip_defaults_to_the_card():
    """The sharded dry run refuses to start its ranks without a card unless
    given device="cpu"."""
    code = ("from msm_blst_tpu_torch.entry import dryrun_multichip\n"
            "dryrun_multichip(2)\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "RuntimeError" in r.stderr and "no CUDA device" in r.stderr, r.stderr


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("name", [k.name for k in kernels.ALL_KERNELS])
def test_kernel_table_matches_its_source(name):
    """The C symbol a kernel is bound to is defined in its source, with the
    argument types its ctypes binding passes (the stream last)."""
    k = next(k for k in kernels.ALL_KERNELS if k.name == name)
    src = (kernels.CSRC / k.source).read_text()
    m = re.search(r'extern "C" int ' + k.symbol + r"\(([^)]*)\)", src)
    assert m, f"{k.symbol} not in {k.source}"
    params = [" ".join(a.split()) for a in m.group(1).split(",")]
    assert params[-1] == "void* stream"
    ctype = {"int64_t": ctypes.c_int64, "int": ctypes.c_int}
    want = [ctypes.c_void_p if "*" in a else ctype[a.rsplit(" ", 1)[0]]
            for a in params[:-1]]
    assert k.argtypes == want


@pytest.mark.parametrize("curve", sorted(kernels.CURVE_KERNELS))
@pytest.mark.parametrize("op", sorted(kernels.OCCUPANCY))
def test_occupancy_query_is_in_its_source(curve, op):
    """Each occupancy query kernels.occupancy binds is defined in the
    source of the kernels it reports on, taking the int array it fills."""
    src = (kernels.CSRC / kernels.CURVE_KERNELS[curve][op].source).read_text()
    symbol = kernels.occupancy_symbol(curve, op)
    assert f'extern "C" int {symbol}(int* blocks)' in src


@pytest.mark.parametrize("symbol, name", [
    ("_ZN12_GLOBAL__N_111dadd_kernelIN3msm2FpEEEvPT_", "dadd_kernel"),
    ("_ZN12_GLOBAL__N_114sos_mul_kernelILi3EEEvPKjS2_PjS2_l",
     "sos_mul_kernel<3>"),
    ("_ZN12_GLOBAL__N_117madd_chain_kernelIjEEvPKT_S3_PS1_ll",
     "madd_chain_kernel<uint32_t>"),
    ("_ZN12_GLOBAL__N_117madd_chain_kernelIfEEvPKT_S3_PS1_ll",
     "madd_chain_kernel<float>"),
    ("_ZN12_GLOBAL__N_118gather_smem_kernelEPKiS1_Pilll",
     "gather_smem_kernel"),
])
def test_ptxas_entry_names(symbol, name):
    """ptxas_summary keys each instance of a kernel template by its integer
    or builtin-type arguments (K6's stages, K7's dtypes), so none hides
    another; class arguments are left out (g++ mangles as nvcc does)."""
    assert kernels._entry_name(symbol) == name
