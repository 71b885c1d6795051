"""The port stands apart from JAX and from the JAX package, its entry
points refuse to run without a card unless the caller asks for the CPU, and
its chip smoke refuses to run without a card or without the repository.

Both run in subprocesses, so this test process's own imports (pytest's
conftest imports jax) do not count.
"""

import os
import subprocess
import sys
from pathlib import Path

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
    assert int(r.stdout.strip()) >= 22  # every module of the package


def test_entry_points_default_to_the_card():
    code = ("from msm_blst_tpu_torch.curves import G1\n"
            "from msm_blst_tpu_torch.msm import fixed_point_list\n"
            "fixed_point_list(G1, 4)\n")
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
