"""The port's streamed table builders against the JAX package's, word for
word: build_ches_table_rows_streamed and build_bgmw_table_rows_streamed
(the window-major "j" layout) on n = 16 fixed points, two windows of c = 8
(both packages' builders read only c and h of the config), with the
port's points split in 1, 2 and 4 parts. Affine words are canonical, so
the per-part batch inversions give JAX's words exactly.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.curves import G1 as JG1
from msm_blst_tpu.curves.ops import AffinePoint as JAffine
from msm_blst_tpu.msm import precompute as jprecompute
from msm_blst_tpu_torch.convert import fp_to_jax
from msm_blst_tpu_torch.curves import G1
from msm_blst_tpu_torch.msm import (build_bgmw_table_rows_streamed,
                                    build_ches_table_rows_streamed,
                                    fixed_point_list)

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

WINDOWS = types.SimpleNamespace(c=8, h=2, c_bgmw=8, h_bgmw=2)
BUILDERS = {"ches": (build_ches_table_rows_streamed,
                     jprecompute.build_ches_table_rows_streamed),
            "bgmw": (build_bgmw_table_rows_streamed,
                     jprecompute.build_bgmw_table_rows_streamed)}


@pytest.fixture(scope="module")
def points():
    return fixed_point_list(G1, 16, device=CPU)


@pytest.fixture(scope="module")
def jax_rows(points):
    """JAX's rows of each table, once."""
    jpts = JAffine(*(jnp.asarray(fp_to_jax(c)) for c in points))
    return {name: np.asarray(jax_fn(JG1, jpts, WINDOWS).XY).view(np.int32)
            for name, (_, jax_fn) in BUILDERS.items()}


@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("table", ["ches", "bgmw"])
def test_streamed_rows_match_jax(points, jax_rows, table, parts):
    got = BUILDERS[table][0](G1, points, WINDOWS, parts=parts).XY
    assert got.shape == (WINDOWS.h * 16 * (3 if table == "ches" else 1), 24)
    assert np.array_equal(got.numpy(), jax_rows[table])
