"""Plan persistence (port of msm_blst_tpu/msm/cache.py): a plan's tables
saved to disk once and loaded onto the device thereafter, so a big-n
deployment builds its multi-GB tables once (the reference rebuilds them
every run).

The files are the JAX package's, under its key, so a cache either package
wrote loads into the other: in `cache_dir`, for the key
`{curve}_n{n}_c{c}_h{h}_ah{ah}_cb{c'}_hb{h'}_rows_p32`,

* `<key>_t3nh_xy32.npy`, `<key>_tnh_xy32.npy`: the CHES and BGMW tables'
  PackedRows32 rows, uint32[rows, 2W] (the port's int32 rows, bit for bit);
* `<key>_points_x.npy`, `<key>_points_y.npy`: the points in the JAX
  package's 16-bit limb layout (uint32[24, n], or [2, 24, n] on G2);
* `<key>_meta.json`: the row `layout` ("i" or "j") and, written by the
  port, `bgmw_stride3`, so an aliased plan keeps its BGMW query (the JAX
  package drops the flag: its fault C1). A file without the flag (one the
  JAX package wrote) aliases when the radixes match, the one case the
  stride-3 view of a 3nh table is the nh table.

Each file is written to a temporary name and renamed, so an interrupted
save leaves no truncated table. Rows load as int32 views onto the plan's
device, as `convert._rows` does.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..curves.ops import AffinePoint, CurveOps, PackedRows32
from ..device import resolve
from . import params as P
from .engine import MsmPlan
from .precompute import _attach_ches_params


def cache_key(curve: CurveOps, cfg: P.MsmConfig, n: int) -> str:
    """The JAX package's key of a plan with packed rows (cache.py:_key)."""
    return (f"{curve.name}_n{n}_c{cfg.c}_h{cfg.h}_ah{cfg.ah}"
            f"_cb{cfg.c_bgmw}_hb{cfg.h_bgmw}_rows_p32")


def _plan_n(plan: MsmPlan) -> int:
    """n from whichever table the plan holds."""
    if plan.points is not None:
        return plan.points.X.shape[-1]
    if plan.table3nh is not None:
        return plan.table3nh.XY.shape[0] // (3 * plan.cfg.h)
    if plan.table_nh is not None:
        return plan.table_nh.XY.shape[0] // plan.cfg.h_bgmw
    raise ValueError("save_plan: the plan holds no table")


def _publish(path: str, write) -> None:
    """write(file) into a temporary name, then rename it to `path`."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def save_plan(plan: MsmPlan, cache_dir: str) -> str:
    """Write the plan's tables and points under its key in `cache_dir`.
    Returns the key's base path. Raises if the directory already caches
    this key in the other row layout."""
    from ..convert import fp2_to_jax, fp_to_jax

    os.makedirs(cache_dir, exist_ok=True)
    base = os.path.join(cache_dir, cache_key(plan.curve, plan.cfg,
                                             _plan_n(plan)))
    meta_path = base + "_meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            old = json.load(f).get("layout", "i")
        if old != plan.layout:
            raise ValueError(f"cache layout mismatch at {base}: cached "
                             f"{old!r}, plan {plan.layout!r}")
    arrays = {f"{base}_{name}_xy32.npy": rows.XY.cpu().numpy().view(np.uint32)
              for name, rows in (("t3nh", plan.table3nh),
                                 ("tnh", plan.table_nh)) if rows is not None}
    if plan.points is not None:
        to_jax = fp2_to_jax if plan.curve.name == "G2" else fp_to_jax
        arrays.update({f"{base}_points_{coord}.npy": to_jax(x)
                       for coord, x in zip("xy", plan.points)})
    for path, host in arrays.items():
        _publish(path, lambda f: np.save(f, host))
    meta = {"layout": plan.layout, "bgmw_stride3": plan.bgmw_stride3}
    _publish(meta_path, lambda f: f.write(json.dumps(meta).encode()))
    return base


def load_plan(curve: CurveOps, cfg: P.MsmConfig, n: int, cache_dir: str,
              device=None) -> Optional[MsmPlan]:
    """The plan cached under (curve, cfg, n) in `cache_dir` on `device`
    (default: the card), its queries on `curve` (curves.for_mul_impl gives
    the SOS one); None when nothing is cached there. The digit tables
    (index- and value-keyed) and the gap constants are rebuilt from cfg
    (host-cheap), as the JAX package's load_plan does."""
    from ..convert import fp2_from_jax, fp_from_jax

    base = os.path.join(cache_dir, cache_key(curve, cfg, n))
    meta_path = base + "_meta.json"
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        meta = json.load(f)
    device = resolve(device)
    plan = MsmPlan(curve=curve, cfg=cfg, layout=meta.get("layout", "i"))

    def rows(name):
        path = f"{base}_{name}_xy32.npy"
        if not os.path.exists(path):
            return None
        return PackedRows32(torch.from_numpy(
            np.load(path).view(np.int32)).to(device))

    plan.table3nh = rows("t3nh")
    plan.table_nh = rows("tnh")
    plan.bgmw_stride3 = plan.table3nh is not None and bool(meta.get(
        "bgmw_stride3", plan.table_nh is None and cfg.c == cfg.c_bgmw
        and cfg.h == cfg.h_bgmw))
    if plan.table3nh is not None:
        _attach_ches_params(plan, cfg, device)
    px, py = (f"{base}_points_{coord}.npy" for coord in "xy")
    if os.path.exists(px):
        from_jax = fp2_from_jax if curve.name == "G2" else fp_from_jax
        plan.points = AffinePoint(*(from_jax(np.load(p), device)
                                    for p in (px, py)))
        plan.points_rows = curve.to_rows32(plan.points)
    return plan
