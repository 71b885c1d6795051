"""Pure-Python G1 arithmetic over ints: the port's host oracle.

Affine points are (x, y) int pairs with infinity (0, 0), the convention of
the rest of the package. Slow and plainly correct: it builds the fixed-base
window table (msm/precompute.py) and checks MSM results (chip_smoke.py).
tests/test_torch_fields.py holds it equal to msm_blst_tpu.refimpl.G1_REF.
"""

from __future__ import annotations

from .constants import B_G1, G1_X, G1_Y, P, R_ORDER

INF = (0, 0)
GENERATOR = (G1_X, G1_Y)


def is_on_curve(pt) -> bool:
    x, y = pt
    return pt == INF or (y * y - x * x * x - B_G1) % P == 0


def add(p1, p2):
    """p1 + p2 in affine, with the doubling and cancelling cases."""
    if p1 == INF:
        return p2
    if p2 == INF:
        return p1
    (x1, y1), (x2, y2) = p1, p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return INF
        lam = 3 * x1 * x1 * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def mult(k: int, pt=GENERATOR):
    """k * pt by double-and-add (k reduced mod r)."""
    acc = INF
    for bit in bin(k % R_ORDER)[2:]:
        acc = add(acc, acc)
        if bit == "1":
            acc = add(acc, pt)
    return acc
