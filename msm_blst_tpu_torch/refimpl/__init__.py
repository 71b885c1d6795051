"""The port's pure-Python oracles.

* `ints` (re-exported here as `G1`, `G2`, `CURVES`): affine G1 and G2 over
  plain ints, which build the fixed-base tables and check MSM results.
* `field` (`Fp`, `Fr`, `Fp2`) and `curve` (`CurveRef`, `G1_REF`, `G2_REF`
  with Jacobian and xyzz coordinates and the naive MSM): copies of the JAX
  package's refimpl, the element classes the host protocol stack
  (protocol/) computes with.

Slow and plainly correct; the tests hold each equal to the JAX package's.
"""

from .ints import CURVES, G1, G2, Curve, _Fp, _Fp2  # noqa: F401
from .field import Fp, Fp2, Fr  # noqa: F401
from .curve import (  # noqa: F401
    CurveRef,
    G1_REF,
    G2_REF,
    JacobianPoint,
    XyzzPoint,
)
