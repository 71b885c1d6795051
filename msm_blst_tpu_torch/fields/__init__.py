"""Montgomery field arithmetic: Fp and Fr on int32[W, *batch] word
batches, Fp2 on int32[2, 12, *batch]."""

from .fp2 import FP2, Fp2Ops, fp2_for  # noqa: F401
from .limb import FP, FR, MUL_IMPLS, LimbField, fp_for  # noqa: F401
