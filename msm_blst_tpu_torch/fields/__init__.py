"""Montgomery field arithmetic on int32[12, *batch] word batches."""

from .limb import FP, FR, LimbField  # noqa: F401
