"""The port's CUDA kernels (csrc/), their wrappers and plain versions,
and the step dispatch registry."""
from . import defuzzify, fcm_resident, histogram_bin, ops  # noqa: F401
