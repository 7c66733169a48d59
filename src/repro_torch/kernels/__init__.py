"""The port's CUDA kernels (csrc/), their wrappers and plain versions,
and the step dispatch registry."""
from . import (defuzzify, fcm_centers, fcm_membership,  # noqa: F401
               fcm_resident, fcm_spatial, fcm_stencil, histogram_bin, ops,
               selective_scan, slic_assign)
