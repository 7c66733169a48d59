"""DEPRECATED shim: the LM :class:`ServeEngine` lives in
:mod:`repro_torch.launch.serve` (its launcher's home), leaving this
package to the segmentation serving stack (:mod:`.fcm_engine` and
:mod:`.admission`). Import from ``repro_torch.launch.serve``.
"""
from __future__ import annotations

import warnings

from repro_torch.launch.serve import ServeEngine  # noqa: F401

warnings.warn(
    "repro_torch.serving.engine is deprecated: ServeEngine moved to "
    "repro_torch.launch.serve (this shim re-exports it and will be removed)",
    DeprecationWarning, stacklevel=2)
