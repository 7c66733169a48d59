"""Segmentation serving: the route-registry engine, its synchronous
(``submit`` / ``flush``) and async (``submit_async`` ->
:class:`SegmentationFuture`) front doors. The LM ``ServeEngine`` lives
in :mod:`repro_torch.launch.serve` and is re-exported here lazily, with
a DeprecationWarning (and through ``repro_torch.serving.engine``), for
old call sites."""
from . import fcm_engine  # noqa: F401
from .admission import (DeadlineExceeded, EngineShutdown,  # noqa: F401
                        InvalidInput, Overloaded, SegmentationFuture,
                        SolveFailed)
from .fcm_engine import FCMServeEngine, SegmentationResult  # noqa: F401


def __getattr__(name):
    # Lazy deprecated re-exports: importing repro_torch.serving must not
    # warn (or pull the LM stack in) unless the legacy names are touched.
    if name == "ServeEngine":
        import warnings
        warnings.warn(
            "repro_torch.serving.ServeEngine is deprecated: import it from "
            "repro_torch.launch.serve", DeprecationWarning, stacklevel=2)
        from repro_torch.launch.serve import ServeEngine
        return ServeEngine
    if name == "engine":
        from . import engine
        return engine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
