"""Segmentation serving: the route-registry engine, its synchronous
(``submit`` / ``flush``) and async (``submit_async`` ->
:class:`SegmentationFuture`) front doors."""
from . import fcm_engine  # noqa: F401
from .admission import (DeadlineExceeded, EngineShutdown,  # noqa: F401
                        InvalidInput, Overloaded, SegmentationFuture,
                        SolveFailed)
from .fcm_engine import FCMServeEngine, SegmentationResult  # noqa: F401
