"""Segmentation serving: the route-registry engine (histogram route,
synchronous API)."""
from . import fcm_engine  # noqa: F401
from .admission import (DeadlineExceeded, EngineShutdown,  # noqa: F401
                        InvalidInput, Overloaded, SolveFailed)
from .fcm_engine import FCMServeEngine, SegmentationResult  # noqa: F401
