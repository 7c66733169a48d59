"""Synthetic data: the BrainWeb-like phantom (:mod:`phantom`) and the
deterministic LM token pipeline (:mod:`pipeline`)."""
from . import phantom  # noqa: F401
from . import pipeline  # noqa: F401
