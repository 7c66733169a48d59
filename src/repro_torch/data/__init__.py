"""Synthetic BrainWeb-like phantom data."""
from . import phantom  # noqa: F401
