"""Configurations the port serves."""
from . import fcm_brainweb  # noqa: F401
