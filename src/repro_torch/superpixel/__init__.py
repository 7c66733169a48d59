"""Superpixel compression: SLIC over-segmentation as the multi-channel
analogue of the 1-D intensity histogram, plus the compress ->
weighted-vector-FCM -> broadcast pipeline."""
from .slic import SLICParams, SLICResult, fit_slic  # noqa: F401
from .pipeline import (  # noqa: F401
    SuperpixelCompression, SuperpixelFCMConfig, compress, fit_superpixel)
