"""The paper's own configuration: FCM segmentation of brain phantom
slices into WM/GM/CSF/background (c=4, m=2, eps=0.005), served through
the static bucket ladder, with the paper's Table 3 dataset sizes, plus
the superpixel compression for color and multi-modal stacks and the
spatially-regularized (FCM_S) configuration for noisy MRI."""
import dataclasses

from repro_torch.core.fcm import FCMConfig
from repro_torch.core.spatial import SpatialFCMConfig
from repro_torch.data.phantom import NOISE_LEVELS
from repro_torch.superpixel.pipeline import SuperpixelFCMConfig


@dataclasses.dataclass(frozen=True)
class FCMJobConfig:
    name: str = "fcm-brainweb"
    fcm: FCMConfig = FCMConfig(n_clusters=4, m=2.0, eps=5e-3, max_iters=300)
    # FCM_S for the noisy-MRI workload: 8-neighbor stencil, alpha=1 (the
    # JAX package's benchmarks/spatial_fcm.py sweep backs these choices).
    spatial: SpatialFCMConfig = SpatialFCMConfig(
        n_clusters=4, m=2.0, eps=5e-3, max_iters=300,
        alpha=1.0, neighbors=8)
    # Superpixel compression for color / multi-modal stacks: ~256
    # superpixels replace N pixels in the fit (the vector analogue of
    # the 256-bin histogram); compactness 10 suits 0..255 features.
    superpixel: SuperpixelFCMConfig = SuperpixelFCMConfig(
        n_clusters=4, m=2.0, eps=5e-3, max_iters=300,
        n_segments=256, compactness=10.0, slic_iters=10)
    # Serving: the bucket sizes every route pads its batches to.
    serving_batch_sizes: tuple = (1, 8, 16, 64)
    # (gaussian sigma, impulse fraction) noise sweep for robustness evals
    noise_levels = NOISE_LEVELS
    # paper Table 3 dataset sizes (bytes)
    table3_sizes = tuple(int(k * 1024) for k in
                         (20, 40, 60, 80, 100, 120, 140, 160, 180, 200,
                          300, 500, 700, 1000))


def make_config() -> FCMJobConfig:
    return FCMJobConfig()
