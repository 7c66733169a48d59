"""The paper's own configuration: FCM segmentation of brain phantom
slices into WM/GM/CSF/background (c=4, m=2, eps=0.005), served through
the static bucket ladder, with the paper's Table 3 dataset sizes."""
import dataclasses

from repro_torch.core.fcm import FCMConfig


@dataclasses.dataclass(frozen=True)
class FCMJobConfig:
    name: str = "fcm-brainweb"
    fcm: FCMConfig = FCMConfig(n_clusters=4, m=2.0, eps=5e-3, max_iters=300)
    # Serving: the bucket sizes every route pads its batches to.
    serving_batch_sizes: tuple = (1, 8, 16, 64)
    # paper Table 3 dataset sizes (bytes)
    table3_sizes = tuple(int(k * 1024) for k in
                         (20, 40, 60, 80, 100, 120, 140, 160, 180, 200,
                          300, 500, 700, 1000))


def make_config() -> FCMJobConfig:
    return FCMJobConfig()
