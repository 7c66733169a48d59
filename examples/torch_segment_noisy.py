"""Noisy-MRI demo on the PyTorch port: plain FCM against the spatially
regularized FCM_S, on the card unless ``--device cpu``.

Corrupts a phantom slice with heavy Gaussian and salt-and-pepper noise,
segments it through the serving engine's histogram route (plain FCM,
spatial-blind: binning, whole-solve and labels kernels) and its
``method="spatial"`` route (8-neighbor FCM_S: the stencil whole-solve
kernel), and reports per-tissue DSC. Outputs land in the gitignored
``examples/out/``.

  PYTHONPATH=src python examples/torch_segment_noisy.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch import _device as DV  # noqa: E402
from repro_torch.configs.fcm_brainweb import make_config  # noqa: E402
from repro_torch.data import phantom  # noqa: E402
from repro_torch.serving.fcm_engine import FCMServeEngine  # noqa: E402

#: FCM_S's every class DSC at least this at the heaviest noise level (the
#: JAX package's tests/test_fcm_spatial.py bar)
SPATIAL_DSC = 0.75


def write_pgm(path, img):
    img = np.asarray(img, np.uint8)
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--size", type=int, nargs=2, default=(217, 181),
                    metavar=("H", "W"), help="the slice's height and width")
    ap.add_argument("--out", default=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "out"))
    args = ap.parse_args(argv)
    dev = DV.resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    job = make_config()

    sigma, impulse = job.noise_levels[-1]
    img, gt = phantom.noisy_phantom_slice(*args.size, noise=sigma,
                                          impulse=impulse, seed=7)
    print(f"noisy slice: {img.shape}, gaussian sigma={sigma}, "
          f"impulse={impulse:.0%}, on {dev}")

    eng = FCMServeEngine(job.fcm, spatial_cfg=job.spatial, device=dev)
    plain = eng.segment([img])[0]                       # histogram route
    spatial = eng.segment([img], method="spatial")[0]   # FCM_S route

    out = {"image": img, "results": {}}
    for tag, res in [("plain-histogram", plain), ("spatial-fcm_s", spatial)]:
        pred = phantom.match_labels_to_classes(res.labels, res.centers)
        dscs = phantom.dice_per_class(pred, gt)
        print(f"  {tag:16s} ({res.n_iters} iters) DSC:",
              {c: round(d, 3) for c, d in zip(phantom.CLASS_NAMES, dscs)})
        write_pgm(os.path.join(args.out, f"torch_noisy_{tag}.pgm"),
                  (pred * 85).astype(np.uint8))
        out["results"][tag] = {"labels": res.labels, "centers": res.centers,
                               "n_iters": res.n_iters, "dsc": dscs}
    assert min(out["results"]["spatial-fcm_s"]["dsc"]) >= SPATIAL_DSC
    write_pgm(os.path.join(args.out, "torch_noisy_input.pgm"), img)
    s = eng.stats()
    print(f"engine: {s['requests']} requests, "
          f"{s['method_requests']['spatial']} spatial, cache entries "
          f"{s['cache_entries']}")
    eng.shutdown()
    print("segment_noisy OK")
    return out


if __name__ == "__main__":
    main()
