"""Quickstart on the PyTorch port: the paper's pipeline end to end on one
axial slice, on the card unless ``--device cpu``.

Segments a synthetic brain phantom into WM/GM/CSF/background through the
solver core: the same ``solve(pixel_problem(x))`` entry point drives the
paper's staged pipeline (``backend="staged"``: the membership and
center-partials kernels on the card) and the fused fixed point
(``backend="fused"``: the fused-partials kernel), reports DSC against
ground truth for both (paper Fig. 7), and writes PGM images.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch import _device as DV  # noqa: E402
from repro_torch.core import fcm as F  # noqa: E402
from repro_torch.core import solver as SV  # noqa: E402
from repro_torch.data import phantom  # noqa: E402

#: every class's DSC at least this on the clean slice
DSC_BAR = 0.9


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

    img, gt = phantom.phantom_slice(*args.size, slice_pos=0.5, seed=96)
    x = img.ravel().astype(np.float32)
    print(f"phantom slice: {img.shape}, {x.size / 1024:.0f} KB on {dev}")

    # The paper "manually selects" the four clusters; both paths start
    # from the deterministic linspace centers (a random membership init
    # can collapse clusters on some seeds).
    xt = DV.as_f32(x, dev)
    u0 = F.update_membership(xt, F.linspace_centers(xt, 4), 2.0)
    cfg = F.FCMConfig()
    problem = SV.pixel_problem(x, cfg, device=dev)
    base = SV.solve(problem, cfg, backend="staged", u0=u0)
    fused = SV.solve(problem, cfg, backend="fused")
    out = {"image": img, "results": {}}
    for tag, res in [("staged", base), ("fused", fused)]:
        centers = res.centers.detach().cpu().numpy()
        labels = res.labels.detach().cpu().numpy()
        pred = phantom.match_labels_to_classes(labels, centers)
        dscs = phantom.dice_per_class(pred.reshape(img.shape), gt)
        print(f"  {tag:6s} {res.n_iters:3d} iters, centers "
              f"{np.sort(centers).round(1)}, DSC",
              {c: round(d, 4) for c, d in zip(phantom.CLASS_NAMES, dscs)})
        assert min(dscs) >= DSC_BAR, (tag, dscs)
        write_pgm(os.path.join(args.out, f"torch_segmented_{tag}.pgm"),
                  (pred.reshape(img.shape) * 85).astype(np.uint8))
        out["results"][tag] = {"labels": labels, "centers": centers,
                               "n_iters": res.n_iters, "dsc": dscs}
    write_pgm(os.path.join(args.out, "torch_input.pgm"), img)
    print(f"wrote {args.out}/torch_input.pgm and torch_segmented_*.pgm")
    print("quickstart OK")
    return out


if __name__ == "__main__":
    main()
