"""Multi-slice (3-D volume) segmentation on the PyTorch port, with the
sharded FCM and a restart from checkpointed centers, on the card unless
``--device cpu``.

Fits the whole volume's pixels as one dataset sharded over a
:class:`~repro_torch.core.distributed.Mesh` (histogram form: each shard
bins its pixels, one sum of 256 counts, one whole solve), checkpoints the
centers, then restarts from the centers alone, as after a node failure:
the FCM state is c floats, so recovery is trivial at any scale. The
restart solves every pixel (``solve(pixel_problem)``: the streamed
whole-solve kernel on the card).

  PYTHONPATH=src python examples/torch_segment_volume.py [--device cpu]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch import _device as DV  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core import fcm as F  # noqa: E402
from repro_torch.core import solver as SV  # noqa: E402
from repro_torch.data import phantom  # noqa: E402

#: the volume's every class DSC above this
DSC_BAR = 0.85


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--slices", type=int, default=24)
    ap.add_argument("--size", type=int, default=128,
                    help="each slice's height and width")
    ap.add_argument("--shards", type=int, default=2,
                    help="mesh shards (each on the one device)")
    ap.add_argument("--out", default=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "out"))
    args = ap.parse_args(argv)
    dev = DV.resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    slices, gts = [], []
    for z in range(args.slices):
        img, gt = phantom.phantom_slice(
            args.size, args.size, slice_pos=0.3 + 0.4 * z / args.slices,
            seed=z)
        slices.append(img)
        gts.append(gt)
    vol = np.stack(slices)
    x = vol.ravel().astype(np.float32)
    print(f"volume: {vol.shape} = {x.size / 1024:.0f} KB on {dev}")

    cfg = F.FCMConfig(max_iters=300)
    mesh = D.make_mesh((args.shards,), ("data",),
                       devices=[dev] * args.shards)
    res = D.fit_sharded(x, mesh, cfg, histogram=True)
    centers = res.centers.detach().cpu().numpy()
    labels = res.labels.detach().cpu().numpy()
    print(f"sharded histogram FCM on {mesh.size} shards converged in "
          f"{res.n_iters} iters; centers={np.sort(centers).round(1)}")

    # checkpoint = the centers (plus config); restart needs nothing else
    ckpt_path = os.path.join(args.out, "torch_fcm_centers.json")
    with open(ckpt_path, "w") as f:
        json.dump({"centers": centers.tolist(), "c": 4, "m": 2.0}, f)

    # --- simulated failure and restart ---
    with open(ckpt_path) as f:
        v0 = np.asarray(json.load(f)["centers"], np.float32)
    res2 = SV.solve(SV.pixel_problem(x, v0=v0, device=dev), eps=cfg.eps,
                    max_iters=50)
    print(f"restart from centers: {res2.n_iters} more iterations over "
          f"every pixel")

    dsc = phantom.dice_per_class(
        phantom.match_labels_to_classes(labels, centers).reshape(vol.shape),
        np.stack(gts))
    print("volume DSC:", {c: round(d, 4) for c, d in
                          zip(phantom.CLASS_NAMES, dsc)})
    assert min(dsc) > DSC_BAR, dsc
    print("volume segmentation OK")
    return {"volume": vol, "labels": labels, "centers": centers,
            "n_iters": res.n_iters, "dsc": dsc,
            "restart": {"labels": res2.labels.detach().cpu().numpy(),
                        "centers": res2.centers.detach().cpu().numpy(),
                        "n_iters": res2.n_iters}}


if __name__ == "__main__":
    main()
