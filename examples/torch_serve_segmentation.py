"""Serve FCM segmentation over a synthetic multi-slice phantom volume on
the PyTorch port, on the card unless ``--device cpu``.

A stream of 8-bit slices of mixed sizes (a volumetric study plus two
scouts, then the study again) hits
:class:`repro_torch.serving.FCMServeEngine`, which bins each request on
ingest (the binning kernel), buckets the queue into fixed batch shapes,
solves each bucket in one launch (the histogram whole-solve kernel),
labels it (the labels kernel), and answers repeats from the
histogram-keyed LRU cache; then 8 noisy slices through the spatial route
in one stencil whole-solve.

  PYTHONPATH=src python examples/torch_serve_segmentation.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch import _device as DV  # noqa: E402
from repro_torch.configs.fcm_brainweb import make_config  # noqa: E402
from repro_torch.data import phantom  # noqa: E402
from repro_torch.serving import FCMServeEngine  # noqa: E402

#: every study slice's worst class DSC above this
DSC_BAR = 0.80


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--slices", type=int, default=40,
                    help="slices in the study")
    ap.add_argument("--size", type=int, default=128,
                    help="the study slices' height and width")
    args = ap.parse_args(argv)
    dev = DV.resolve_device(args.device)
    job = make_config()
    engine = FCMServeEngine(job.fcm, batch_sizes=job.serving_batch_sizes,
                            spatial_cfg=job.spatial, device=dev)

    # A study with varying anatomy + a couple of odd-size scouts.
    n = args.slices
    slices, gts = [], []
    for z in range(n):
        img, gt = phantom.phantom_slice(
            args.size, args.size, slice_pos=0.25 + 0.5 * z / n,
            noise=3.0 + (z % 4), seed=z)
        slices.append(img)
        gts.append(gt)
    scouts = [phantom.phantom_slice(96, 160, slice_pos=0.5, seed=100)[0],
              phantom.phantom_slice(64, 64, slice_pos=0.45, seed=101)[0]]

    results = engine.segment(slices + scouts)
    print(f"served {len(results)} requests in "
          f"{engine.stats()['batches']} batched fits on {dev}")

    dscs = []
    for r, gt in zip(results[:n], gts):
        pred = phantom.match_labels_to_classes(r.labels, r.centers)
        dscs.append(min(phantom.dice_per_class(pred, gt)))
    print(f"worst per-slice min-DSC over the study: {min(dscs):.4f}")
    assert min(dscs) > DSC_BAR

    # Re-submission of the whole study: served from cache, no fits.
    before = engine.stats()["batches"]
    again = engine.segment(slices)
    assert all(r.cache_hit for r in again)
    assert engine.stats()["batches"] == before
    print("re-submitted study: 100% cache hits, 0 new fits")

    # Spatial traffic batches across requests too: 8 same-shape noisy
    # slices -> one per-lane-masked stencil whole-solve.
    noisy = [phantom.noisy_phantom_slice(64, 64, noise=10.0, impulse=0.04,
                                         seed=z)[0] for z in range(8)]
    sres = engine.segment(noisy, method="spatial")
    s = engine.stats()
    assert s["spatial_batches"] == 1 and s["spatial_batched_images"] == 8
    print(f"spatial study: {len(sres)} FCM_S requests served in "
          f"{s['spatial_batches']} batched stencil solve")

    print(f"stats: requests={s['requests']} cache_hit_rate="
          f"{s['cache_hit_rate']:.2f} batched_images={s['batched_images']} "
          f"padded_lanes={s['padded_lanes']} "
          f"fit_throughput={s['images_per_sec']:.1f} img/s")
    engine.shutdown()
    print("serve_segmentation OK")
    return {"images": slices + scouts, "results": results,
            "noisy": noisy, "spatial": sres, "min_dsc": dscs}


if __name__ == "__main__":
    main()
