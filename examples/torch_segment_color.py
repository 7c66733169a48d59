"""Color and multi-channel demo on the PyTorch port: superpixel-compressed
FCM, on the card unless ``--device cpu``.

Segments an RGB phantom and a three-channel (T1/T2/PD-like) stack
through the serving engine's ``method="superpixel"`` route (SLIC on
ingest: the SLIC assignment kernel; weighted vector FCM over ~K
superpixel rows: the whole-solve kernel) and the uncompressed
``method="pixel"`` route (the streamed whole-solve kernel), then reports
per-tissue DSC and the N -> K compression. Outputs land in the
gitignored ``examples/out/``.

  PYTHONPATH=src python examples/torch_segment_color.py [--device cpu]
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

SIZE = 128
#: every class's DSC at least this through either route
DSC_BAR = 0.95


def write_ppm(path, img):
    img = np.asarray(img, np.uint8)
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--size", type=int, default=SIZE,
                    help="the images' height and width")
    ap.add_argument("--out", default=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "out"))
    args = ap.parse_args(argv)
    dev = DV.resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    job = make_config()
    eng = FCMServeEngine(job.fcm, superpixel_cfg=job.superpixel, device=dev)

    size = args.size
    workloads = [
        ("rgb", phantom.CLASS_MEANS_RGB,
         *phantom.phantom_slice_rgb(size, size, noise=6.0, seed=7)),
        ("t1t2pd", phantom.CLASS_MEANS_MULTI,
         *phantom.phantom_slice_channels(size, size, noise=6.0, seed=7)),
    ]
    out = {}
    for name, class_means, img, gt in workloads:
        n = img.shape[0] * img.shape[1]
        r_sp = eng.segment([img], method="superpixel")[0]
        r_px = eng.segment([img], method="pixel")[0]
        k = int(np.asarray(eng.superpixel_cfg.n_segments))
        print(f"{name}: {img.shape} -> ~{k} superpixels "
              f"({n / k:.0f}x compression) on {dev}")
        out[name] = {"image": img}
        for tag, res in [("superpixel", r_sp), ("pixel", r_px)]:
            pred = phantom.match_labels_to_means(res.labels, res.centers,
                                                 class_means)
            dscs = phantom.dice_per_class(pred, gt)
            print(f"  {tag:10s} ({res.n_iters:3d} iters) DSC:",
                  {c: round(d, 3) for c, d in zip(phantom.CLASS_NAMES,
                                                  dscs)})
            assert min(dscs) >= DSC_BAR, (name, tag, dscs)
            out[name][tag] = {"labels": res.labels, "centers": res.centers,
                              "n_iters": res.n_iters, "dsc": dscs}
            if name == "rgb":
                colors = phantom.CLASS_MEANS_RGB.astype(np.uint8)
                write_ppm(os.path.join(args.out, f"torch_color_{tag}.ppm"),
                          colors[pred])
        if name == "rgb":
            write_ppm(os.path.join(args.out, "torch_color_input.ppm"), img)

    s = eng.stats()
    print("route mix:", s["method_requests"],
          f"| compress {s['compress_seconds'] * 1e3:.0f} ms, "
          f"superpixel fit {s['superpixel_seconds'] * 1e3:.0f} ms, "
          f"pixel fit {s['pixel_seconds'] * 1e3:.0f} ms")
    eng.shutdown()
    print("segment_color OK")
    return out


if __name__ == "__main__":
    main()
