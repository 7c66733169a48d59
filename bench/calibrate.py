"""Readings that set a cell's limits: the check's numbers for the
program over many seeds, for the control (``harness/control.py``, the
reference in bfloat16) over a few, and for the early-stop faults (the
float64 reference put in the program's place, every lane stopped 1 or 2
steps early) on the control's seeds, at the cell's own size, in one process on
the card.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--requests 28]

The program's answers come from the cell's engine through the timed
path's own call: after the cell's warm-up, ``segment`` of the window's
first ``--requests`` requests (by default one cycle of the mix's
anatomies and depths), every one's labels checked. Each line of output
is one JSON object.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--requests", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from harness import check as CK
    from harness import control
    from harness import drive
    from harness import spec as SPEC
    from harness import traffic as TF

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = SPEC.load_cell(args.workload)
    cfg, route = cell.config, cell.config["route"]
    eng = drive.build_engine(cfg, False, dev)
    for seed in args.seeds:
        pool = TF.make_pool(cfg, cell.traffic, seed, dev)
        for j in range(int(cell.traffic["warmup"])):
            eng.segment(pool.payload(pool.warmup_request(j)), method=route)
        ans = CK.Answers(route=route)
        for i in range(args.requests or len(pool.cycle)):
            lanes = pool.request(i)
            payload = pool.payload(lanes)
            res = eng.segment(payload, method=route)
            got = drive._answers_of(res, payload)
            if got is None:
                ans.missing += 1
                continue
            got = drive._stacked(*got)
            ans.lanes.append(lanes)
            ans.centers.append(got[0])
            ans.iters.append(got[1])
            ans.sample.append((lanes, np.stack([r.labels for r in res]),
                               got[0]))
        t = time.perf_counter()
        vals = CK.readings(ans, pool, cfg, dev)
        print(json.dumps({"workload": cell.name, "side": "program",
                          "seed": seed, "readings": vals,
                          "reference_s": time.perf_counter() - t}),
              flush=True)
    del eng
    torch.cuda.empty_cache()
    for seed in args.control_seeds:
        pool = TF.make_pool(cfg, cell.traffic, seed, dev)
        for side, kw in (("control", {}),
                         ("early1", {"dtype": torch.float64, "early": 1}),
                         ("early2", {"dtype": torch.float64, "early": 2})):
            ans = control.answers(route, pool, cfg, dev, **kw)
            vals = CK.readings(ans, pool, cfg, dev)
            print(json.dumps({"workload": cell.name, "side": side,
                              "seed": seed, "readings": vals}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
