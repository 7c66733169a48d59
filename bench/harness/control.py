"""The control of the check: the reference put in the program's place,
computed in bfloat16, the nearest precision below the configuration's
float32 (the program multiplies no matrices, so TF32 has no path into
it). Its answers must come out not correct.

``early`` plants a fault in the reference put in the program's place:
every lane stops that many steps before its own stop (at the first step
at the least) and reports the step it stopped at.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import check as CK
from . import reference as R
from . import traffic as TF


def answers(route: str, pool: TF.Pool, config: Dict, device: torch.device,
            dtype=torch.bfloat16, early: int = 0) -> CK.Answers:
    """Every bank volume as one request of all its slices; centers,
    iterations and labels all from the reference computed in ``dtype``."""
    fcm, spatial = config["fcm"], config.get("spatial") or {}
    out = CK.Answers(route=route)
    for k, vol in enumerate(pool.volumes):
        x = torch.from_numpy(vol).to(device)
        fit = R.solve(route, x, fcm, spatial, dtype=dtype)
        iters = fit.iters.clamp(min=early + 1) - early
        v = fit.traj[iters, torch.arange(len(iters), device=device)]
        lab = R.labels(route, x, v, fcm, spatial, dtype=dtype)
        centers = v.float().cpu().numpy()
        ln = np.stack([np.full(len(vol), k), np.arange(len(vol))],
                      axis=1).astype(np.int32)
        out.lanes.append(ln)
        out.centers.append(centers)
        out.iters.append(iters.cpu().numpy())
        out.sample.append((ln, lab.cpu().numpy(), centers))
    return out
