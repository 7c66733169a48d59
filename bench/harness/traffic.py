"""The one traffic generator: a cell's inputs and request order from its
configuration, its traffic mix and ``--seed``.

A traffic mix (``traffic/<mix>.json``) holds only parameters:

* ``loop``: ``"closed"``, each client sends its next request when the
  last one returns;
* ``clients``: how many such clients (one: the harness drives one);
* ``payload``: how a study is submitted, ``"slices"`` (its D slices as
  D 2-D requests in one ``segment`` call);
* ``head_scales``: one anatomy each, the phantom's head scaled by it;
* ``realisations``: noise draws of each anatomy over the configuration's
  full depth (the bank: anatomies x realisations volumes);
* ``depths``: the studies' depths in slices, each at most the
  configuration's; a study covers a run of that many slice positions at
  an offset drawn from the seed, each slice from a realisation drawn
  from the seed, so no two studies of a window are alike byte for byte;
* ``warmup``: requests sent before the window, counted in set-up, one of
  each depth in turn (so every bucket shape is built before the window);
* ``label_sample``: requests of the window whose labels the check keeps,
  drawn from the seed.

The window's requests take (anatomy, depth) from a cycle of every pair,
shuffled by the seed, so every seed sends the same sizes and anatomies
in another order; the offsets, the realisations and the noise are the
seed's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from . import phantom

LOOPS = ("closed",)
PAYLOADS = ("slices",)


@dataclasses.dataclass
class Pool:
    """The bank of volumes of one run and the studies it sends.

    A request is ``lanes``, an int (L, 2) array of (bank volume, slice)
    pairs, one a submitted slice; ``payload(lanes)`` is what it hands
    ``segment`` (views into the bank, no copy)."""
    volumes: List[np.ndarray]           # the bank: uint8 (D, H, W) each
    realisations: int
    depths: List[int]
    cycle: np.ndarray                   # (anatomy, depth index) pairs
    seed: int

    @property
    def slice_pixels(self) -> int:
        return int(self.volumes[0][0].size)

    def _study(self, anatomy: int, depth: int, rng) -> np.ndarray:
        full = self.volumes[0].shape[0]
        off = int(rng.integers(0, full - depth + 1))
        real = rng.integers(0, self.realisations, size=depth)
        vol = anatomy * self.realisations + real
        return np.stack([vol, off + np.arange(depth)], axis=1).astype(
            np.int32)

    def warmup_request(self, j: int) -> np.ndarray:
        """The ``j``-th warm-up request: depth ``j`` of the mix in turn."""
        rng = rng_for(self.seed, 2, j)
        anatomies = len(self.volumes) // self.realisations
        return self._study(j % anatomies, self.depths[j % len(self.depths)],
                           rng)

    def request(self, i: int) -> np.ndarray:
        """The ``i``-th request of the window."""
        a, k = self.cycle[i % len(self.cycle)]
        return self._study(int(a), self.depths[int(k)],
                           rng_for(self.seed, 3, i))

    def payload(self, lanes: np.ndarray) -> List[np.ndarray]:
        return [self.volumes[v][z] for v, z in lanes]


def check_traffic(traffic: Dict[str, Any], depth: int) -> None:
    if traffic["loop"] not in LOOPS:
        raise ValueError(f"loop {traffic['loop']!r}: the generator drives "
                         f"{LOOPS}")
    if int(traffic["clients"]) != 1:
        raise ValueError("a closed loop here has one client")
    if traffic["payload"] not in PAYLOADS:
        raise ValueError(f"payload {traffic['payload']!r} not in {PAYLOADS}")
    if not traffic["head_scales"] or int(traffic["realisations"]) < 1:
        raise ValueError("a bank holds at least one volume")
    if not traffic["depths"] or not all(
            1 <= int(d) <= depth for d in traffic["depths"]):
        raise ValueError(f"depths {traffic['depths']} not within 1..{depth}")


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent stream of ``seed`` (any non-negative int, also past
    64 bits) for each purpose: the schedule, the label sample."""
    return np.random.default_rng([int(seed), *stream])


def torch_gen(seed: int, device: torch.device, *stream: int
              ) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``seed`` and
    ``stream`` through NumPy's seed sequence (64 bits of it)."""
    s = np.random.SeedSequence([int(seed), *stream]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def make_pool(config: Dict[str, Any], traffic: Dict[str, Any], seed: int,
              device: torch.device = torch.device("cpu")) -> Pool:
    """The bank drawn on ``device`` from the seed, kept in host memory
    (the engine takes studies from the host, as a pipeline hands them)."""
    geo = config["volume"]
    d, h, w = int(geo["depth"]), int(geo["height"]), int(geo["width"])
    check_traffic(traffic, d)
    lo, hi = geo["slice_pos"]
    pos = phantom.slice_positions(d, lo, hi)
    noise = config["noise"]
    reals = int(traffic["realisations"])
    gen = torch_gen(seed, device, 0)
    vols = []
    for scale in traffic["head_scales"]:
        labels = phantom.labels_volume(h, w, pos, float(scale), device)
        for _ in range(reals):
            vols.append(phantom.noisy_volume(
                labels, config["class_means"], float(noise["sigma"]),
                float(noise["impulse"]), gen).cpu().numpy())
    depths = [int(x) for x in traffic["depths"]]
    pairs = np.array([(a, k) for a in range(len(traffic["head_scales"]))
                      for k in range(len(depths))])
    cycle = pairs[rng_for(seed, 4).permutation(len(pairs))]
    return Pool(volumes=vols, realisations=reals, depths=depths,
                cycle=cycle, seed=int(seed))


class Reservoir:
    """A uniform sample of at most ``k`` of the window's requests, drawn
    from the seed as they complete (reservoir sampling), so the check
    keeps few labels in memory whatever the window's length."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k = int(k)
        self.rng = rng
        self.seen = 0
        self.items: List[Any] = []

    def offer(self, item: Any) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = item
