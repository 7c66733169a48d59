"""Perf-trajectory ledger over the port's ``BENCH_pr*.json`` records.

The port's own copy of the JAX package's trajectory module, standard
library only (matplotlib is imported lazily for the figures; where it is
missing, as on a machine with only the port's run-time packages, the
``render_*`` functions return ``None``). It loads the whole ledger,
normalizes each record into a named per-metric time series (absorbing
schema evolution: a record that predates the explicit
``engine_overhead_vs_batched`` key derives it from
``engine_s / batched_s``), and exposes

* :func:`series`       -- ``{metric: [(pr, value), ...]}`` across PRs,
* :func:`diff`         -- per-metric regression verdicts between two
  records under a declarative :class:`Policy`,
* :func:`resolve_baseline` -- the newest record below the current PR,
  so no benchmark script hand-names its baseline file,
* :func:`render_trajectory` / :func:`render_frontier` -- the ledger and
  the accuracy-vs-speed sweep rendered as figures.

Metric directions are explicit (``lower``/``higher`` is better) and each
metric carries both a relative slack (how much worsening vs the baseline
is noise) and optional absolute bounds (ceilings/floors that gate even
when baseline and current are not wall-clock comparable, e.g. a ``tiny``
run against a full-size record).

The one difference from the JAX module: :data:`OUT_DIR` is
``benchmarks/out_torch``, not ``benchmarks/out``. The records under
``benchmarks/out`` were taken by the JAX package on the CPU and are no
baseline for the port; while ``out_torch`` holds no record,
:func:`ledger_paths` is empty and :func:`resolve_baseline` is ``None``.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Metric", "METRICS", "Policy", "Verdict", "DiffResult",
           "load_bench", "load_ledger", "series", "resolve_baseline",
           "diff", "render_trajectory", "render_frontier"]

#: Default ledger directory: the port's own, benchmarks/out_torch of this
#: repo checkout.
OUT_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "benchmarks", "out_torch"))

_BENCH_RE = re.compile(r"BENCH_pr(\d+)\.json$")


# ---------------------------------------------------------------------------
# Metric extractors (schema-evolution tolerant)
# ---------------------------------------------------------------------------

def _hist64(bench: dict) -> dict:
    h = bench.get("batched_throughput", {}).get("histogram", {})
    cell = h.get("64") or h.get(64)
    return cell if isinstance(cell, dict) else {}


def _spatial(bench: dict) -> dict:
    s = bench.get("batched_throughput", {}).get("spatial", {})
    return s if isinstance(s, dict) else {}


def _ratio(cell: dict, key: str, num: str, den: str) -> Optional[float]:
    """cell[key], or num/den when the explicit key predates the schema
    (an early record has engine_s/batched_s but no overhead key)."""
    v = cell.get(key)
    if v is not None:
        return float(v)
    n, d = cell.get(num), cell.get(den)
    if n and d:
        return float(n) / float(d)
    return None


def _engine_s(bench):
    v = _hist64(bench).get("engine_s")
    return float(v) if v is not None else None


def _batched_s(bench):
    v = _hist64(bench).get("batched_s")
    return float(v) if v is not None else None


def _engine_overhead(bench):
    return _ratio(_hist64(bench), "engine_overhead_vs_batched",
                  "engine_s", "batched_s")


def _batched_speedup(bench):
    v = _hist64(bench).get("speedup_batched_vs_seq")
    return float(v) if v is not None else None


def _spatial_speedup(bench):
    v = _spatial(bench).get("speedup_batched_vs_one_at_a_time")
    return float(v) if v is not None else None


def _spatial_overhead(bench):
    return _ratio(_spatial(bench), "engine_overhead_vs_batched",
                  "engine_s", "batched_s")


def _superpixel_speedup(bench):
    v = bench.get("superpixel_fcm", {}).get("speedup_fit")
    return float(v) if v is not None else None


def _superpixel_parity(bench):
    v = bench.get("superpixel_fcm", {}).get("dsc_parity_max_delta")
    return float(v) if v is not None else None


def _spatial_dsc_gain_wm(bench):
    """FCM_S's DSC payoff at the heaviest noise level (spatial_ref minus
    plain, WM class) — the quality metric the speed metrics must not
    silently trade away."""
    levels = bench.get("spatial_fcm", {}).get("levels") or []
    if not levels:
        return None
    fits = levels[-1].get("fits", {})
    try:
        return (float(fits["spatial_ref"]["dsc"]["WM"])
                - float(fits["plain"]["dsc"]["WM"]))
    except KeyError:
        return None


def _tracing_overhead(bench):
    v = _hist64(bench) and bench["batched_throughput"]["histogram"].get(
        "tracing_overhead_ratio")
    return float(v) if v is not None else None


def _mean_iters(bench):
    v = (bench.get("batched_throughput", {}).get("histogram", {})
         .get("convergence", {}) or {}).get("mean_iters")
    return float(v) if v is not None else None


def _load_sustained(bench):
    v = (bench.get("load_gen", {}).get("sustained") or {}
         ).get("achieved_qps")
    return float(v) if v is not None else None


def _load_p99(bench):
    v = (bench.get("load_gen", {}).get("sustained") or {}).get("p99_s")
    return float(v) if v is not None else None


def _load_ratio(bench):
    v = bench.get("load_gen", {}).get("qps_ratio_vs_sync")
    return float(v) if v is not None else None


@dataclasses.dataclass(frozen=True)
class Metric:
    """One named series over the BENCH ledger.

    ``kind`` decides when the relative gate applies: ``"time"`` and
    ``"ratio"`` metrics only compare full-size-vs-full-size runs (a
    ``tiny`` CI record against a full committed baseline is
    wall-clock-incomparable); ``"quality"`` metrics compare whenever
    both records carry them. ``ceiling``/``floor`` are absolute bounds
    enforced on the *current* record regardless of comparability —
    they mirror the hard gates the benchmark sections themselves
    enforce, so a tiny CI run still fails through :func:`diff`.
    """
    name: str
    extract: Callable[[dict], Optional[float]]
    direction: str                      # "lower" | "higher" is better
    kind: str = "ratio"                 # "time" | "ratio" | "quality"
    #: Allowed fractional worsening vs baseline; None disables the
    #: relative gate entirely (the metric gates on its absolute bound
    #: only — right for quantities whose baseline is legitimately 0).
    rel_slack: Optional[float] = 0.5
    ceiling: Optional[float] = None     # absolute max (lower-is-better)
    floor: Optional[float] = None       # absolute min (higher-is-better)

    def worsening(self, base: float, cur: float) -> float:
        """Signed fractional change in the *bad* direction (positive =
        worse than baseline). Any move away from a zero baseline is an
        infinite relative change — never silently 'within slack'."""
        if base == 0:
            if cur == 0:
                return 0.0
            worse = (cur > 0) == (self.direction == "lower")
            return math.inf if worse else -math.inf
        rel = (cur - base) / abs(base)
        return rel if self.direction == "lower" else -rel


#: The ledger's metric set. Ceilings/floors mirror the hard gates in
#: benchmarks/batched_throughput.py (engine overhead <= 5x, tracing
#: <= 1.25x, batched-spatial speedup >= 5x) so `diff` fails the same
#: regressions even on a tiny run, and names them per-metric.
METRICS: Tuple[Metric, ...] = (
    Metric("engine_s_b64", _engine_s, "lower", kind="time"),
    Metric("batched_s_b64", _batched_s, "lower", kind="time"),
    Metric("engine_overhead_b64", _engine_overhead, "lower",
           rel_slack=0.6, ceiling=5.0),
    Metric("batched_speedup_b64", _batched_speedup, "higher",
           rel_slack=0.5),
    Metric("spatial_batched_speedup", _spatial_speedup, "higher",
           rel_slack=0.5, floor=5.0),
    Metric("spatial_engine_overhead", _spatial_overhead, "lower",
           rel_slack=0.6),
    Metric("superpixel_speedup_fit", _superpixel_speedup, "higher",
           rel_slack=0.6),
    Metric("superpixel_dsc_parity", _superpixel_parity, "lower",
           kind="quality", rel_slack=None, ceiling=0.05),
    Metric("spatial_dsc_gain_wm", _spatial_dsc_gain_wm, "higher",
           kind="quality", rel_slack=0.15),
    Metric("tracing_overhead_ratio", _tracing_overhead, "lower",
           rel_slack=0.3, ceiling=1.25),
    Metric("mean_iters_b64", _mean_iters, "lower", kind="quality",
           rel_slack=0.5),
    # Serving load-gen: sustained throughput under the explicit
    # p99 budget, that point's p99, and the headline continuous-batching
    # claim. The ratio's floor mirrors the tiny gate in
    # benchmarks/load_gen.py (2.0 — the full-size artifact carries the
    # 3x claim through load_gen's own in-process gate), so even a tiny
    # CI record fails here if batching stops paying for itself.
    Metric("load_sustained_qps", _load_sustained, "higher", kind="time",
           rel_slack=0.5),
    Metric("load_p99_s", _load_p99, "lower", kind="time", rel_slack=1.0),
    Metric("load_qps_ratio_vs_sync", _load_ratio, "higher", kind="ratio",
           rel_slack=0.6, floor=2.0),
)

_BY_NAME = {m.name: m for m in METRICS}


# ---------------------------------------------------------------------------
# Ledger loading / series
# ---------------------------------------------------------------------------

def load_bench(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def ledger_paths(out_dir: Optional[str] = None) -> List[Tuple[int, str]]:
    """Sorted ``(pr, path)`` for every committed BENCH_pr*.json."""
    out_dir = out_dir or OUT_DIR
    found = []
    for p in glob.glob(os.path.join(out_dir, "BENCH_pr*.json")):
        m = _BENCH_RE.search(os.path.basename(p))
        if m:
            found.append((int(m.group(1)), p))
    return sorted(found)


def load_ledger(out_dir: Optional[str] = None) -> List[Tuple[int, dict]]:
    """Every committed record, oldest PR first."""
    return [(pr, load_bench(p)) for pr, p in ledger_paths(out_dir)]


def series(ledger: Sequence[Tuple[int, dict]],
           metrics: Sequence[Metric] = METRICS
           ) -> Dict[str, List[Tuple[int, Optional[float]]]]:
    """Normalize the ledger into per-metric time series; a record that
    predates a metric contributes ``None`` (kept, so gaps are visible
    rather than silently compacted)."""
    return {m.name: [(pr, m.extract(bench)) for pr, bench in ledger]
            for m in metrics}


def resolve_baseline(out_dir: Optional[str] = None,
                     before: Optional[int] = None) -> Optional[str]:
    """Path of the newest committed ``BENCH_pr*.json`` (strictly below
    PR ``before`` when given, so a PR gates against its predecessor and
    never against its own freshly-written record). ``None`` when the
    ledger is empty — the first PR has nothing to regress against."""
    cands = [(pr, p) for pr, p in ledger_paths(out_dir)
             if before is None or pr < before]
    return cands[-1][1] if cands else None


# ---------------------------------------------------------------------------
# diff: the per-metric regression gate
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Policy:
    """What :func:`diff` fails on.

    * ``on_regress`` — a relative worsening beyond the metric's slack,
      or an absolute ceiling/floor breach (``"fail"`` | ``"warn"``).
    * ``on_missing`` — a metric the baseline carries but the current
      record dropped (``"fail"`` | ``"warn"``): the trajectory must
      never silently lose a column.
    * ``gate_relative`` — enable baseline-relative gates (these only
      ever apply to wall-clock-comparable record pairs for
      ``time``/``ratio`` metrics).
    * ``gate_absolute`` — enable the per-metric ceilings/floors, which
      apply to every run including ``tiny`` CI smokes.
    * ``slack_scale`` — scales every metric's ``rel_slack`` (e.g. 2.0
      for a loose advisory pass).
    """
    on_regress: str = "fail"
    on_missing: str = "fail"
    gate_relative: bool = True
    gate_absolute: bool = True
    slack_scale: float = 1.0


@dataclasses.dataclass
class Verdict:
    metric: str
    status: str            # improved|ok|regressed|bound_breach|
    #                        missing_current|new_metric|absent|not_comparable
    baseline: Optional[float]
    current: Optional[float]
    fatal: bool
    detail: str = ""

    def line(self) -> str:
        def fmt(v):
            return "-" if v is None else f"{v:.4g}"
        mark = "FAIL" if self.fatal else {
            "improved": "  + ", "regressed": "WARN",
            "bound_breach": "WARN"}.get(self.status, "    ")
        return (f"{mark} {self.metric:26s} {fmt(self.baseline):>10s} -> "
                f"{fmt(self.current):>10s}  {self.status}"
                + (f" ({self.detail})" if self.detail else ""))


@dataclasses.dataclass
class DiffResult:
    baseline_pr: Optional[int]
    current_pr: Optional[int]
    comparable: bool
    verdicts: List[Verdict]

    @property
    def failures(self) -> List[Verdict]:
        return [v for v in self.verdicts if v.fatal]

    @property
    def ok(self) -> bool:
        return not self.failures

    def report(self) -> str:
        mode = ("comparable" if self.comparable
                else "tiny-vs-full: relative time/ratio gates off")
        head = (f"# trajectory.diff: PR {self.baseline_pr} -> "
                f"PR {self.current_pr} ({mode})")
        return "\n".join([head] + [v.line() for v in self.verdicts])


def diff(baseline: dict, current: dict, policy: Policy = Policy(),
         metrics: Sequence[Metric] = METRICS) -> DiffResult:
    """Per-metric comparison of two BENCH records under ``policy``.

    Never raises on a regression — it returns the verdict list and the
    caller (a benchmark runner) decides to ``SystemExit`` on
    ``result.failures``, so library users can render diffs without
    aborting."""
    comparable = not (current.get("tiny") and not baseline.get("tiny"))
    fatal_regress = policy.on_regress == "fail"
    fatal_missing = policy.on_missing == "fail"
    verdicts: List[Verdict] = []
    for m in metrics:
        b, c = m.extract(baseline), m.extract(current)
        if b is None and c is None:
            verdicts.append(Verdict(m.name, "absent", None, None, False,
                                    "metric in neither record"))
            continue
        if c is None:
            verdicts.append(Verdict(
                m.name, "missing_current", b, None, fatal_missing,
                "baseline carries this metric; current dropped it"))
            continue
        # Absolute bounds gate every run, tiny included.
        if policy.gate_absolute:
            if m.ceiling is not None and c > m.ceiling:
                verdicts.append(Verdict(
                    m.name, "bound_breach", b, c, fatal_regress,
                    f"exceeds absolute ceiling {m.ceiling}"))
                continue
            if m.floor is not None and c < m.floor:
                verdicts.append(Verdict(
                    m.name, "bound_breach", b, c, fatal_regress,
                    f"under absolute floor {m.floor}"))
                continue
        if b is None:
            verdicts.append(Verdict(m.name, "new_metric", None, c, False,
                                    "first record carrying this metric"))
            continue
        if m.kind in ("time", "ratio") and not comparable:
            verdicts.append(Verdict(m.name, "not_comparable", b, c, False,
                                    "tiny run vs full baseline"))
            continue
        if not policy.gate_relative or m.rel_slack is None:
            verdicts.append(Verdict(
                m.name, "ok", b, c, False,
                "relative gates disabled" if m.rel_slack is not None
                else "absolute bound only"))
            continue
        w = m.worsening(b, c)
        slack = m.rel_slack * policy.slack_scale
        if w > slack:
            verdicts.append(Verdict(
                m.name, "regressed", b, c, fatal_regress,
                f"{w:+.0%} in the bad direction (slack {slack:.0%})"))
        elif w < 0:
            verdicts.append(Verdict(m.name, "improved", b, c, False,
                                    f"{-w:+.0%}"))
        else:
            verdicts.append(Verdict(m.name, "ok", b, c, False,
                                    f"{w:+.0%} within slack {slack:.0%}"))
    return DiffResult(baseline.get("pr"), current.get("pr"), comparable,
                      verdicts)


# ---------------------------------------------------------------------------
# Figures: trajectory small-multiples + accuracy-vs-speed frontier
# ---------------------------------------------------------------------------

# Colorblind-validated categorical slots (fixed assignment order, never
# cycled) + per-variant marker shapes as the secondary encoding, so
# identity is not carried by color alone.
_VARIANT_STYLE = (
    ("pixel", "#2a78d6", "o"),
    ("histogram", "#eb6834", "s"),
    ("spatial", "#1baf7a", "^"),
    ("vector", "#eda100", "D"),
)
_INK = "#333333"
_GRID = "#e3e3e3"


def _mpl():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except Exception:
        return None


def _style_axes(ax):
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(_GRID)
    ax.tick_params(colors=_INK, labelsize=8)
    ax.grid(True, color=_GRID, linewidth=0.6, alpha=0.8)
    ax.set_axisbelow(True)


def render_trajectory(ledger: Sequence[Tuple[int, dict]], out_path: str,
                      metrics: Sequence[Metric] = METRICS
                      ) -> Optional[str]:
    """The ledger as small multiples: one panel per metric (single blue
    series each — no legend needed), x = PR number. Returns the path
    written, or None when matplotlib is unavailable or the ledger has
    fewer than two records."""
    plt = _mpl()
    if plt is None or len(ledger) < 2:
        return None
    ss = series(ledger, metrics)
    panels = [(name, [(pr, v) for pr, v in pts if v is not None])
              for name, pts in ss.items()]
    panels = [(n, p) for n, p in panels if len(p) >= 2]
    if not panels:
        return None
    ncols = 3
    nrows = (len(panels) + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(3.4 * ncols, 2.4 * nrows))
    axes = [ax for row in (axes if nrows > 1 else [axes]) for ax in row]
    for ax in axes[len(panels):]:
        ax.set_visible(False)
    for ax, (name, pts) in zip(axes, panels):
        xs = [pr for pr, _ in pts]
        ys = [v for _, v in pts]
        ax.plot(xs, ys, color="#2a78d6", linewidth=2, marker="o",
                markersize=4)
        ax.annotate(f"{ys[-1]:.3g}", (xs[-1], ys[-1]),
                    textcoords="offset points", xytext=(4, 4),
                    fontsize=8, color=_INK)
        ax.set_title(name, fontsize=9, color=_INK)
        ax.set_xticks(xs)
        ax.set_xticklabels([f"pr{x}" for x in xs], fontsize=7)
        _style_axes(ax)
    fig.suptitle("Perf trajectory across committed BENCH records",
                 fontsize=11, color=_INK)
    fig.tight_layout(rect=(0, 0, 1, 0.96))
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def _pareto(points: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Non-dominated (wall_s, dsc) points, fastest first: a point is on
    the frontier when nothing is both at-least-as-fast and
    at-least-as-accurate (with one strict)."""
    front = []
    for x, y in sorted(points):
        if not front or y > front[-1][1]:
            front.append((x, y))
    return front


def render_frontier(bench: dict, out_path: str) -> Optional[str]:
    """Accuracy-vs-speed frontier from the sweep's solver cells: one
    point per (variant, backend, size) at batch=1 — mean DSC against
    fit wall-clock (log x). The paper's Table 3 / Fig. 7 live here as
    the sequential-vs-device pixel cells. Returns None when matplotlib
    is unavailable or no cell carries accuracy."""
    plt = _mpl()
    cells = [c for c in bench.get("sweep", {}).get("cells", [])
             if c.get("family") == "solver" and c.get("status") == "ok"
             and (c.get("accuracy") or {}).get("mean_dsc") is not None]
    if plt is None or not cells:
        return None
    fig, ax = plt.subplots(figsize=(7.0, 4.6))
    all_pts = []
    front = _pareto([(c["metrics"]["wall_s"], c["accuracy"]["mean_dsc"])
                     for c in cells])
    front_set = set(front)
    for variant, color, marker in _VARIANT_STYLE:
        vc = [c for c in cells if c["axes"].get("variant") == variant]
        if not vc:
            continue
        xs = [c["metrics"]["wall_s"] for c in vc]
        ys = [c["accuracy"]["mean_dsc"] for c in vc]
        all_pts += list(zip(xs, ys))
        ax.scatter(xs, ys, s=46, color=color, marker=marker,
                   label=variant, edgecolors="white", linewidths=1.2,
                   zorder=3)
        # Selective direct labels: only the non-dominated points get
        # named (labelling every cell collides where many hit DSC 1.0).
        for c, x, y in zip(vc, xs, ys):
            if (x, y) in front_set:
                front_set.discard((x, y))
                ax.annotate(
                    f"{variant} {c['axes'].get('backend', '')}"
                    f"/{c['axes'].get('size', '')}",
                    (x, y), textcoords="offset points", xytext=(5, 5),
                    fontsize=7, color=_INK)
    if len(front) > 1:
        ax.plot([x for x, _ in front], [y for _, y in front],
                color="#9a9a9a", linewidth=1.2, linestyle="--", zorder=2)
    ax.set_xscale("log")
    ax.set_xlabel("fit wall-clock (s, log)", fontsize=9, color=_INK)
    ax.set_ylabel("mean DSC vs phantom ground truth", fontsize=9,
                  color=_INK)
    ax.set_title("Variant-zoo accuracy-vs-speed frontier "
                 f"(PR {bench.get('pr')}, {bench.get('backend')})",
                 fontsize=11, color=_INK)
    ax.legend(frameon=False, fontsize=8, loc="lower left")
    _style_axes(ax)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
