"""The port's ``analysis/trajectory.py`` against the JAX package's, on
records built here (never the committed ``BENCH_pr*.json``): the same
public names, series with gaps and the derived overhead of a record that
predates its key, every ``diff`` status under each ``Policy`` knob with
equal verdicts and ``report()`` text, the ledger's files and baseline in
a temporary directory, the figures without matplotlib, and an
``OUT_DIR`` of the port's own."""
import json
import os

import pytest

from repro.analysis import trajectory as J
from repro_torch.analysis import trajectory as T

STATUSES = {"improved", "ok", "regressed", "bound_breach", "missing_current",
            "new_metric", "absent", "not_comparable"}


def _record(pr, **kw):
    """A BENCH-shaped record; ``kw`` fills the histogram B=64 cell, the
    spatial cell and the other sections by name."""
    hist = {k: kw[k] for k in ("engine_s", "batched_s", "speedup_batched_vs_seq",
                               "engine_overhead_vs_batched",
                               "tracing_overhead_ratio") if k in kw}
    rec = {"pr": pr, "backend": "cpu",
           "batched_throughput": {"histogram": {"64": hist}}}
    if "mean_iters" in kw:
        rec["batched_throughput"]["histogram"]["convergence"] = {
            "mean_iters": kw["mean_iters"]}
    if "spatial_speedup" in kw:
        rec["batched_throughput"]["spatial"] = {
            "speedup_batched_vs_one_at_a_time": kw["spatial_speedup"],
            "engine_s": 2.0, "batched_s": 1.0}
    if "parity" in kw:
        rec["superpixel_fcm"] = {"dsc_parity_max_delta": kw["parity"],
                                 "speedup_fit": 3.0}
    if "dsc" in kw:
        plain, spatial = kw["dsc"]
        rec["spatial_fcm"] = {"levels": [{"fits": {
            "plain": {"dsc": {"WM": plain}},
            "spatial_ref": {"dsc": {"WM": spatial}}}}]}
    if "qps" in kw:
        rec["load_gen"] = {"sustained": {"achieved_qps": kw["qps"],
                                         "p99_s": 0.05},
                           "qps_ratio_vs_sync": kw.get("ratio", 3.0)}
    if kw.get("tiny"):
        rec["tiny"] = True
    return rec


#: the baseline: the pre-PR-4 shape (no overhead key), a spatial cell
BASE = _record(4, engine_s=1.0, batched_s=0.5, speedup_batched_vs_seq=4.0,
               tracing_overhead_ratio=1.1, mean_iters=10.0,
               spatial_speedup=6.0, dsc=(0.80, 0.90))
#: engine_s 2x (regressed), batched_s faster (improved), the overhead's
#: explicit key past its ceiling (bound_breach), the spatial cell
#: dropped (missing_current), superpixel parity first seen (new_metric),
#: mean_iters and tracing unchanged (ok), load_gen in neither (absent)
CUR = _record(5, engine_s=2.0, batched_s=0.4, speedup_batched_vs_seq=4.0,
              engine_overhead_vs_batched=6.0, tracing_overhead_ratio=1.1,
              mean_iters=10.0, parity=0.01, dsc=(0.80, 0.89))
#: a tiny run against the full baseline (not_comparable)
TINY = dict(CUR, tiny=True, pr=6)
#: a tiny run with a floor breached and a ratio under its floor
TINY_LOW = _record(7, engine_s=0.1, batched_s=0.1, spatial_speedup=2.0,
                   qps=10.0, ratio=1.5, tiny=True)

POLICIES = {
    "default": T.Policy(),
    "warn": T.Policy(on_regress="warn", on_missing="warn"),
    "missing_warn": T.Policy(on_missing="warn"),
    "no_relative": T.Policy(gate_relative=False),
    "no_absolute": T.Policy(gate_absolute=False),
    "loose": T.Policy(slack_scale=2.0),
}


def _jax_policy(p):
    return J.Policy(**{f: getattr(p, f) for f in
                       ("on_regress", "on_missing", "gate_relative",
                        "gate_absolute", "slack_scale")})


def _verdicts(res):
    return [(v.metric, v.status, v.baseline, v.current, v.fatal, v.detail)
            for v in res.verdicts]


def _public(mod):
    return {n for n in vars(mod) if not n.startswith("_")}


def test_same_public_names():
    assert _public(T) == _public(J)
    assert T.__all__ == J.__all__
    assert [m.name for m in T.METRICS] == [m.name for m in J.METRICS]
    for t, j in zip(T.METRICS, J.METRICS):
        assert (t.direction, t.kind, t.rel_slack, t.ceiling, t.floor) == \
            (j.direction, j.kind, j.rel_slack, j.ceiling, j.floor), t.name


def test_series_with_gaps_and_a_derived_overhead():
    mid = _record(6, batched_s=0.45, qps=12.0)       # no engine_s: a gap
    ledger = [(4, BASE), (5, CUR), (6, mid), (7, TINY_LOW)]
    got = T.series(ledger)
    assert got == J.series(ledger, J.METRICS)
    # the pre-PR-4 record derives engine_s / batched_s; the later one
    # carries its explicit key
    assert got["engine_overhead_b64"][:2] == [(4, 2.0), (5, 6.0)]
    assert got["engine_s_b64"][2] == (6, None)
    assert [pr for pr, _ in got["load_sustained_qps"]] == [4, 5, 6, 7]
    assert got["load_sustained_qps"][0] == (4, None)
    assert got["spatial_dsc_gain_wm"][0][1] == pytest.approx(0.10)


@pytest.mark.parametrize("pair", ["full", "tiny", "tiny_low", "same"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_diff_equals_the_jax_module(pair, policy):
    base, cur = {"full": (BASE, CUR), "tiny": (BASE, TINY),
                 "tiny_low": (BASE, TINY_LOW), "same": (BASE, BASE)}[pair]
    p = POLICIES[policy]
    got, want = T.diff(base, cur, p), J.diff(base, cur, _jax_policy(p))
    assert _verdicts(got) == _verdicts(want)
    assert (got.baseline_pr, got.current_pr, got.comparable, got.ok) == \
        (want.baseline_pr, want.current_pr, want.comparable, want.ok)
    assert got.report() == want.report()
    assert [v.metric for v in got.failures] == \
        [v.metric for v in want.failures]


def test_diff_reaches_every_status():
    seen = set()
    for p in POLICIES.values():
        for base, cur in ((BASE, CUR), (BASE, TINY), (BASE, TINY_LOW)):
            seen |= {v.status for v in T.diff(base, cur, p).verdicts}
    assert seen == STATUSES
    by = {v.metric: v for v in T.diff(BASE, CUR).verdicts}
    assert by["engine_s_b64"].status == "regressed" and by[
        "engine_s_b64"].fatal
    assert by["batched_s_b64"].status == "improved"
    assert by["engine_overhead_b64"].status == "bound_breach"
    assert by["spatial_batched_speedup"].status == "missing_current"
    assert by["superpixel_dsc_parity"].status == "new_metric"
    assert by["load_sustained_qps"].status == "absent"
    assert T.diff(BASE, BASE).ok and not T.diff(BASE, BASE).failures
    warn = T.diff(BASE, CUR, POLICIES["warn"])
    assert warn.ok and {v.status for v in warn.verdicts} >= {
        "regressed", "bound_breach", "missing_current"}
    tiny = {v.metric: v.status for v in T.diff(BASE, TINY).verdicts}
    assert tiny["engine_s_b64"] == "not_comparable"
    assert tiny["engine_overhead_b64"] == "bound_breach"


def test_ledger_paths_and_baseline_in_a_directory(tmp_path):
    for pr in (2, 10, 7):
        (tmp_path / f"BENCH_pr{pr}.json").write_text(
            json.dumps(_record(pr, engine_s=float(pr))))
    (tmp_path / "BENCH_prx.json").write_text("{}")
    (tmp_path / "notes.json").write_text("{}")
    d = str(tmp_path)
    got = T.ledger_paths(d)
    assert got == J.ledger_paths(d)
    assert [pr for pr, _ in got] == [2, 7, 10]
    assert T.load_ledger(d) == J.load_ledger(d)
    assert T.load_bench(got[0][1]) == J.load_bench(got[0][1])
    for before in (None, 11, 10, 7, 3, 2):
        assert T.resolve_baseline(d, before) == J.resolve_baseline(d, before)
    assert T.resolve_baseline(d).endswith("BENCH_pr10.json")
    assert T.resolve_baseline(d, before=10).endswith("BENCH_pr7.json")
    assert T.resolve_baseline(d, before=2) is None
    empty = tmp_path / "empty"
    empty.mkdir()
    assert T.ledger_paths(str(empty)) == [] and T.resolve_baseline(
        str(empty)) is None
    assert T.resolve_baseline(str(tmp_path / "absent")) is None


def test_figures_none_without_matplotlib(monkeypatch, tmp_path):
    monkeypatch.setattr(T, "_mpl", lambda: None)
    ledger = [(4, BASE), (5, CUR)]
    assert T.render_trajectory(ledger, str(tmp_path / "t.png")) is None
    sweep = {"pr": 5, "backend": "cuda", "sweep": {"cells": [
        {"family": "solver", "status": "ok", "axes": {"variant": "pixel"},
         "metrics": {"wall_s": 0.1}, "accuracy": {"mean_dsc": 0.9}}]}}
    assert T.render_frontier(sweep, str(tmp_path / "f.png")) is None
    assert not any(tmp_path.iterdir())


def test_out_dir_is_the_ports_own():
    assert os.path.normpath(T.OUT_DIR) != os.path.normpath(J.OUT_DIR)
    assert os.path.basename(T.OUT_DIR) == "out_torch"
    assert os.path.dirname(T.OUT_DIR) == os.path.dirname(J.OUT_DIR)
    assert all(p.startswith(T.OUT_DIR) for _, p in T.ledger_paths())
