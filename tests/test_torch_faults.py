"""Chaos on the port's engine, on the CPU (``device="cpu"``).

Each case of the JAX package's ``tests/test_faults.py`` runs here against
``repro_torch``: under injected failures (launch errors, NaN/Inf lanes,
flusher death, overload) every request resolves exactly once, with a
result or a typed error, and degraded paths stay within 1e-5 of the
clean run. The cases of ``tests/test_masked_lanes.py`` that the port's
core tests do not cover follow. Then the port is held against the JAX
engine on the same seeded phantoms, clean and under one
:class:`FaultPlan`: each request's outcome, ``n_iters`` and
``converged``, centers within rtol 1e-5 / atol 1e-4, equal labels and
the fault-tolerance counters. Last, a kernel that fails to build or to
launch (a fake library) reaches the caller and never enters the ladder,
and ``Span.fence`` synchronizes the card that holds the value.

Every engine is shut down by a fixture; every ``result()`` has a
timeout.
"""
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro_torch import faults as FI
from repro_torch.core import fcm as F
from repro_torch.core import solver as SV
from repro_torch.data import phantom
from repro_torch.kernels import _build
from repro_torch.kernels import histogram_bin as KB
from repro_torch.obs import tracing as TR
from repro_torch.serving import (FCMServeEngine, InvalidInput, Overloaded,
                                 SolveFailed)
from repro_torch.serving import fcm_engine as TE

CFG = F.FCMConfig(max_iters=100)
ATOL = 1e-5
RTOL_J, ATOL_J = 1e-5, 1e-4
WAIT = 60.0
CPU = torch.device("cpu")


def _imgs(n, size=20):
    return [phantom.phantom_slice(size, size, noise=4.0 + (i % 3),
                                  seed=300 + i)[0] for i in range(n)]


@pytest.fixture
def make_engine():
    made = []

    def make(cfg=CFG, **kw):
        kw.setdefault("cache_size", 0)
        kw.setdefault("batch_sizes", (1, 4))
        kw.setdefault("retry_backoff_s", 1e-3)
        kw.setdefault("breaker_cooldown_s", 0.05)
        eng = FCMServeEngine(cfg, device="cpu", **kw)
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.shutdown(drain=False)
        assert eng._flusher is None or not eng._flusher.is_alive()


@pytest.fixture
def clean_run(make_engine):
    def run(imgs):
        eng = make_engine()
        for im in imgs:
            eng.submit(im)
        return {r.request_id: r for r in eng.flush()}
    return run


@pytest.fixture(autouse=True)
def _no_global_injector():
    # A test that installs the process-global injector never leaks it.
    yield
    FI.clear()


# -- plan / injector unit behavior -------------------------------------------

def test_fault_spec_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FI.FaultSpec(site="launch", kind="segfault")


def test_window_firing_is_deterministic():
    spec = FI.FaultSpec(site="launch", kind="error", after=2, times=3)
    inj = FI.FaultInjector(FI.FaultPlan(seed=0, specs=(spec,)))
    outcomes = []
    for _ in range(8):
        try:
            inj.maybe_fail("launch")
            outcomes.append(False)
        except FI.InjectedFault:
            outcomes.append(True)
    assert outcomes == [False, False, True, True, True, False, False, False]
    assert inj.snapshot() == {"seed": 0, "injected": 3,
                              "by_site": {"launch": 3}, "chaos": True}


def test_probabilistic_firing_replays_with_same_seed():
    from repro import faults as JFI

    def pattern(mod, seed):
        s = mod.FaultSpec(site="launch", kind="error", p=0.5, times=None)
        inj = mod.FaultInjector(mod.FaultPlan(seed=seed, specs=(s,)))
        out = []
        for _ in range(64):
            try:
                inj.maybe_fail("launch")
                out.append(0)
            except mod.InjectedFault:
                out.append(1)
        return out

    a, b = pattern(FI, 7), pattern(FI, 7)
    assert a == b                       # same seed => same chaos
    assert 0 < sum(a) < 64
    assert pattern(FI, 8) != a
    assert pattern(JFI, 7) == a         # and the JAX package's chaos


def test_route_filter_and_corrupt_lanes():
    plan = FI.FaultPlan(seed=0, specs=(
        FI.FaultSpec(site="solve", kind="nan", route="histogram",
                     lanes=(1, 3)),))
    inj = FI.FaultInjector(plan)
    arr = np.zeros((4, 4), np.float32)
    assert inj.corrupt("solve", arr, route="pixel") is arr
    out = inj.corrupt("solve", arr, route="histogram")
    assert np.isnan(out[1]).all() and np.isnan(out[3]).all()
    assert np.isfinite(out[0]).all() and np.isfinite(out[2]).all()
    assert np.isfinite(arr).all()       # input never mutated


def test_corrupt_poisons_a_tensor_on_a_clone():
    inj = FI.FaultInjector(FI.FaultPlan(seed=0, specs=(
        FI.FaultSpec(site="solve_batched", kind="inf", lanes=(0, 9)),)))
    t = torch.zeros((3, 2))
    out = inj.corrupt("solve_batched", t)
    assert isinstance(out, torch.Tensor) and out.device == t.device
    assert torch.isinf(out[0]).all() and torch.isfinite(out[1:]).all()
    assert torch.isfinite(t).all()
    assert inj.corrupt("solve_batched", t) is t   # times=1: spent


def test_latency_injection_sleeps_then_succeeds():
    plan = FI.FaultPlan(seed=0, specs=(
        FI.FaultSpec(site="ingest", kind="latency", latency_s=0.05),))
    inj = FI.FaultInjector(plan)
    t0 = time.perf_counter()
    inj.maybe_fail("ingest")
    assert time.perf_counter() - t0 >= 0.04
    assert inj.snapshot()["by_site"] == {"ingest": 1}


# -- transient launch failure: retry absorbs it ------------------------------

def test_transient_launch_failure_retried_to_parity(make_engine, clean_run):
    imgs = _imgs(2)
    clean = clean_run(imgs)
    plan = FI.FaultPlan(seed=3, specs=(
        FI.FaultSpec(site="launch", kind="error", route="histogram",
                     times=1),))
    eng = make_engine(faults=plan, retries=2)
    for im in imgs:
        eng.submit(im)
    res = {r.request_id: r for r in eng.flush()}
    st = eng.stats()
    assert st["fault_tolerance"]["retries"]["histogram"] == 1
    assert st["fault_tolerance"]["degraded"]["histogram"] == 0
    assert st["fault_tolerance"]["breaker_state"].get(
        "histogram", "closed") == "closed"
    assert st["faults"]["injected"] == 1 and st["faults"]["chaos"]
    for i in clean:
        np.testing.assert_array_equal(res[i].centers, clean[i].centers)


# -- persistent launch failure: breaker trips, reference fallback ------------

def test_breaker_trips_and_reference_fallback_matches(make_engine,
                                                      clean_run):
    imgs = _imgs(1)
    clean = clean_run(imgs)
    plan = FI.FaultPlan(seed=5, specs=(
        FI.FaultSpec(site="launch", kind="error", route="histogram",
                     times=None),))
    eng = make_engine(faults=plan, retries=1, breaker_threshold=2,
                      breaker_cooldown_s=1000.0)
    last = None
    for _ in range(4):
        eng.submit(imgs[0])
        last = eng.flush()[0]
    ft = eng.stats()["fault_tolerance"]
    assert ft["breaker_state"]["histogram"] == "open"
    assert ft["breaker_trips"]["histogram"] == 1
    # Flushes 1-2 burn a retry each and degrade; once open, flushes 3-4
    # go straight to the plain solver without touching the program.
    assert ft["retries"]["histogram"] == 2
    assert ft["degraded"]["histogram"] == 2
    np.testing.assert_allclose(last.centers, clean[0].centers, atol=ATOL)
    assert last.n_iters == clean[0].n_iters
    assert (last.labels == clean[0].labels).all()
    assert not eng.readiness()["ready"]     # open breaker = not ready
    assert eng.healthy()                    # ...but degraded, not dead


def test_breaker_half_open_probe_recovers(make_engine):
    imgs = _imgs(1)
    plan = FI.FaultPlan(seed=5, specs=(
        FI.FaultSpec(site="launch", kind="error", route="histogram",
                     times=1),))
    eng = make_engine(faults=plan, retries=0, breaker_threshold=1,
                      breaker_cooldown_s=0.0)
    eng.submit(imgs[0])
    eng.flush()                           # fails -> trips open
    assert eng.stats()["fault_tolerance"]["breaker_state"][
        "histogram"] == "open"
    eng.submit(imgs[0])
    eng.flush()                           # cooldown 0: half-open probe, OK
    st = eng.stats()["fault_tolerance"]
    assert st["breaker_state"]["histogram"] == "closed"
    assert st["breaker_trips"]["histogram"] == 1
    assert eng.readiness()["ready"]


def test_half_open_probe_failure_reopens(make_engine):
    imgs = _imgs(1)
    plan = FI.FaultPlan(seed=5, specs=(
        FI.FaultSpec(site="launch", kind="error", route="histogram",
                     times=None),))
    eng = make_engine(faults=plan, retries=0, breaker_threshold=1,
                      breaker_cooldown_s=0.0)
    eng.submit(imgs[0])
    eng.flush()                           # trip
    eng.submit(imgs[0])
    eng.flush()                           # probe fails -> re-open
    st = eng.stats()["fault_tolerance"]
    assert st["breaker_state"]["histogram"] == "open"
    assert st["breaker_trips"]["histogram"] == 2


# -- NaN/Inf poisoning: per-lane salvage -------------------------------------

@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_poisoned_lane_salvaged_healthy_lanes_bitwise(make_engine,
                                                      clean_run, kind):
    imgs = _imgs(4)
    clean = clean_run(imgs)
    plan = FI.FaultPlan(seed=11, specs=(
        FI.FaultSpec(site="solve", kind=kind, route="histogram",
                     lanes=(1,), times=1),))
    eng = make_engine(faults=plan, batch_sizes=(4,))
    for im in imgs:
        eng.submit(im)
    res = {r.request_id: r for r in eng.flush()}
    assert len(res) == 4
    for r in res.values():
        assert np.isfinite(r.centers).all()
    for i in (0, 2, 3):                   # batchmates bitwise untouched
        np.testing.assert_array_equal(res[i].centers, clean[i].centers)
        assert (res[i].labels == clean[i].labels).all()
    np.testing.assert_allclose(res[1].centers, clean[1].centers, atol=ATOL)
    assert eng.stats()["fault_tolerance"]["salvaged"]["histogram"] == 1


def test_salvaged_centers_never_enter_cache(make_engine):
    img = _imgs(1)[0]
    plan = FI.FaultPlan(seed=11, specs=(
        FI.FaultSpec(site="solve", kind="nan", route="histogram",
                     lanes=(0,), times=1),))
    eng = make_engine(cache_size=16, faults=plan)
    eng.submit(img)
    r1 = eng.flush()[0]
    assert np.isfinite(r1.centers).all() and not r1.cache_hit
    # The salvage caches the clean reference centers, never the poison.
    eng.submit(img.copy())
    r2 = eng.flush()[0]
    assert r2.cache_hit
    np.testing.assert_array_equal(r2.centers, r1.centers)


def test_solver_level_corruption_salvaged_via_global_injector():
    rng = np.random.default_rng(0)
    hists = torch.from_numpy(rng.integers(0, 50, (3, 256)).astype(
        np.float32))
    batch = SV.batch_problems(TE.hist_rows(hists), hists, cfg=CFG,
                              device=CPU)
    clean = SV.solve_batched(batch, CFG)
    FI.install(FI.FaultPlan(seed=13, specs=(
        FI.FaultSpec(site="solve_batched", kind="nan", lanes=(2,),
                     times=1),)))
    try:
        res = SV.solve_batched(batch, CFG)
    finally:
        FI.clear()
    assert torch.isfinite(res.centers).all()
    assert res.salvaged.tolist() == [False, False, True]
    assert res.healthy.all()
    np.testing.assert_allclose(res.centers.numpy(), clean.centers.numpy(),
                               atol=ATOL)
    np.testing.assert_array_equal(res.centers.numpy()[:2],
                                  clean.centers.numpy()[:2])


def test_solve_batched_salvage_opt_out():
    rng = np.random.default_rng(0)
    hists = torch.from_numpy(rng.integers(0, 50, (2, 256)).astype(
        np.float32))
    batch = SV.batch_problems(TE.hist_rows(hists), hists, cfg=CFG,
                              device=CPU)
    FI.install(FI.FaultPlan(seed=13, specs=(
        FI.FaultSpec(site="solve_batched", kind="nan", lanes=(0,),
                     times=1),)))
    try:
        res = SV.solve_batched(batch, CFG, salvage=False)
    finally:
        FI.clear()
    assert not res.healthy[0] and res.healthy[1]
    assert not torch.isfinite(res.centers[0]).all()


def test_kernel_site_injection_raises_typed():
    from repro_torch.kernels import ops as kops
    inj = FI.install(FI.FaultPlan(seed=0, specs=(
        FI.FaultSpec(site="kernel", kind="error", route="flat/reference",
                     times=1),)))
    try:
        kops.select_step("flat", platform="cpu")      # another route
        with pytest.raises(FI.InjectedFault, match="flat/reference"):
            kops.select_step("flat", prefer="reference", platform="cpu")
    finally:
        FI.clear()
    assert inj.snapshot()["by_site"] == {"kernel": 1}
    kops.select_step("flat", prefer="reference", platform="cpu")


# -- flusher death ------------------------------------------------------------

def test_flusher_kill_restarts_and_resolves_all(make_engine):
    plan = FI.FaultPlan(seed=2, specs=(
        FI.FaultSpec(site="flusher", kind="kill", times=1),))
    eng = make_engine(faults=plan, max_wait_ms=5.0)
    futs = [eng.submit_async(im) for im in _imgs(3)]
    for f in futs:
        assert np.isfinite(f.result(timeout=WAIT).centers).all()
    assert eng._flusher_kills == 1
    st = eng.stats()["fault_tolerance"]
    assert st["flusher_kills"] == 1 and st["flusher_restarts"] >= 1
    rd = eng.readiness()
    assert rd["healthy"] and rd["flusher_restarts"] >= 1


def test_flusher_survives_repeated_kills(make_engine):
    plan = FI.FaultPlan(seed=2, specs=(
        FI.FaultSpec(site="flusher", kind="kill", times=3),))
    eng = make_engine(faults=plan, max_wait_ms=5.0)
    for im in _imgs(3):
        fut = eng.submit_async(im)
        assert np.isfinite(fut.result(timeout=WAIT).centers).all()
    assert eng._flusher_kills >= 1


# -- overload shedding --------------------------------------------------------

def test_overload_sheds_lowest_urgency_with_typed_error(make_engine):
    imgs = _imgs(3)
    eng = make_engine(max_queue_depth=2, max_wait_ms=100_000.0)
    loose = eng.submit_async(imgs[0], deadline=100.0)
    mid = eng.submit_async(imgs[1], deadline=50.0)
    tight = eng.submit_async(imgs[2], deadline=10.0)  # displaces `loose`
    assert loose.done() and isinstance(loose.exception(), Overloaded)
    assert not mid.done() and not tight.done()
    assert eng.stats()["fault_tolerance"]["shed"]["histogram"] == 1
    eng.drain()
    assert mid.result(timeout=WAIT).labels.shape == imgs[1].shape
    assert tight.result(timeout=WAIT).labels.shape == imgs[2].shape


def test_overload_rejects_incoming_when_least_urgent(make_engine):
    imgs = _imgs(3)
    eng = make_engine(max_queue_depth=2, max_wait_ms=100_000.0)
    a = eng.submit_async(imgs[0], deadline=5.0)
    b = eng.submit_async(imgs[1], deadline=5.0)
    lazy = eng.submit_async(imgs[2])                 # no deadline
    assert lazy.done() and isinstance(lazy.exception(), Overloaded)
    assert not a.done() and not b.done()
    eng.drain()
    for f in (a, b):
        assert f.result(timeout=WAIT) is not None


def test_sync_submit_never_shed(make_engine):
    imgs = _imgs(3)
    eng = make_engine(max_queue_depth=1, max_wait_ms=100_000.0)
    for im in imgs:
        eng.submit(im)
    assert len(eng.flush()) == 3


# -- input validation at ingest ----------------------------------------------

def test_nan_payload_rejected_sync_and_async(make_engine):
    eng = make_engine()
    bad = np.full((8, 8), np.nan, np.float32)
    with pytest.raises(InvalidInput):
        eng.submit(bad)
    before = eng._next_id
    fut = eng.submit_async(bad)
    assert fut.done() and isinstance(fut.exception(), InvalidInput)
    assert eng._next_id == before
    assert eng.queue_depth == 0
    assert eng.stats()["fault_tolerance"]["invalid_input"]["histogram"] == 2


def test_empty_and_inf_payloads_rejected(make_engine):
    eng = make_engine()
    with pytest.raises(InvalidInput):
        eng.submit(np.zeros((0, 0), np.uint8))
    with pytest.raises(InvalidInput):
        eng.submit(np.array([[np.inf, 1.0]], np.float32), method="pixel")
    eng.submit(_imgs(1)[0])
    assert len(eng.flush()) == 1
    ft = eng.stats()["fault_tolerance"]["invalid_input"]
    assert ft["histogram"] == 1 and ft["pixel"] == 1


def test_ingest_fault_rejected_before_id_allocation(make_engine):
    plan = FI.FaultPlan(seed=0, specs=(
        FI.FaultSpec(site="ingest", kind="error", times=1),))
    eng = make_engine(faults=plan)
    img = _imgs(1)[0]
    before = eng._next_id
    fut = eng.submit_async(img)
    assert fut.done() and isinstance(fut.exception(), FI.InjectedFault)
    assert eng._next_id == before
    ok = eng.submit_async(img)
    eng.drain()
    assert np.isfinite(ok.result(timeout=WAIT).centers).all()


# -- degenerate solves --------------------------------------------------------

def test_constant_image_zero_variance(make_engine):
    img = np.full((16, 16), 97, np.uint8)
    eng = make_engine()
    eng.submit(img)
    r = eng.flush()[0]
    assert np.isfinite(r.centers).all()
    assert (r.labels >= 0).all() and (r.labels < CFG.n_clusters).all()


def test_more_clusters_than_distinct_values(make_engine):
    img = np.where(np.indices((12, 12)).sum(0) % 2 == 0, 10, 200
                   ).astype(np.uint8)
    eng = make_engine(F.FCMConfig(n_clusters=6, max_iters=100))
    eng.submit(img)
    r = eng.flush()[0]
    assert np.isfinite(r.centers).all() and r.centers.shape == (6,)
    assert len(np.unique(r.labels)) == 2


def test_constant_lane_inside_mixed_batch(make_engine, clean_run):
    imgs = _imgs(3) + [np.full((20, 20), 42, np.uint8)]
    clean = clean_run(imgs[:3])
    eng = make_engine(batch_sizes=(4,))
    for im in imgs:
        eng.submit(im)
    res = {r.request_id: r for r in eng.flush()}
    assert all(np.isfinite(r.centers).all() for r in res.values())
    for i in range(3):
        np.testing.assert_array_equal(res[i].centers, clean[i].centers)


# -- convergence / health signals on results ---------------------------------

def test_result_reports_nonconvergence_honestly(make_engine):
    eng = make_engine(F.FCMConfig(max_iters=2))
    eng.submit(_imgs(1, size=32)[0])
    r = eng.flush()[0]
    assert r.converged is False
    assert np.isfinite(r.centers).all()


def test_solve_result_converged_flag():
    img, _ = phantom.phantom_slice(24, 24, seed=9)
    ok = SV.solve(SV.histogram_problem(img, CFG, device=CPU), CFG)
    assert ok.converged and ok.healthy
    capped = SV.solve(SV.histogram_problem(img, CFG, device=CPU),
                      max_iters=1)
    assert not capped.converged and capped.healthy


# -- provenance: injected runs cannot pose as clean ---------------------------

def test_faults_bench_section_schema():
    from benchmarks import bench_schema as BS
    BS.check_faults_section(FI.clean_snapshot())
    inj = FI.FaultInjector(FI.FaultPlan(seed=1, specs=(
        FI.FaultSpec(site="launch", kind="error"),)))
    with pytest.raises(FI.InjectedFault):
        inj.maybe_fail("launch")
    BS.check_faults_section(inj.snapshot())
    with pytest.raises(ValueError, match="masquerade|pose as a clean"):
        BS.check_faults_section({"seed": 1, "injected": 2,
                                 "by_site": {"launch": 2},
                                 "chaos": False})


def test_engine_stats_carry_faults_provenance(make_engine):
    eng = make_engine()
    assert eng.stats()["faults"] == FI.clean_snapshot()
    plan = FI.FaultPlan(seed=9, specs=(
        FI.FaultSpec(site="launch", kind="error", times=1),))
    eng2 = make_engine(faults=plan, retries=1)
    eng2.submit(_imgs(1)[0])
    eng2.flush()
    snap = eng2.stats()["faults"]
    assert snap["chaos"] and snap["seed"] == 9 and snap["injected"] == 1


# -- every future resolves under concurrent chaos -----------------------------

def test_chaotic_async_storm_every_future_resolves_once(make_engine):
    plan = FI.FaultPlan(seed=42, specs=(
        FI.FaultSpec(site="launch", kind="error", p=0.4, times=None),
        FI.FaultSpec(site="flusher", kind="kill", after=1, times=1),))
    eng = make_engine(faults=plan, retries=1, breaker_threshold=2,
                      breaker_cooldown_s=0.01, max_wait_ms=5.0)
    imgs = _imgs(10)
    futs = []

    def submitter(i):
        futs.append(eng.submit_async(imgs[i]))

    threads = [threading.Thread(target=submitter, args=(i,))
               for i in range(len(imgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    for f in futs:
        assert np.isfinite(f.result(timeout=WAIT).centers).all()
    assert len(futs) == len(imgs)
    eng.shutdown()
    assert eng.stats()["pending_futures"] == 0


# -- masked lanes (tests/test_masked_lanes.py cases the core tests lack) ------

def _ragged_hists(n=3, size=40):
    imgs = [phantom.phantom_slice(size + 8 * z, size, noise=4.0,
                                  slice_pos=0.3 + 0.1 * z, seed=z)[0]
            for z in range(n)]
    return np.stack([np.bincount(im.ravel(), minlength=256).astype(
        np.float32) for im in imgs])


def _flat(hists, **kw):
    h = torch.from_numpy(hists)
    feats = TE.hist_rows(h)[..., None]
    return SV.flat_batched_solve(feats, h, 4, 2.0, 1e-4, 300, **kw)


def test_masked_while_inactive_lanes_frozen():
    v0 = torch.tensor([[0.0, 1.0], [5.0, 9.0]])
    step = lambda v: v * 0.5 + 1.0            # noqa: E731
    tol = torch.tensor([1e-6, 1e-6])
    v, delta, iters, total = SV.masked_while_centers(
        step, v0, tol, 50, active=torch.tensor([True, False]))
    np.testing.assert_array_equal(v[1].numpy(), v0[1].numpy())
    assert int(iters[1]) == 0 and float(delta[1]) == 0.0
    v_solo, _, it_solo, _ = SV.masked_while_centers(step, v0[:1], tol[:1],
                                                    50)
    np.testing.assert_array_equal(v[0].numpy(), v_solo[0].numpy())
    assert int(iters[0]) == int(it_solo[0]) == int(total)


def test_masked_none_is_bitwise_preexisting_behavior():
    hists = _ragged_hists()
    a = _flat(hists)
    b = _flat(hists, active=torch.ones(hists.shape[0], dtype=torch.bool))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_flat_batched_padding_lanes_cannot_perturb_real_lanes():
    hists = _ragged_hists()
    spike = np.zeros((1, 256), np.float32)
    spike[0, 0] = 1e6                         # an adversarial padding lane
    active = torch.tensor([True] * hists.shape[0] + [False])
    v_ref, _, it_ref, tot_ref = _flat(hists)
    v, _, it, tot = _flat(np.concatenate([hists, spike]), active=active)
    np.testing.assert_array_equal(v[:-1].numpy(), v_ref.numpy())
    np.testing.assert_array_equal(it[:-1].numpy(), it_ref.numpy())
    assert int(it[-1]) == 0 and int(tot) == int(tot_ref)


def test_solve_batched_parity_on_padded_ragged_batch():
    hists = _ragged_hists(5)
    h = torch.from_numpy(hists)
    ref = SV.solve_batched(SV.batch_problems(TE.hist_rows(h), h, cfg=CFG,
                                             device=CPU),
                           backend="reference")
    padded = np.concatenate([hists, np.ones((3, 256), np.float32)])
    active = torch.tensor([True] * 5 + [False] * 3)
    v, _, iters, _ = SV.flat_batched_solve(
        TE.hist_rows(torch.from_numpy(padded))[..., None],
        torch.from_numpy(padded), CFG.n_clusters, CFG.m, CFG.eps,
        CFG.max_iters, active=active)
    np.testing.assert_allclose(v[:5, :, 0].numpy(), ref.centers.numpy(),
                               atol=1e-5)
    np.testing.assert_array_equal(iters[:5].numpy(), ref.n_iters)


def test_resident_impls_reject_active_mask():
    hists = _ragged_hists(2)
    for impl in ("resident", "resident_streamed"):
        with pytest.raises(ValueError, match="reference impl only"):
            _flat(hists, impl=impl, active=torch.ones(2, dtype=torch.bool))


# -- the port against the JAX engine, clean and under one FaultPlan ----------

FT_KEYS = ("retries", "degraded", "salvaged", "breaker_trips", "shed",
           "invalid_input")


def _jax_engine(**kw):
    from repro.core.fcm import FCMConfig
    from repro.serving.fcm_engine import FCMServeEngine as JAXEngine
    return JAXEngine(FCMConfig(n_clusters=CFG.n_clusters, m=CFG.m,
                               eps=CFG.eps, max_iters=CFG.max_iters), **kw)


def _traffic(eng, deep=False):
    """One seeded request mix through an engine: histogram and pixel
    requests, an already-expired deadline, a far deadline, a NaN payload
    and, with ``deep``, an overload burst. Returns the outcomes in submit
    order and the engine."""
    imgs = _imgs(7)
    bad = np.full((20, 20), np.nan, np.float32)
    futs = [eng.submit_async(imgs[0]),
            eng.submit_async(imgs[1], deadline=1e6),
            eng.submit_async(imgs[2], deadline=0.0),
            eng.submit_async(bad),
            eng.submit_async(imgs[3], method="pixel"),
            eng.submit_async(imgs[4], method="pixel", deadline=1e6)]
    eng.drain()
    futs += [eng.submit_async(imgs[5]), eng.submit_async(imgs[6])]
    if deep:
        futs += [eng.submit_async(im, deadline=1e6) for im in imgs[:3]]
    eng.drain()
    return [f.exception() if f.exception() is not None
            else f.result(timeout=WAIT) for f in futs]


def _assert_same_outcomes(jout, tout, jeng, teng):
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        if isinstance(j, BaseException):
            assert type(t).__name__ == type(j).__name__, (j, t)
            continue
        assert not isinstance(t, BaseException), (j, t)
        assert t.n_iters == j.n_iters and t.converged == j.converged
        np.testing.assert_allclose(t.centers, np.asarray(j.centers),
                                   rtol=RTOL_J, atol=ATOL_J)
        np.testing.assert_array_equal(t.labels, np.asarray(j.labels))
    js, ts = jeng.stats(), teng.stats()
    for k in FT_KEYS:
        assert ts["fault_tolerance"][k] == js["fault_tolerance"][k], k
    assert ts["deadline_expired"] == js["deadline_expired"]
    assert ts["faults"]["injected"] == js["faults"]["injected"]
    assert ts["faults"]["by_site"] == js["faults"]["by_site"]


@pytest.mark.parametrize("chaos", [False, True], ids=["clean", "faulted"])
def test_async_outcomes_and_counters_match_jax_engine(make_engine, chaos):
    """The same seeded requests and the same FaultPlan through both
    engines: two transient launch errors (retried), then launch errors
    past the retries that trip the histogram breaker (its chunks
    degrade to the plain solver), a NaN lane at the solve site
    (salvaged), an injected ingest fault and, with max_queue_depth, a
    shed request."""
    from repro import faults as JFI

    def specs(mod):
        if not chaos:
            return ()
        return (mod.FaultSpec(site="launch", kind="error", route="pixel",
                              times=2),
                mod.FaultSpec(site="launch", kind="error",
                              route="histogram", after=1, times=None),
                mod.FaultSpec(site="solve", kind="nan", route="pixel",
                              lanes=(0,), times=1),
                mod.FaultSpec(site="ingest", kind="error", route="pixel",
                              after=1, times=1))

    kw = dict(cache_size=0, batch_sizes=(1, 4), max_wait_ms=1e7,
              retries=2, retry_backoff_s=1e-3, breaker_threshold=1,
              breaker_cooldown_s=1e6,
              max_queue_depth=4 if chaos else None)
    jeng = _jax_engine(faults=JFI.FaultPlan(seed=21, specs=specs(JFI)),
                       **kw)
    teng = make_engine(faults=FI.FaultPlan(seed=21, specs=specs(FI)), **kw)
    try:
        jout = _traffic(jeng, deep=chaos)
    finally:
        jeng.shutdown(drain=False)
    tout = _traffic(teng, deep=chaos)
    _assert_same_outcomes(jout, tout, jeng, teng)
    ft = teng.stats()["fault_tolerance"]
    if chaos:
        assert ft["retries"]["pixel"] == 2 and ft["salvaged"]["pixel"] == 1
        assert ft["degraded"]["histogram"] >= 1
        assert ft["breaker_trips"]["histogram"] == 1
        assert ft["shed"]["histogram"] >= 1
        assert ft["breaker_state"]["histogram"] == "open"
    else:
        assert all(v == 0 for k in FT_KEYS if k != "invalid_input"
                   for v in ft[k].values())
        assert all(st == "closed" for st in ft["breaker_state"].values())


# -- a kernel that fails to build or to launch is never hidden ---------------

class _FailingBinLibrary:
    """The binning kernel fails as ``fail`` says: it returns
    cudaErrorIllegalAddress (700), raises, or is missing."""

    def __init__(self, fail):
        self._fail = fail

    def __getattr__(self, name):
        if name not in ("histogram_bin_u8", "histogram_bin_i32"):
            raise AttributeError(name)
        if self._fail == "missing":
            raise AttributeError(f"no kernel {name}")

        def fn(*args):
            if self._fail == "status":
                return 700
            raise self._fail
        return fn


#: how the binning fails -> (what the fake library does, the error the
#: caller must see). Only an InjectedFault enters the ladder; each of
#: these must reach the caller untouched.
_LAUNCH_FAILURES = {
    "launch": ("status", _build.KernelLaunchError),
    "oom": (torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                   "allocate 2.00 GiB"),
            torch.OutOfMemoryError),
    "wrapper_bug": ("missing", AttributeError),
    "runtime": (RuntimeError("an error of no known kind"), RuntimeError),
    "index": (IndexError("lane 9 of 4"), IndexError),
    "os": (OSError("stale handle"), OSError),
}
_FAILURES = ["launch", "build", "symbol", "build_dir", *list(
    _LAUNCH_FAILURES)[1:]]


def _break_the_binning(monkeypatch, tmp_path, how):
    """Send the histogram route's binning down its card path on CPU
    tensors, into a library that fails to launch, to build (a failing
    ``nvcc``, a missing symbol, a build directory that cannot be made),
    or whose launch raises. Returns the error the caller must see."""
    monkeypatch.setattr(KB, "_checked", lambda *a: True)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "_counters", {})
    if how in _LAUNCH_FAILURES:
        fail, err = _LAUNCH_FAILURES[how]
        monkeypatch.setattr(_build, "library",
                            lambda: _FailingBinLibrary(fail))
        return err
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    if how == "build":
        nvcc = tmp_path / "nvcc"
        nvcc.write_text("#!/bin/sh\necho 'error: no such card' >&2\n"
                        "exit 1\n")
        nvcc.chmod(0o755)
        monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    elif how == "symbol":
        # a library that loads but lacks the kernels' symbols
        monkeypatch.setattr(_build, "_digest", lambda: "stale")
        (tmp_path / "kernels").mkdir()
        (tmp_path / "kernels" / "libfcm_kernels-stale.so").touch()
        monkeypatch.setattr(_build, "ctypes", types.SimpleNamespace(
            CDLL=lambda path: types.SimpleNamespace()))
    else:
        (tmp_path / "file").touch()
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "file" / "k")
    return _build.KernelBuildError


def _ladder_untouched(eng):
    ft = eng.stats()["fault_tolerance"]
    for k in ("retries", "degraded", "breaker_trips", "salvaged"):
        assert ft[k]["histogram"] == 0, k
    assert ft["breaker_state"].get("histogram", "closed") == "closed"


@pytest.mark.parametrize("how", _FAILURES)
def test_kernel_failure_reaches_the_synchronous_caller(make_engine,
                                                       monkeypatch,
                                                       tmp_path, how):
    err = _break_the_binning(monkeypatch, tmp_path, how)
    eng = make_engine(retries=2, breaker_threshold=1)
    before = KB.histogram_bin.launches
    for _ in range(2):
        with pytest.raises(err):
            eng.segment(_imgs(2))
    assert KB.histogram_bin.launches == before
    _ladder_untouched(eng)


@pytest.mark.parametrize("how", _FAILURES)
def test_kernel_failure_reaches_the_future_and_the_flusher_lives(
        make_engine, monkeypatch, tmp_path, how):
    err = _break_the_binning(monkeypatch, tmp_path, how)
    eng = make_engine(retries=2, breaker_threshold=1, max_wait_ms=1.0)
    for _ in range(2):
        futs = [eng.submit_async(im) for im in _imgs(3)]
        for f in futs:
            with pytest.raises(err):
                f.result(timeout=WAIT)
    _ladder_untouched(eng)
    assert eng._flusher.is_alive() and eng.healthy()
    assert eng.stats()["fault_tolerance"]["flusher_restarts"] == 0
    monkeypatch.setattr(KB, "_checked", lambda *a: False)   # repaired
    ok = eng.submit_async(_imgs(1)[0])
    assert np.isfinite(ok.result(timeout=WAIT).centers).all()


def test_typed_kernel_errors_are_runtime_errors():
    assert issubclass(_build.KernelBuildError, RuntimeError)
    assert issubclass(_build.KernelLaunchError, RuntimeError)
    assert not issubclass(_build.KernelBuildError, FI.InjectedFault)
    assert not issubclass(_build.KernelLaunchError, FI.InjectedFault)


def test_half_open_probe_that_hits_a_kernel_failure_stays_open(
        make_engine, monkeypatch, tmp_path):
    """A probe that ends in an error past the ladder proves nothing: the
    breaker goes back to open with no trip counted and no chunk
    degraded, and the next probe, on a repaired card, closes it."""
    plan = FI.FaultPlan(seed=5, specs=(
        FI.FaultSpec(site="launch", kind="error", route="histogram",
                     times=1),))
    eng = make_engine(faults=plan, retries=0, breaker_threshold=1,
                      breaker_cooldown_s=0.0)
    img = _imgs(1)[0]
    eng.segment([img])                    # injected fault: trips open
    _break_the_binning(monkeypatch, tmp_path, "launch")
    with pytest.raises(_build.KernelLaunchError):
        eng.segment([img])                # the probe hits a broken kernel
    ft = eng.stats()["fault_tolerance"]
    assert ft["breaker_state"]["histogram"] == "open"
    assert ft["breaker_trips"]["histogram"] == 1
    assert ft["degraded"]["histogram"] == 1
    monkeypatch.setattr(KB, "_checked", lambda *a: False)   # repaired
    assert np.isfinite(eng.segment([img])[0].centers).all()
    ft = eng.stats()["fault_tolerance"]
    assert ft["breaker_state"]["histogram"] == "closed"
    assert ft["degraded"]["histogram"] == 1


def test_span_fence_synchronizes_the_values_card(monkeypatch):
    """From a thread whose current device is another card, the fence
    waits on the card that holds the value."""
    class _OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 1)

    synced = []
    monkeypatch.setattr(TR.torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    value = torch.Tensor._make_subclass(_OnCard, torch.zeros(2))
    sp = TR.Span("launch", {})
    assert sp.fence((value, {"n": torch.zeros(1)}))[0] is value
    assert synced == [torch.device("cuda", 1)]
    assert sp.device_s is not None
    synced.clear()
    sp.fence(torch.zeros(2))                  # the CPU waits for nothing
    assert synced == []


def test_nonfinite_lane_on_the_reference_too_fails_alone(make_engine,
                                                         monkeypatch):
    """A lane the salvage cannot heal fails with SolveFailed; its
    batchmate's result still lands on its future."""
    real = SV.flat_batched_solve

    def poisoned(*a, **k):
        v, delta, iters, total = real(*a, **k)
        v = v.clone()
        v[0] = float("nan")
        return v, delta, iters, total

    imgs = _imgs(2)
    monkeypatch.setattr(SV, "flat_batched_solve", poisoned)
    eng = make_engine(max_wait_ms=1e7)
    futs = [eng.submit_async(im) for im in imgs]
    eng.drain()
    with pytest.raises(SolveFailed):
        futs[0].result(timeout=WAIT)
    assert np.isfinite(futs[1].result(timeout=WAIT).centers).all()
    assert eng.stats()["fault_tolerance"]["salvaged"]["histogram"] == 1
