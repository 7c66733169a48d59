"""The port's LM serving slice against the JAX package, on the CPU, at
reduced configs (float32, one group, d_model 64): the selective scan's
end state, Mamba's prefill dispatch, block prefill / decode, the model's
``prefill`` and ``decode_step``, ``ServeEngine``, its CLI and example,
the newly registered archs, and the deprecated ``serving.engine`` shim.

The same numpy inputs, made from a seed, and the JAX package's
parameters carried across by ``convert.lm_params_from_numpy`` go
through both packages. Tolerances:

- the selective scan's (y, h_final): rtol 1e-5, atol 1e-6 (the same
  float32 recurrence; exp and the sum over d_state may round
  differently);
- the Mamba layer, blocks and the model (outputs, logits and every
  cache leaf): rtol 1e-4, atol 1e-5 (the cached keys carry RoPE, whose
  float32 sin / cos of angles up to S radians round differently in the
  two packages: a few 1e-6 on entries of order 1);
  the port's prefill / decode against its own teacher-forced
  ``forward``: the JAX package's own bound, rtol / atol 2e-2;
- tokens: equal.

The CUDA kernel's end state is held against the plain version on the
card by ``chip_smoke.py`` (phase 11) and ``tests/test_torch_cuda.py``.
"""
import dataclasses
import importlib
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.launch import serve as JSV
from repro.models import blocks as JB
from repro.models import lm as JLM
from repro.models import ssm as JS
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.kernels import ops as tops
from repro_torch.kernels import selective_scan as KSS
from repro_torch.launch import serve as TSV
from repro_torch.models import blocks as TBK
from repro_torch.models import lm as TLM
from repro_torch.models import ssm as TS
from repro_torch.training import optimizer as TO

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the archs served in both packages here; Jamba at the kernel route
ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m", "jamba-v0.1-52b")
#: prompt, decode steps held against JAX, tokens the engines generate
PROMPT, STEPS, NEW = 64, 4, 8
BATCH = 2
MAX_LEN = PROMPT + NEW


def _cfgs(arch, **kw):
    """The reduced config in both packages, with the same changes
    (Jamba's scan on the kernel route)."""
    if arch.startswith("jamba"):
        kw.setdefault("mamba_pallas", True)
    return (dataclasses.replace(JC.get_config(arch).reduced(), **kw),
            dataclasses.replace(TC.get_config(arch).reduced(), **kw))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _flat(tree, path=""):
    """(path, leaf) over a nested dict / list, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}[{i}]")
    else:
        yield path, np.array(tree)


def _close_trees(got, want, rtol, atol, what):
    got, want = list(_flat(got)), list(_flat(want))
    assert [p for p, _ in got] == [p for p, _ in want], what
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, path)
        _close(g, w, rtol, atol, f"{what} {path}")


# ---------------------------------------------------------------------------
# The selective scan's end state and Mamba's prefill dispatch
# ---------------------------------------------------------------------------

def _scan_data(b, s, di, ds, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, s, di)).astype(np.float32),
            rng.uniform(1e-3, 0.1, (b, s, di)).astype(np.float32),
            rng.normal(0, 1, (b, s, ds)).astype(np.float32),
            rng.normal(0, 1, (b, s, ds)).astype(np.float32),
            -rng.uniform(0.5, 4.0, (di, ds)).astype(np.float32))


@pytest.mark.parametrize("b,s,di,ds", [(2, 64, 64, 16), (1, 100, 96, 8)])
def test_selective_scan_end_state_matches_jax(b, s, di, ds):
    ins = _scan_data(b, s, di, ds, seed=s + ds)
    y, h = KSS.selective_scan(*[_t(a) for a in ins], return_state=True)
    assert h.shape == (b, di, ds) and h.dtype == torch.float32
    jy, jh = jax.jit(JS._ssm_scan)(*[jnp.asarray(a) for a in ins],
                                   jnp.zeros((di,), jnp.float32),
                                   jnp.zeros((b, di, ds), jnp.float32))
    _close(y, jy, 1e-5, 1e-6, "y")
    _close(h, jh, 1e-5, 1e-6, "h_final")
    assert torch.equal(y, KSS.selective_scan(*[_t(a) for a in ins]))


@pytest.mark.parametrize("s", [64, 60])
def test_mamba_prefill_state_matches_jax(s, monkeypatch):
    """S = 64 takes the kernel route's end-state form (here its plain
    version), S = 60 the plain loop; both against the JAX function."""
    jcfg, tcfg = _cfgs("jamba-v0.1-52b")
    jp = JS.init_mamba(jax.random.PRNGKey(4), jcfg)
    tp = {k: _t(v) for k, v in _np_tree(jp).items()}
    x = np.random.default_rng(s).normal(0, 1, (2, s, jcfg.d_model)).astype(
        np.float32)
    calls = []
    real = TS._scan_with_state
    monkeypatch.setattr(TS, "_scan_with_state",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    jy, jst = jax.jit(lambda q: JS.mamba_forward(
        q, jnp.asarray(x), jcfg, return_state=True))(jp)
    ty, tst = TS.mamba_forward(tp, _t(x), tcfg, return_state=True)
    assert len(calls) == (1 if s % 64 == 0 else 0)
    _close(ty, jy, 1e-4, 1e-5, "y")
    for k in ("conv", "ssm"):
        _close(tst[k], jst[k], 1e-4, 1e-5, k)


def test_mamba_prefill_dispatch_takes_the_kernel_on_the_card(monkeypatch):
    """Prefill's scan is the ``selscan`` entry of the platform of its
    tensors: the kernel's wrapper on the card, which takes the end-state
    form; with a gradient wanted, the state path raises."""
    assert tops.select_step("selscan", platform="cuda").build() is (
        KSS.selective_scan)
    seen = []
    real = tops.select_step
    monkeypatch.setattr(tops, "select_step",
                        lambda kind, platform: seen.append(
                            (kind, platform)) or real(kind, platform=platform))
    ins = [_t(a) for a in _scan_data(1, 64, 64, 4, 0)]
    y, h = TS._scan_with_state(*ins)
    assert seen == [("selscan", "cpu")] and h.shape == (1, 64, 4)
    ins[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no_grad"):
        TS._scan_with_state(*ins)
    with torch.no_grad():
        TS._scan_with_state(*ins)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mixer,ffn", [("gqa", "swiglu"), ("gqa", "moe"),
                                       ("mamba", "swiglu"), ("mamba", "moe")])
def test_block_prefill_and_decode_match_jax(mixer, ffn):
    jcfg, tcfg = _cfgs("jamba-v0.1-52b")
    jdesc = JC.BlockDesc(mixer=mixer, ffn=ffn)
    tdesc = TC.BlockDesc(mixer=mixer, ffn=ffn)
    jp = JB.init_block(jax.random.PRNGKey(5), jcfg, jdesc)
    tp = jax.tree_util.tree_map(_t, _np_tree(jp))
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (BATCH, PROMPT, jcfg.d_model)).astype(np.float32)
    x1 = rng.normal(0, 1, (BATCH, 1, jcfg.d_model)).astype(np.float32)
    pos = np.arange(PROMPT, dtype=np.int32)[None]

    def jrun(p):
        c = JB.init_block_cache(jcfg, jdesc, BATCH, MAX_LEN, 1)
        y, c = JB.block_prefill(p, jnp.asarray(x), jcfg, jdesc, c,
                                positions=jnp.asarray(pos))
        y1, c1 = JB.block_decode(p, jnp.asarray(x1), jcfg, jdesc, c,
                                 pos=PROMPT)
        return y, c, y1, c1

    jy, jc, jy1, jc1 = _np_tree(jax.jit(jrun)(jp))
    cache = TBK.init_block_cache(tcfg, tdesc, BATCH, MAX_LEN, device=CPU)
    ty, tc = TBK.block_prefill(tp, _t(x), tcfg, tdesc, cache,
                               positions=_t(pos))
    _close(ty, jy, 1e-4, 1e-5, "prefill x")
    _close_trees(tc, jc, 1e-4, 1e-5, "prefill cache")
    ty1, tc1 = TBK.block_decode(tp, _t(x1), tcfg, tdesc, tc, pos=PROMPT)
    _close(ty1, jy1, 1e-4, 1e-5, "decode x")
    _close_trees(tc1, jc1, 1e-4, 1e-5, "decode cache")


def test_block_decode_refuses_a_position_outside_the_cache():
    _, tcfg = _cfgs("jamba-v0.1-52b")
    with pytest.raises(ValueError, match="outside"):
        TBK.block_decode(
            TBK.init_block(torch.Generator().manual_seed(0), tcfg,
                           TC.BlockDesc()),
            torch.zeros((1, 1, tcfg.d_model)), tcfg, TC.BlockDesc(),
            TBK.init_block_cache(tcfg, TC.BlockDesc(), 1, 8, device=CPU),
            pos=8)


# ---------------------------------------------------------------------------
# The model and the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """One arch in both packages: the JAX engine's jitted prefill and
    decode step (one compile each, shared with its ``generate``), the
    port's copy of the parameters, a seeded prompt and the tokens fed to
    the decode steps, and the JAX side's logits and caches."""
    jcfg, tcfg = _cfgs(request.param)
    jp = jax.jit(JLM.init_params, static_argnums=1)(jax.random.PRNGKey(9),
                                                    jcfg)
    eng = JSV.ServeEngine(jcfg, jp, max_len=MAX_LEN, batch_size=BATCH)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, jcfg.vocab_size,
                        (BATCH, PROMPT + STEPS)).astype(np.int32)
    cache = JLM.init_cache(jcfg, BATCH, MAX_LEN)
    logits, cache = eng._prefill(jp, jnp.asarray(toks[:, :PROMPT]), cache,
                                 {})
    want = {"prefill": (np.asarray(logits), _np_tree(cache)), "steps": []}
    for pos in range(PROMPT, PROMPT + STEPS):
        logits, cache = eng._step(jp, jnp.asarray(toks[:, pos:pos + 1]),
                                  cache, pos)
        want["steps"].append(np.asarray(logits))
    want["cache"] = _np_tree(cache)
    want["greedy"] = eng.generate(toks[:, :PROMPT], NEW)
    tp = convert.lm_params_from_numpy(_np_tree(jp), tcfg, device=CPU)
    return dict(jcfg=jcfg, tcfg=tcfg, tp=tp, toks=toks, want=want)


def test_prefill_and_decode_match_jax(served):
    tcfg, tp, toks, want = (served[k] for k in ("tcfg", "tp", "toks",
                                                "want"))
    cache = TLM.init_cache(tcfg, BATCH, MAX_LEN, device=CPU)
    logits, cache = TLM.prefill(tp, _t(toks[:, :PROMPT]), cache, tcfg)
    jlog, jcache = want["prefill"]
    _close(logits, jlog, 1e-4, 1e-5, "prefill logits")
    _close_trees(cache, convert.lm_cache_from_numpy(jcache, tcfg,
                                                    device=CPU),
                 1e-4, 1e-5, "prefill cache")
    for i, pos in enumerate(range(PROMPT, PROMPT + STEPS)):
        logits, cache = TLM.decode_step(tp, _t(toks[:, pos:pos + 1]), cache,
                                        pos, tcfg)
        _close(logits, want["steps"][i], 1e-4, 1e-5, f"decode {pos}")
    _close_trees(cache, convert.lm_cache_from_numpy(want["cache"], tcfg,
                                                    device=CPU),
                 1e-4, 1e-5, "decode cache")


def test_prefill_and_decode_match_the_teacher_forced_forward(served):
    """The port's own cache path against its train forward on the same
    stream (the JAX package's test_prefill_decode_consistency)."""
    tcfg, tp, toks = served["tcfg"], served["tp"], served["toks"]
    with torch.no_grad():
        full, _ = TLM.forward(tp, _t(toks), tcfg)
    cache = TLM.init_cache(tcfg, BATCH, MAX_LEN, device=CPU)
    logits, cache = TLM.prefill(tp, _t(toks[:, :PROMPT]), cache, tcfg)
    _close(logits[:, 0], full[:, PROMPT - 1], 2e-2, 2e-2, "prefill")
    for pos in range(PROMPT, PROMPT + STEPS):
        logits, cache = TLM.decode_step(tp, _t(toks[:, pos:pos + 1]), cache,
                                        pos, tcfg)
        _close(logits[:, 0], full[:, pos], 2e-2, 2e-2, f"decode {pos}")


def test_greedy_generate_matches_the_jax_engine(served):
    tcfg, tp, toks = served["tcfg"], served["tp"], served["toks"]
    eng = TSV.ServeEngine(tcfg, tp, max_len=MAX_LEN, batch_size=BATCH)
    out = eng.generate(toks[:, :PROMPT], NEW)
    assert out.dtype == np.int32 and out.shape == (BATCH, PROMPT + NEW)
    np.testing.assert_array_equal(out, served["want"]["greedy"])


@pytest.fixture(scope="module")
def small_engine():
    cfg = TC.get_config("llama3.2-1b").reduced()
    params = TLM.init_params(3, cfg, device=CPU)
    return cfg, TSV.ServeEngine(cfg, params, max_len=24, batch_size=2)


def test_sampling_repeats_with_its_seed_and_stays_in_the_vocabulary(
        small_engine):
    cfg, eng = small_engine
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    a = eng.generate(prompts, 16, temperature=0.8, seed=5)
    b = eng.generate(prompts, 16, temperature=0.8, seed=5)
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < cfg.vocab_size)).all()
    np.testing.assert_array_equal(a[:, :8], prompts)
    greedy = eng.generate(prompts, 16)
    others = [eng.generate(prompts, 16, temperature=0.8, seed=s)
              for s in (6, 7)]
    assert any(not np.array_equal(o, a) for o in others + [greedy])


def test_engine_refuses_a_wrong_batch_or_too_long_a_run(small_engine):
    cfg, eng = small_engine
    with pytest.raises(ValueError, match="batch size"):
        eng.generate(np.zeros((3, 8), np.int32), 4)
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(np.zeros((2, 8), np.int32), 17)
    with pytest.raises(ValueError, match="lie in"):
        eng.generate(np.full((2, 8), cfg.vocab_size, np.int32), 4)
    # memory given to a model without cross blocks changes nothing, as in
    # the JAX package
    toks = torch.zeros((2, 8), dtype=torch.int32)
    plain, _ = TLM.prefill(eng.params, toks,
                           TLM.init_cache(cfg, 2, 24, device=CPU), cfg)
    given, _ = TLM.prefill(eng.params, toks,
                           TLM.init_cache(cfg, 2, 24, device=CPU), cfg,
                           memory=torch.ones(2, 1, cfg.d_model))
    assert torch.equal(given, plain)


def test_cli_and_example_run_on_the_cpu(capsys):
    assert TSV.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "8", "--new-tokens",
                     "8"]) == 0
    assert "generated 2x8 tokens on cpu" in capsys.readouterr().out
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        example = importlib.import_module("torch_serve_lm")
    finally:
        sys.path.pop(0)
    assert example.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "teacher-forced agreement: 1.000 on cpu" in out
    assert "serving OK" in out


# ---------------------------------------------------------------------------
# Configs and the deprecated shim
# ---------------------------------------------------------------------------

NEW_ARCHS = ("llama3.2-1b", "llama3.2-3b", "mistral-nemo-12b",
             "mistral-large-123b", "granite-moe-3b-a800m",
             "deepseek-v2-236b", "rwkv6-1.6b", "whisper-tiny",
             "llama-3.2-vision-90b")


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out["dtype"] = str(cfg.dtype).split(".")[-1]
    return out


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_registered_config_equals_jax(arch):
    assert arch in TC.list_archs()
    jc, tc = JC.get_config(arch), TC.get_config(arch)
    jf, tf = _fields(jc), _fields(tc)
    jf["dtype"] = str(jnp.dtype(jc.dtype))
    assert tf == jf
    jr, tr = _fields(jc.reduced()), _fields(tc.reduced())
    jr["dtype"] = str(jnp.dtype(jc.reduced().dtype))
    assert tr == jr
    n = sum(t.numel() for t in TO.tree_leaves(
        TLM.init_params(0, tc.reduced(), device=CPU)))
    assert n == sum(a.size for a in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda: JLM.init_params(jax.random.PRNGKey(0),
                                               jc.reduced()))))


def test_serving_engine_shim_warns_and_plain_import_does_not():
    import repro_torch.serving as TSRV
    with pytest.warns(DeprecationWarning, match="launch.serve"):
        assert TSRV.ServeEngine is TSV.ServeEngine
    sys.modules.pop("repro_torch.serving.engine", None)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        mod = importlib.import_module("repro_torch.serving.engine")
    assert mod.ServeEngine is TSV.ServeEngine
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert TSRV.engine is mod
    code = ("import sys, warnings; warnings.simplefilter('error'); "
            "import repro_torch.serving; "
            "assert 'repro_torch.launch.serve' not in sys.modules; "
            "assert 'repro_torch.models.lm' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    done = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
