"""The four LM architectures past GQA and Mamba (deepseek-v2-236b's MLA,
rwkv6-1.6b, whisper-tiny's encoder-decoder, llama-3.2-vision-90b's gated
cross blocks) through every LM entry point of the port, against the JAX
package, on the CPU, at the reduced configs (float32, one group,
d_model 64): ``forward``, ``loss_fn``, three ``make_train_step`` steps,
``prefill`` and ``decode_step`` with every cache leaf, ``ServeEngine``
and its CLI.

The same numpy inputs, made from a seed, and the JAX package's
parameters carried across by ``convert.lm_params_from_numpy`` go
through both packages, every ``gate`` opened to 0.5 first (a gated cross
block starts closed and adds nothing). Whisper's frames are
``N_FRAMES`` = 10 long, not ``MAX_LEN``: prefill replaces the cross
K/V buffer (sized ``max_len`` by ``init_cache``) by the memory's own.
Tolerances: logits, losses, leaves and cache leaves rtol 1e-4 / atol
1e-5; the port's prefill / decode against its own teacher-forced
``forward``: rtol / atol 2e-2 (MLA's absorbed decode and its
decompressed forward are different arithmetic); tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.launch import serve as JSV
from repro.models import lm as JLM
from repro.training import optimizer as JO
from repro.training import train_loop as JT
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.launch import serve as TSV
from repro_torch.models import lm as TLM
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TT

CPU = "cpu"
ARCHS = ("deepseek-v2-236b", "rwkv6-1.6b", "whisper-tiny",
         "llama-3.2-vision-90b")
#: prompt, decode steps held against JAX, tokens the engines generate
PROMPT, STEPS, NEW = 16, 4, 8
BATCH = 2
MAX_LEN = PROMPT + NEW
#: whisper's frame count, unlike MAX_LEN
N_FRAMES = 10


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _open_gates(tree):
    if isinstance(tree, dict):
        return {k: (np.full_like(v, 0.5) if k == "gate" else _open_gates(v))
                for k, v in tree.items()}
    return tree


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}[{i}]")
    else:
        yield path, (tree.detach().numpy() if isinstance(tree, torch.Tensor)
                     else np.array(tree))


def _close_trees(got, want, rtol, atol, what):
    got, want = list(_flat(got)), list(_flat(want))
    assert [p for p, _ in got] == [p for p, _ in want], what
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, path)
        _close(g, w, rtol, atol, f"{what} {path}")


def _extras(cfg, rng):
    """The memory inputs of an arch as numpy: prefill's / forward's
    keyword arguments and the training batch's keys."""
    kw, batch = {}, {}
    if cfg.n_img_tokens:
        kw["memory"] = batch["image_embeds"] = rng.normal(
            0, 1, (BATCH, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        kw["frames"] = batch["frames"] = rng.normal(
            0, 1, (BATCH, N_FRAMES, cfg.d_model)).astype(np.float32)
    return kw, batch


def _steps_batches(cfg, rng, extra_batch):
    out = []
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(
            np.int32)
        out.append(dict(extra_batch, tokens=toks,
                        labels=np.roll(toks, -1, axis=1)))
    return out


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """One arch run through the JAX package once: the forward's logits and
    loss, three train steps, the JAX engine's jitted prefill and decode
    step (one compile each, shared with its ``generate``) with their
    logits and caches, and greedy tokens; the port's copy of the
    parameters."""
    jcfg = JC.get_config(request.param).reduced()
    tcfg = TC.get_config(request.param).reduced()
    params = _open_gates(_np_tree(jax.jit(JLM.init_params, static_argnums=1)(
        jax.random.PRNGKey(21), jcfg)))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.default_rng(21)
    toks = rng.integers(0, jcfg.vocab_size,
                        (BATCH, PROMPT + STEPS)).astype(np.int32)
    kw, extra_batch = _extras(jcfg, rng)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    want = {}
    want["forward"] = np.array(jax.jit(lambda p, t, e: JLM.forward(
        p, t, jcfg, **e)[0])(jp, jnp.asarray(toks), jkw))
    batch = dict(extra_batch, tokens=toks[:, :PROMPT],
                 labels=toks[:, 1:PROMPT + 1])
    want["loss"] = float(JT.loss_fn(jp, {k: jnp.asarray(v) for k, v in
                                         batch.items()}, jcfg, 0.01)[0])
    batches = _steps_batches(jcfg, rng, extra_batch)
    jstep = jax.jit(JT.make_train_step(jcfg, JT.TrainConfig()))
    state = {"params": jp, "opt": JO.init_opt_state(jp),
             "step": jnp.zeros((), jnp.int32)}
    want["train"] = []
    for b in batches:
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        want["train"].append({k: float(m[k]) for k in ("loss", "grad_norm")})
    want["trained"] = _np_tree(state["params"])
    eng = JSV.ServeEngine(jcfg, jp, max_len=MAX_LEN, batch_size=BATCH)
    cache = JLM.init_cache(jcfg, BATCH, MAX_LEN)
    want["fresh"] = _np_tree(cache)
    logits, cache = eng._prefill(jp, jnp.asarray(toks[:, :PROMPT]), cache,
                                 jkw)
    want["prefill"] = (np.array(logits), _np_tree(cache))
    want["steps"] = []
    for pos in range(PROMPT, PROMPT + STEPS):
        logits, cache = eng._step(jp, jnp.asarray(toks[:, pos:pos + 1]),
                                  cache, pos)
        want["steps"].append(np.array(logits))
    want["cache"] = _np_tree(cache)
    want["greedy"] = eng.generate(toks[:, :PROMPT], NEW, extra_inputs=jkw)
    tp = convert.lm_params_from_numpy(params, tcfg, device=CPU)
    return dict(name=request.param, tcfg=tcfg, params=params, tp=tp,
                toks=toks, kw=kw, batch=batch, batches=batches, want=want)


def _tkw(arch):
    return {k: _t(v) for k, v in arch["kw"].items()}


def test_forward_and_loss_match_jax(arch):
    tcfg, tp, toks = arch["tcfg"], arch["tp"], arch["toks"]
    with torch.no_grad():
        logits, _ = TLM.forward(tp, _t(toks), tcfg, **_tkw(arch))
        total, _ = TT.loss_fn(tp, {k: _t(v) for k, v in arch["batch"].items()},
                              tcfg, 0.01)
    _close(logits, arch["want"]["forward"], 1e-4, 1e-5, "logits")
    _close(float(total), arch["want"]["loss"], 1e-4, 1e-5, "loss")


def test_three_train_steps_match_jax(arch):
    tcfg, tp = arch["tcfg"], arch["tp"]
    step = TT.make_train_step(tcfg, TT.TrainConfig())
    state = {"params": tp, "opt": TO.init_opt_state(tp),
             "step": torch.zeros((), dtype=torch.int32)}
    for i, b in enumerate(arch["batches"]):
        state, m = step(state, {k: _t(v) for k, v in b.items()})
        for k, w in arch["want"]["train"][i].items():
            _close(float(m[k]), w, 1e-4, 0.0, f"step {i} {k}")
    want = convert.lm_params_from_numpy(arch["want"]["trained"], tcfg,
                                        device=CPU)
    _close_trees(state["params"], want, 1e-4, 1e-6, "parameters")


def test_prefill_and_decode_match_jax(arch):
    tcfg, tp, toks, want = (arch[k] for k in ("tcfg", "tp", "toks", "want"))
    cache = TLM.init_cache(tcfg, BATCH, MAX_LEN, device=CPU)
    _close_trees(cache, convert.lm_cache_from_numpy(want["fresh"], tcfg,
                                                    device=CPU),
                 0, 0, "fresh cache")
    logits, cache = TLM.prefill(tp, _t(toks[:, :PROMPT]), cache, tcfg,
                                **_tkw(arch))
    jlog, jcache = want["prefill"]
    _close(logits, jlog, 1e-4, 1e-5, "prefill logits")
    _close_trees(cache, convert.lm_cache_from_numpy(jcache, tcfg,
                                                    device=CPU),
                 1e-4, 1e-5, "prefill cache")
    if tcfg.is_encdec:
        # init_cache sized the cross K/V at max_len; prefill replaced it
        assert want["fresh"]["b0"]["cross_kv"]["k"].shape[3] == MAX_LEN
        assert cache[0]["b0"]["cross_kv"]["k"].shape[2] == N_FRAMES
    for i, pos in enumerate(range(PROMPT, PROMPT + STEPS)):
        logits, cache = TLM.decode_step(tp, _t(toks[:, pos:pos + 1]), cache,
                                        pos, tcfg)
        _close(logits, want["steps"][i], 1e-4, 1e-5, f"decode {pos}")
    _close_trees(cache, convert.lm_cache_from_numpy(want["cache"], tcfg,
                                                    device=CPU),
                 1e-4, 1e-5, "decode cache")


def test_prefill_and_decode_match_the_teacher_forced_forward(arch):
    tcfg, tp, toks = arch["tcfg"], arch["tp"], arch["toks"]
    with torch.no_grad():
        full, _ = TLM.forward(tp, _t(toks), tcfg, **_tkw(arch))
    cache = TLM.init_cache(tcfg, BATCH, MAX_LEN, device=CPU)
    logits, cache = TLM.prefill(tp, _t(toks[:, :PROMPT]), cache, tcfg,
                                **_tkw(arch))
    _close(logits[:, 0], full[:, PROMPT - 1], 2e-2, 2e-2, "prefill")
    for pos in range(PROMPT, PROMPT + STEPS):
        logits, cache = TLM.decode_step(tp, _t(toks[:, pos:pos + 1]), cache,
                                        pos, tcfg)
        _close(logits[:, 0], full[:, pos], 2e-2, 2e-2, f"decode {pos}")


def test_greedy_generate_matches_the_jax_engine(arch):
    eng = TSV.ServeEngine(arch["tcfg"], arch["tp"], max_len=MAX_LEN,
                          batch_size=BATCH)
    out = eng.generate(arch["toks"][:, :PROMPT], NEW,
                       extra_inputs=arch["kw"])
    assert out.dtype == np.int32 and out.shape == (BATCH, PROMPT + NEW)
    np.testing.assert_array_equal(out, arch["want"]["greedy"])


@pytest.mark.parametrize("name", ["whisper-tiny", "llama-3.2-vision-90b"])
def test_the_memory_reaches_the_logits(name):
    """A cross block reads its memory: other memory, other logits; with
    its gates closed, a vision model's cross blocks add nothing."""
    tcfg = TC.get_config(name).reduced()
    tp = TLM.init_params(0, tcfg, device=CPU)
    gates = [blk["mixer"] for g in tp["groups"] for blk in g.values()
             if "gate" in blk["mixer"]]
    assert bool(tcfg.n_img_tokens) == bool(gates)
    toks = _t(np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 8)))
    kw = {k: _t(v) for k, v in _extras(tcfg, np.random.default_rng(3))[0]
          .items()}
    moved = {k: v + 1.0 for k, v in kw.items()}
    with torch.no_grad():
        closed = [TLM.forward(tp, toks, tcfg, **e)[0] for e in (kw, moved)]
        for mixer in gates:
            mixer["gate"] = torch.full((1,), 0.5)
        opened = [TLM.forward(tp, toks, tcfg, **e)[0] for e in (kw, moved)]
    assert float((opened[0] - opened[1]).abs().max()) > 1e-3
    if gates:
        assert torch.equal(closed[0], closed[1])
        assert float((opened[0] - closed[0]).abs().max()) > 1e-3


@pytest.mark.parametrize("name", ARCHS)
def test_cli_runs_on_the_cpu(name, capsys):
    assert TSV.main(["--arch", name, "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "8", "--new-tokens",
                     "4"]) == 0
    assert "generated 2x4 tokens on cpu" in capsys.readouterr().out


def test_an_encoder_decoder_model_needs_frames():
    cfg = TC.get_config("whisper-tiny").reduced()
    params = TLM.init_params(0, cfg, device=CPU)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="frames"):
        TLM.forward(params, toks, cfg)
    cfg = TC.get_config("llama-3.2-vision-90b").reduced()
    with pytest.raises(ValueError, match="memory"):
        TLM.prefill(TLM.init_params(0, cfg, device=CPU), toks,
                    TLM.init_cache(cfg, 1, 8, device=CPU), cfg)


def test_params_carried_across_keep_every_leaf(arch):
    """Every leaf of the JAX tree, ``enc_groups`` unstacked like
    ``groups``, bit for bit, and the port's own init draws a tree of the
    same shapes."""
    tcfg, tp, params = arch["tcfg"], arch["tp"], arch["params"]
    n = 0
    for key in params:
        stack = {"groups": tcfg.n_groups, "enc_groups": tcfg.enc_layers}
        if key in stack:
            assert len(tp[key]) == stack[key]
            for g, tg in enumerate(tp[key]):
                sub = jax.tree_util.tree_map(lambda a: a[g], params[key])
                for (p, a), (_, b) in zip(_flat(tg), _flat(sub)):
                    np.testing.assert_array_equal(a, b, err_msg=p)
                    n += 1
        else:
            for (p, a), (_, b) in zip(_flat(tp[key]), _flat(params[key])):
                np.testing.assert_array_equal(a, b, err_msg=p)
                n += 1
    assert n == len(TO.tree_leaves(tp))
    own = TLM.init_params(0, tcfg, device=CPU)
    assert [tuple(a.shape) for a in TO.tree_leaves(own)] == [
        tuple(a.shape) for a in TO.tree_leaves(tp)]
