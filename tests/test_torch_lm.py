"""The port's language-model slice against the JAX package, on the CPU,
at Jamba's reduced config (float32, one 8-layer group, d_model 64).

The same numpy inputs, made from a seed, and the JAX package's
parameters carried across by ``convert.lm_params_from_numpy`` go
through both packages. Tolerances:

- the selective scan's plain version against the JAX oracle and the
  Pallas kernel in interpret mode: rtol 1e-5, atol 1e-6 (the same
  float32 recurrence; exp and the sum over d_state may round
  differently);
- the Mamba layer, kernel route on and off (the JAX side's Pallas
  kernel in interpret mode): values rtol 1e-4, the gradient of sum(y^2)
  rtol 5e-4 with a floor of 5e-6 of each leaf's largest entry (the
  backward recomputes through the recurrence and sums over S positions
  in another order);
- blocks, ``lm.forward`` and ``loss_fn``: rtol 1e-4; three train steps:
  losses and every parameter leaf rtol 1e-4.

The CUDA kernel is held against the plain version on the card by
``chip_smoke.py`` (phase 8) and ``tests/test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.kernels import ref as jref
from repro.kernels.selective_scan import selective_scan_pallas
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import lm as JLM
from repro.models import ssm as JS
from repro.training import optimizer as JO
from repro.training import train_loop as JT
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.kernels import ops as tops
from repro_torch.kernels import selective_scan as KSS
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TBK
from repro_torch.models import lm as TLM
from repro_torch.models import ssm as TS
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TT

CPU = "cpu"
ARCH = "jamba-v0.1-52b"


def _cfgs(**kw):
    """The reduced Jamba config in both packages, with the same changes."""
    return (dataclasses.replace(JC.get_config(ARCH).reduced(), **kw),
            dataclasses.replace(TC.get_config(ARCH).reduced(), **kw))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _leaf_pairs(jtree, ttree, path=""):
    """(path, jax leaf, torch leaf) over the JAX tree's dict leaves; the
    port's ``groups`` list is the JAX tree's stacked leading axis."""
    if isinstance(jtree, dict):
        for k in sorted(jtree):
            if k == "groups" and isinstance(ttree[k], list):
                for g, tg in enumerate(ttree[k]):
                    sub = jax.tree_util.tree_map(lambda a: a[g], jtree[k])
                    yield from _leaf_pairs(sub, tg, f"{path}/groups[{g}]")
            else:
                yield from _leaf_pairs(jtree[k], ttree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(jtree), ttree.detach().numpy()


# ---------------------------------------------------------------------------
# The selective scan
# ---------------------------------------------------------------------------

def _scan_data(b, s, di, ds, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, s, di)).astype(np.float32),
            rng.uniform(1e-3, 0.1, (b, s, di)).astype(np.float32),
            rng.normal(0, 1, (b, s, ds)).astype(np.float32),
            rng.normal(0, 1, (b, s, ds)).astype(np.float32),
            -rng.uniform(0.5, 4.0, (di, ds)).astype(np.float32))


@pytest.mark.parametrize("b,s,di,ds", [(1, 64, 64, 4), (2, 128, 128, 16),
                                       (1, 100, 96, 8), (2, 64, 32, 32)])
def test_selective_scan_plain_matches_jax(b, s, di, ds):
    ins = _scan_data(b, s, di, ds, seed=b * s + ds)
    got = KSS.selective_scan(*[_t(a) for a in ins]).numpy()
    jins = [jnp.asarray(a) for a in ins]
    _close(got, jref.selective_scan_ref(*jins), 1e-5, 1e-6, "oracle")
    if s % 64 == 0 and di % 32 == 0:      # the TPU kernel's tiling
        _close(got, selective_scan_pallas(*jins, di_tile=32, seq_blk=64,
                                          interpret=True),
               1e-5, 1e-6, "pallas")


def test_selscan_dispatch_takes_the_kernel_on_the_card():
    assert tops.select_step("selscan", platform="cuda").name == "cuda"
    assert tops.select_step("selscan", platform="cpu").name == "reference"
    u, dt, b, c, a = (_t(x) for x in _scan_data(1, 8, 4, 2, 0))
    with pytest.raises(ValueError, match="shape mismatch"):
        KSS.selective_scan(u, dt, b, c, a[:, :1])


# ---------------------------------------------------------------------------
# The Mamba layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pallas", [False, True])
def test_mamba_forward_and_grads_match_jax(pallas):
    jcfg, tcfg = _cfgs(mamba_pallas=pallas)
    jp = JS.init_mamba(jax.random.PRNGKey(0), jcfg)
    tp = {k: _t(v) for k, v in _np_tree(jp).items()}
    x = np.random.default_rng(0).normal(0, 1, (2, 64, jcfg.d_model)).astype(
        np.float32)
    jy = jax.jit(lambda q: JS.mamba_forward(q, jnp.asarray(x), jcfg))(jp)
    ty = TS.mamba_forward(tp, _t(x), tcfg)
    _close(ty.detach(), jy, 1e-4, 1e-6, "mamba y")

    jg = jax.jit(jax.grad(lambda q: jnp.sum(JS.mamba_forward(
        q, jnp.asarray(x), jcfg) ** 2)))(jp)
    live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tg = torch.autograd.grad(
        torch.sum(TS.mamba_forward(live, _t(x), tcfg) ** 2),
        [live[k] for k in sorted(live)])
    for k, g in zip(sorted(live), tg):
        # near-zero entries: a floor of 5e-6 of the leaf's largest gradient
        scale = float(np.abs(np.asarray(jg[k])).max())
        _close(g, jg[k], 5e-4, 5e-6 * scale, f"grad {k}")


def test_mamba_state_path_matches_jax():
    """With state carried out (prefill), the plain recurrence runs and
    returns the conv and SSM states."""
    jcfg, tcfg = _cfgs(mamba_pallas=True)
    jp = JS.init_mamba(jax.random.PRNGKey(1), jcfg)
    tp = {k: _t(v) for k, v in _np_tree(jp).items()}
    x = np.random.default_rng(1).normal(0, 1, (1, 64, jcfg.d_model)).astype(
        np.float32)
    jy, jst = JS.mamba_forward(jp, jnp.asarray(x), jcfg, return_state=True)
    ty, tst = TS.mamba_forward(tp, _t(x), tcfg, return_state=True)
    _close(ty, jy, 1e-4, 1e-6)
    for k in ("conv", "ssm"):
        _close(tst[k], jst[k], 1e-4, 1e-6, k)
    st = TS.init_mamba_state(tcfg, 2)
    assert st["ssm"].shape == (2, 2 * tcfg.d_model, tcfg.mamba_d_state)


# ---------------------------------------------------------------------------
# Attention, blocks, the model
# ---------------------------------------------------------------------------

def test_flash_attention_matches_jax_and_the_plain_core():
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(0, 1, (1, 4, 256, 16)).astype(np.float32)
               for _ in range(3))
    kw = dict(flash_threshold=64, q_chunk=64, kv_chunk=64)
    jo = JA.grouped_attention(*map(jnp.asarray, (q, k[:, :2], v[:, :2])),
                              True, **kw)
    to = TA.grouped_attention(_t(q), _t(k[:, :2]), _t(v[:, :2]), True, **kw)
    _close(to, jo, 1e-4, 1e-6, "flash")
    plain = TA.grouped_attention(_t(q), _t(k[:, :2]), _t(v[:, :2]), True)
    _close(to, plain, 1e-4, 1e-5, "flash vs plain")


@pytest.mark.parametrize("mixer,ffn,router", [
    ("gqa", "swiglu", "softmax"), ("mamba", "moe", "softmax"),
    ("mamba", "moe", "fcm")])
def test_block_forward_matches_jax(mixer, ffn, router):
    jcfg, tcfg = _cfgs(mamba_pallas=True)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, router=router))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, router=router))
    jdesc = JC.BlockDesc(mixer=mixer, ffn=ffn)
    tdesc = TC.BlockDesc(mixer=mixer, ffn=ffn)
    jp = JB.init_block(jax.random.PRNGKey(3), jcfg, jdesc)
    tp = jax.tree_util.tree_map(_t, _np_tree(jp))
    x = np.random.default_rng(3).normal(0, 1, (2, 64, jcfg.d_model)).astype(
        np.float32)
    pos = np.arange(64, dtype=np.int32)[None]
    jy, jaux = jax.jit(lambda q: JB.block_forward(
        q, jnp.asarray(x), jcfg, jdesc, positions=jnp.asarray(pos)))(jp)
    ty, taux = TBK.block_forward(tp, _t(x), tcfg, tdesc, positions=_t(pos))
    _close(ty, jy, 1e-4, 1e-5, "block x")
    _close(float(taux), float(jaux), 1e-4, 0.0, "block aux")


@pytest.fixture(scope="module")
def model():
    """The reduced Jamba model's JAX parameters, the port's copy, and a
    seeded (2, 64) token batch (S % 64 == 0: the kernel route)."""
    jcfg, tcfg = _cfgs(mamba_pallas=True)
    jp = jax.jit(JLM.init_params, static_argnums=1)(jax.random.PRNGKey(7),
                                                    jcfg)
    tp = convert.lm_params_from_numpy(_np_tree(jp), tcfg, device=CPU)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    return jcfg, tcfg, jp, tp, tokens, labels


def test_params_carried_across_keep_dtype_and_layout(model):
    jcfg, tcfg, jp, tp, _, _ = model
    assert len(tp["groups"]) == jcfg.n_groups == 1
    n = 0
    for path, ja, ta in _leaf_pairs(_np_tree(jp), tp):
        assert ta.dtype == ja.dtype and ta.shape == ja.shape, path
        np.testing.assert_array_equal(ta, ja, err_msg=path)
        n += 1
    assert n == len(TO.tree_leaves(tp))
    # the port's own init draws the same tree
    own = TT.init_state(0, tcfg, device=CPU)["params"]
    assert [tuple(a.shape) for a in TO.tree_leaves(own)] == [
        tuple(a.shape) for a in TO.tree_leaves(tp)]
    with pytest.raises(ValueError, match="n_groups"):
        convert.lm_params_from_numpy(
            _np_tree(jp), dataclasses.replace(tcfg, n_layers=16), device=CPU)


def test_lm_forward_and_loss_match_jax(model):
    jcfg, tcfg, jp, tp, tokens, labels = model
    jlog, jaux = jax.jit(JLM.forward, static_argnums=2)(
        jp, jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        tlog, taux = TLM.forward(tp, _t(tokens), tcfg)
    _close(tlog, jlog, 1e-4, 1e-5, "logits")
    _close(float(taux), float(jaux), 1e-4, 0.0, "aux")
    batch = {"tokens": tokens, "labels": labels}
    jtot, jm = JT.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                          jcfg, 0.01)
    with torch.no_grad():
        ttot, tm = TT.loss_fn(tp, {k: _t(v) for k, v in batch.items()},
                              tcfg, 0.01)
    _close(float(ttot), float(jtot), 1e-4, 0.0, "total")
    for k in ("loss", "aux_loss", "perplexity"):
        _close(float(tm[k]), float(jm[k]), 1e-4, 0.0, k)


def test_adamw_step_matches_jax():
    """One AdamW update from a learning rate that moves every leaf, on
    seeded parameters, gradients and moments."""
    rng = np.random.default_rng(9)
    shapes = {"w": (8, 6), "b": (6,), "n": {"k": (3, 4, 5)}}
    mk = lambda: jax.tree_util.tree_map(  # noqa: E731
        lambda s: rng.normal(0, 1, s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    p, g, m = mk(), mk(), mk()
    v = jax.tree_util.tree_map(np.abs, mk())
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=2.0)
    jnew, jst, jm = JO.adamw_step(
        *[jax.tree_util.tree_map(jnp.asarray, t) for t in (p, g)],
        {"m": jax.tree_util.tree_map(jnp.asarray, m),
         "v": jax.tree_util.tree_map(jnp.asarray, v)},
        jnp.asarray(5), JO.OptimizerConfig(**ocfg))
    tnew, tst, tm = TO.adamw_step(
        *[TO.tree_map(_t, t) for t in (p, g)],
        {"m": TO.tree_map(_t, m), "v": TO.tree_map(_t, v)},
        torch.tensor(5), TO.OptimizerConfig(**ocfg))
    for k in ("grad_norm", "lr"):
        _close(float(tm[k]), float(jm[k]), 1e-6, 0.0, k)
    for (path, ja, ta) in _leaf_pairs(
            {"p": jnew, "m": jst["m"], "v": jst["v"]},
            {"p": tnew, "m": tst["m"], "v": tst["v"]}):
        _close(ta, ja, 1e-5, 1e-7, path)


def test_three_train_steps_match_jax(model):
    """Three steps of each package's make_train_step, default TrainConfig
    (the warmup's learning rate), from the same parameters and batches.
    (At a learning rate of full size from the first step, AdamW moves
    each leaf by about lr whatever its gradient's size, so leaves whose
    gradient is rounding noise move by float noise of that size: the
    two packages part after two steps, as two runs of one package on
    two machines would.)"""
    jcfg, tcfg, jp, tp, tokens, labels = model
    jstep = jax.jit(JT.make_train_step(jcfg, JT.TrainConfig()))
    tstep = TT.make_train_step(tcfg, TT.TrainConfig())
    jstate = {"params": jp, "opt": JO.init_opt_state(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": tp, "opt": TO.init_opt_state(tp),
              "step": torch.zeros((), dtype=torch.int32)}
    rng = np.random.default_rng(8)
    for i in range(3):
        toks = tokens if i == 0 else rng.integers(
            0, jcfg.vocab_size, tokens.shape).astype(np.int32)
        batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: _t(v) for k, v in batch.items()})
        for k in ("loss", "aux_loss", "grad_norm", "lr"):
            _close(float(tm[k]), float(jm[k]), 1e-4, 0.0, f"step {i} {k}")
    assert int(tstate["step"]) == 3
    for path, ja, ta in _leaf_pairs(jstate["params"], tstate["params"]):
        _close(ta, ja, 1e-4, 1e-6, path)


def test_microbatch_accumulation_means_the_slices(model):
    """With ``microbatches=2`` over a batch of two equal halves, the
    accumulated gradients and metrics are one half's."""
    _, tcfg, _, tp, tokens, labels = model
    half = {"tokens": _t(tokens[:1]), "labels": _t(labels[:1])}
    both = {k: torch.cat([v, v]) for k, v in half.items()}
    one_g, one_m = TT._microbatch_grads(tp, half, tcfg, TT.TrainConfig())
    two_g, two_m = TT._microbatch_grads(
        tp, both, dataclasses.replace(tcfg, microbatches=2),
        TT.TrainConfig())
    for k in ("loss", "aux_loss"):
        _close(float(two_m[k]), float(one_m[k]), 1e-6, 0.0, k)
    for a, b in zip(TO.tree_leaves(two_g), TO.tree_leaves(one_g)):
        _close(a, b, 1e-5, 1e-8)
