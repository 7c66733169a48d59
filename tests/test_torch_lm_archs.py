"""The port's modules for the LM architectures past GQA and Mamba (the
GELU MLP, RWKV6's time-mix and channel-mix, cross-attention, MLA, their
blocks and the whisper encoder) against the JAX package, on the CPU, at
the reduced configs (float32, d_model 64).

The same numpy inputs, made from a seed, and the JAX package's
parameters carried across as numpy go through both packages. A gated
cross block's ``gate`` starts at 0, where the block adds nothing, so
every gate is opened to 0.5 in the numpy parameters before either
package gets them. Tolerances:

- ``_wkv_scan``: the final state rtol 1e-5 / atol 1e-6 (the same float32
  recurrence); y rtol 1e-5 / atol 1e-5, and no further from the float64
  recurrence than twice the JAX package's own distance from it. On the
  CPU, XLA contracts y_t's head dim as a chain of fused multiply-adds,
  and PyTorch's matmul in another order: on the reduced model's own
  inputs the JAX y itself lies up to several 1e-6 from the float64
  value, past an atol of 1e-6 at entries near zero;
- modules and blocks: rtol 1e-4 / atol 1e-5; ``loss_fn``: values rtol
  1e-4 / atol 1e-5, gradients rtol 5e-4 with a floor of 5e-6 of each
  leaf's largest entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

from repro import configs as JC
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import lm as JLM
from repro.models import ssm as JS
from repro.training import train_loop as JT
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TBK
from repro_torch.models import lm as TLM
from repro_torch.models import ssm as TS
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TT

CPU = "cpu"
RWKV, MLA, VISION, WHISPER = ("rwkv6-1.6b", "deepseek-v2-236b",
                              "llama-3.2-vision-90b", "whisper-tiny")
B, S = 2, 16


def _cfgs(arch):
    return JC.get_config(arch).reduced(), TC.get_config(arch).reduced()


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _open_gates(tree):
    """The numpy tree with every ``gate`` leaf at 0.5."""
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
    elif isinstance(tree, (list, tuple)):
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


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


# ---------------------------------------------------------------------------
# The GELU MLP and RWKV6
# ---------------------------------------------------------------------------

def test_gelu_mlp_matches_jax_in_the_tanh_form():
    jcfg, tcfg = _cfgs(WHISPER)
    jp = JB.init_gelu_mlp(jax.random.PRNGKey(0), jcfg.d_model, jcfg.d_ff)
    tp = {k: _t(v) for k, v in _np_tree(jp).items()}
    x = _x(0, B, S, jcfg.d_model)
    want = JB.gelu_mlp(jp, jnp.asarray(x), jnp.float32)
    _close(TBK.gelu_mlp(tp, _t(x), torch.float32), want, 1e-4, 1e-5)
    # jax.nn.gelu's default is the tanh form; torch's default (erf) is not
    z = _x(1, 4096) * 3
    _close(Fn.gelu(_t(z), approximate="tanh"), jax.nn.gelu(jnp.asarray(z)),
           1e-5, 1e-6)
    assert float((Fn.gelu(_t(z)) - _t(jax.nn.gelu(jnp.asarray(z)))).abs()
                 .max()) > 1e-4


def _wkv_inputs(seed, jcfg):
    """r, k, v and the log-decay of the reduced RWKV6 time-mix on seeded
    activations, split into heads; u and a carried-in state."""
    jp = JS.init_rwkv6(jax.random.PRNGKey(seed), jcfg)
    x = jnp.asarray(_x(seed, B, 32, jcfg.d_model))
    r, k, v, _, logw = JS._rwkv_inputs(jp, x, jnp.zeros((B, jcfg.d_model)),
                                       jcfg)
    nh, hd = jcfg.d_model // jcfg.rwkv_head_dim, jcfg.rwkv_head_dim
    ins = [np.array(JS._heads(t, nh, hd)) for t in (r, k, v, logw)]
    return ins + [np.array(jp["u"])], nh, hd


def _wkv_f64(r, k, v, logw, u, s0):
    """The WKV6 recurrence in float64 (numpy), the exact value both
    packages' float32 loops round."""
    r, k, v, logw, u, s = (np.asarray(a, np.float64)
                           for a in (r, k, v, logw, u, s0))
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(np.einsum("bhk,bhkv->bhv", r[:, t],
                            s + u[None, :, :, None] * kv))
        s = np.exp(logw[:, t])[..., None] * s + kv
    return np.stack(ys, axis=1), s


@pytest.mark.parametrize("carried", [False, True])
def test_wkv_scan_matches_jax(carried):
    jcfg, _ = _cfgs(RWKV)
    ins, nh, hd = _wkv_inputs(3, jcfg)
    s0 = np.zeros((B, nh, hd, hd), np.float32)
    if carried:
        s0 = np.array(JS._wkv_scan(*map(jnp.asarray, ins + [s0]))[1])
    jy, js = (np.array(a) for a in jax.jit(JS._wkv_scan)(
        *map(jnp.asarray, ins + [s0])))
    ty, ts = TS._wkv_scan(*[_t(a) for a in ins + [s0]])
    assert ty.dtype == ts.dtype == torch.float32
    _close(ts, js, 1e-5, 1e-6, "final state")
    _close(ty, jy, 1e-5, 1e-5, "y")
    y64, s64 = _wkv_f64(*ins, s0)
    assert (np.abs(ty.numpy() - y64).max()
            <= 2 * np.abs(jy - y64).max() + 1e-7)
    assert (np.abs(ts.numpy() - s64).max()
            <= 2 * np.abs(js - s64).max() + 1e-7)


def test_rwkv6_forward_matches_jax_from_no_state_and_a_carried_one():
    jcfg, tcfg = _cfgs(RWKV)
    jp = JS.init_rwkv6(jax.random.PRNGKey(4), jcfg)
    tp = {k: _t(v) for k, v in _np_tree(jp).items()}
    x = _x(4, B, 2 * S, jcfg.d_model)
    jx1, jx2 = jnp.asarray(x[:, :S]), jnp.asarray(x[:, S:])
    jy1, jst = JS.rwkv6_forward(jp, jx1, jcfg, return_state=True)
    jy2, jst2 = JS.rwkv6_forward(jp, jx2, jcfg, state=jst, return_state=True)
    ty1, tst = TS.rwkv6_forward(tp, _t(x[:, :S]), tcfg, return_state=True)
    _close(ty1, jy1, 1e-4, 1e-5, "y from no state")
    _close_trees(tst, jst, 1e-4, 1e-5, "state")
    ty2, tst2 = TS.rwkv6_forward(tp, _t(x[:, S:]), tcfg, state=tst,
                                 return_state=True)
    _close(ty2, jy2, 1e-4, 1e-5, "y from the carried state")
    _close_trees(tst2, jst2, 1e-4, 1e-5, "carried state")
    # the two segments are the whole sequence
    whole = TS.rwkv6_forward(tp, _t(x), tcfg)
    _close(whole[:, S:], ty2, 1e-4, 1e-5, "segments against the whole")
    st = TS.init_rwkv6_state(tcfg, 3)
    assert st["wkv"].dtype == torch.float32 and st["x_prev"].shape == (
        3, tcfg.d_model)


def test_rwkv_channel_mix_matches_jax():
    jcfg, tcfg = _cfgs(RWKV)
    jp = JS.init_rwkv_cm(jax.random.PRNGKey(5), jcfg)
    tp = {k: _t(v) for k, v in _np_tree(jp).items()}
    x, prev = _x(5, B, S, jcfg.d_model), _x(6, B, jcfg.d_model)
    for x_prev in (None, prev):
        jy, jlast = JS.rwkv_cm_forward(
            jp, jnp.asarray(x), jcfg,
            None if x_prev is None else jnp.asarray(x_prev),
            return_state=True)
        ty, tlast = TS.rwkv_cm_forward(
            tp, _t(x), tcfg, None if x_prev is None else _t(x_prev),
            return_state=True)
        _close(ty, jy, 1e-4, 1e-5, f"y, x_prev {x_prev is not None}")
        _close(tlast, jlast, 0, 0, "the last token")


# ---------------------------------------------------------------------------
# Cross-attention and MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gated", [False, True])
def test_cross_attention_matches_jax(gated):
    jcfg, tcfg = _cfgs(VISION)
    jp = _open_gates(_np_tree(JA.init_cross(jax.random.PRNGKey(6), jcfg,
                                            gated)))
    tp = {k: _t(v) for k, v in jp.items()}
    x, mem = _x(7, B, S, jcfg.d_model), _x(8, B, 11, jcfg.d_model)
    jkv = JA.cross_kv(jp, jnp.asarray(mem), jcfg)
    tkv = TA.cross_kv(tp, _t(mem), tcfg)
    for g, w in zip(tkv, jkv):
        assert g.shape == (B, tcfg.n_kv_heads, 11, tcfg.head_dim)
        _close(g, w, 1e-4, 1e-5, "cross K/V")
    jy = JA.cross_forward(jp, jnp.asarray(x), jkv, jcfg)
    ty = TA.cross_forward(tp, _t(x), tkv, tcfg)
    _close(ty, jy, 1e-4, 1e-5, "cross y")
    if gated:
        ungated = TA.cross_forward({k: v for k, v in tp.items()
                                    if k != "gate"}, _t(x), tkv, tcfg)
        _close(ty, np.tanh(0.5) * ungated.numpy(), 1e-5, 1e-7, "tanh gate")
    with pytest.raises(ValueError, match="memory"):
        TA.cross_kv(tp, None, tcfg)


def test_mla_forward_and_absorbed_decode_match_jax():
    jcfg, tcfg = _cfgs(MLA)
    jp = JA.init_mla(jax.random.PRNGKey(9), jcfg)
    tp = {k: _t(v) for k, v in _np_tree(jp).items()}
    x = _x(9, B, S, jcfg.d_model)
    pos = np.arange(S, dtype=np.int32)[None]
    jy, (jc, jr) = JA.mla_forward(jp, jnp.asarray(x), jnp.asarray(pos),
                                  jcfg, return_kv=True)
    ty, (tc, tr) = TA.mla_forward(tp, _t(x), _t(pos), tcfg, return_kv=True)
    _close(ty, jy, 1e-4, 1e-5, "forward y")
    _close(tc, jc, 1e-4, 1e-5, "c_kv")
    _close(tr, jr, 1e-4, 1e-5, "k_rope")
    # absorbed decode at position S from a cache holding the prompt
    max_len = S + 4
    jcache = JA.init_mla_cache(jcfg, B, max_len, jnp.float32)
    jcache = {"c_kv": jcache["c_kv"].at[:, :S].set(jc),
              "k_rope": jcache["k_rope"].at[:, :S].set(jr)}
    tcache = convert.lm_cache_from_numpy(
        jax.tree_util.tree_map(lambda a: np.array(a)[None], jcache),
        dataclasses.replace(tcfg, n_layers=1), device=CPU)[0]
    x1 = _x(10, B, 1, jcfg.d_model)
    jy1, jc1 = JA.mla_decode(jp, jnp.asarray(x1), jcache, S, jcfg)
    ty1, tc1 = TA.mla_decode(tp, _t(x1), tcache, S, tcfg)
    _close(ty1, jy1, 1e-4, 1e-5, "decode y")
    _close_trees(tc1, jc1, 1e-4, 1e-5, "decode cache")
    assert tc1["c_kv"] is tcache["c_kv"]           # written in place
    assert float(tc1["c_kv"][:, S].abs().sum()) > 0
    with pytest.raises(ValueError, match="outside"):
        TA.mla_decode(tp, _t(x1), tcache, max_len, tcfg)


# ---------------------------------------------------------------------------
# Blocks and the encoder
# ---------------------------------------------------------------------------

BLOCKS = {
    "mla-moe": (MLA, dict(mixer="mla", ffn="moe")),
    "rwkv6-rwkv_cm": (RWKV, dict(mixer="rwkv6", ffn="rwkv_cm")),
    "cross_gated-swiglu": (VISION, dict(mixer="cross", ffn="swiglu",
                                        gated=True)),
    "gqa-gelu-cross": (WHISPER, dict(mixer="gqa", ffn="gelu", cross=True)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_forward_prefill_and_decode_match_jax(name):
    arch, kw = BLOCKS[name]
    jcfg, tcfg = _cfgs(arch)
    jdesc, tdesc = JC.BlockDesc(**kw), TC.BlockDesc(**kw)
    jp = _open_gates(_np_tree(JB.init_block(jax.random.PRNGKey(11), jcfg,
                                            jdesc)))
    tp = jax.tree_util.tree_map(_t, jp)
    x, x1 = _x(11, B, S, jcfg.d_model), _x(12, B, 1, jcfg.d_model)
    mem = _x(13, B, 10, jcfg.d_model)             # 10 != max_len
    pos = np.arange(S, dtype=np.int32)[None]
    max_len = S + 8
    jmem = jnp.asarray(mem)

    def jrun(p):
        y, aux = JB.block_forward(p, jnp.asarray(x), jcfg, jdesc,
                                  positions=jnp.asarray(pos), memory=jmem)
        c = JB.init_block_cache(jcfg, jdesc, B, max_len, max_len)
        yp, c = JB.block_prefill(p, jnp.asarray(x), jcfg, jdesc, c,
                                 positions=jnp.asarray(pos), memory=jmem)
        y1, c1 = JB.block_decode(p, jnp.asarray(x1), jcfg, jdesc, c, pos=S)
        return y, aux, yp, c, y1, c1

    jy, jaux, jyp, jc, jy1, jc1 = _np_tree(jax.jit(jrun)(jp))
    ty, taux = TBK.block_forward(tp, _t(x), tcfg, tdesc, positions=_t(pos),
                                 memory=_t(mem))
    _close(ty, jy, 1e-4, 1e-5, "forward x")
    _close(float(taux), float(jaux), 1e-4, 0.0, "aux")
    cache = TBK.init_block_cache(tcfg, tdesc, B, max_len, max_len,
                                 device=CPU)
    _close_trees(cache, _np_tree(JB.init_block_cache(
        jcfg, jdesc, B, max_len, max_len)), 0, 0, "fresh cache")
    typ, tc = TBK.block_prefill(tp, _t(x), tcfg, tdesc, cache,
                                positions=_t(pos), memory=_t(mem))
    _close(typ, jyp, 1e-4, 1e-5, "prefill x")
    _close_trees(tc, jc, 1e-4, 1e-5, "prefill cache")
    if "cross_kv" in tc:                  # the memory's length, not max_len
        assert tc["cross_kv"]["k"].shape[2] == 10
    ty1, tc1 = TBK.block_decode(tp, _t(x1), tcfg, tdesc, tc, pos=S)
    _close(ty1, jy1, 1e-4, 1e-5, "decode x")
    _close_trees(tc1, jc1, 1e-4, 1e-5, "decode cache")


def test_encode_matches_jax():
    jcfg, tcfg = _cfgs(WHISPER)
    jparams = _np_tree(jax.jit(JLM.init_params, static_argnums=1)(
        jax.random.PRNGKey(12), jcfg))
    tparams = convert.lm_params_from_numpy(jparams, tcfg, device=CPU)
    assert len(tparams["enc_groups"]) == tcfg.enc_layers == 2
    assert tparams["enc_groups"][1]["b0"]["ffn"]["w_in"].shape == (
        tcfg.d_model, tcfg.d_ff)
    frames = _x(12, B, 10, jcfg.d_model)
    want = JLM.encode(jparams, jnp.asarray(frames), jcfg)
    got = TLM.encode(tparams, _t(frames), tcfg)
    assert got.shape == (B, 10, tcfg.d_model)
    _close(got, want, 1e-4, 1e-5, "encoder output")
    with pytest.raises(ValueError, match="enc_layers"):
        convert.lm_params_from_numpy(
            jparams, dataclasses.replace(tcfg, enc_layers=3), device=CPU)


# ---------------------------------------------------------------------------
# Gradients through RWKV6 and MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [RWKV, MLA])
def test_loss_fn_gradients_reach_the_block_leaves_as_in_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jparams = jax.jit(JLM.init_params, static_argnums=1)(
        jax.random.PRNGKey(13), jcfg)
    tparams = convert.lm_params_from_numpy(_np_tree(jparams), tcfg,
                                           device=CPU)
    rng = np.random.default_rng(13)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    (jtot, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                             jcfg, 0.01), has_aux=True))(jparams)
    tg, tm = TT._value_and_grad(tparams, {k: _t(v) for k, v in batch.items()},
                                tcfg, 0.01)
    for k in ("loss", "aux_loss"):
        _close(float(tm[k]), float(jm[k]), 1e-4, 1e-5, k)
    jblock = jax.tree_util.tree_map(lambda a: np.array(a[0]),
                                    jg["groups"]["b0"])
    n = 0
    for (path, g), (_, w) in zip(_flat(tg["groups"][0]["b0"]),
                                 _flat(jblock)):
        scale = float(np.abs(w).max())
        assert scale > 0, path                    # the loss reaches it
        _close(g, w, 5e-4, 5e-6 * scale, f"grad {path}")
        n += 1
    assert n == len(TO.tree_leaves(tparams["groups"][0]["b0"]))
