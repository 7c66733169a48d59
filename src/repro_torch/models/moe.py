"""Mixture-of-Experts FFN with expert parallelism.

Routers: ``"softmax"`` (learned top-k) and ``"fcm"``, the paper's fuzzy
bridge: the router's columns are cluster centers over token embeddings
and the gate is the FCM membership (Eq. 4, m = 2) cut to the top k.
Dispatch is the JAX package's capacity-bounded first-come policy: each
expert takes at most ``capacity`` (token, slot) pairs in token order,
gathers their rows into a buffer, runs its SwiGLU, and the gated rows
are added back per token.

**Expert parallelism.** Under a mesh whose ``"model"`` (tp) axis is
larger than 1 the expert stacks are padded to a multiple of tp (dead
experts are never routed to) and each tp rank owns ``E_pad / tp`` of
them. The tokens split over the dp axes as the pruned ``("dp",)`` spec
says, capacity comes from a shard's *local* token count, each (dp shard,
tp rank) runs :func:`_local_expert_ffn` on its experts on its device,
and the ranks' outputs are summed on the lead device in rank order (the
JAX package's ``psum`` over tp). Routing, and so the aux loss, stays
global. Per-shard capacity makes the result differ from ``tp == 1`` by
design wherever capacity binds. With the expert stacks placed across
the mesh (:func:`repro_torch.models.sharding.place`), rank r takes its
experts from the blocks of the slots at tp index r, gathered over the
fsdp axes only; no whole stack exists anywhere.
"""
from __future__ import annotations

import torch
import torch.nn.functional as Fn

from ..analysis import op_cost
from . import layers as L
from . import sharding as sh


#: the expert stacks, split over "tp" by :func:`spec_moe`
EXPERT_STACKS = ("w_gate", "w_up", "w_down")


def init_moe(gen: torch.Generator, cfg):
    e = cfg.moe
    d, f = cfg.d_model, e.d_ff_expert
    p = {
        "router": L.init_dense(gen, (d, e.n_experts), d),
        "w_gate": L.init_dense(gen, (e.n_experts, d, f), d),
        "w_up": L.init_dense(gen, (e.n_experts, d, f), d),
        "w_down": L.init_dense(gen, (e.n_experts, f, d), f),
    }
    if e.n_shared > 0:
        p["shared"] = L.init_mlp(gen, d, e.n_shared * f)
    return p


def spec_moe(cfg):
    s = {"router": ("fsdp", None),
         "w_gate": ("tp", "fsdp", None), "w_up": ("tp", "fsdp", None),
         "w_down": ("tp", None, "fsdp")}
    if cfg.moe.n_shared > 0:
        s["shared"] = L.spec_mlp()
    return s


def _route(xf, router_w, cfg):
    """Token -> (top-k ids (T, k), gates (T, k), aux load-balance loss).
    xf (T, D)."""
    e = cfg.moe
    if e.router == "fcm":
        # router columns are cluster centers; gate = fuzzy membership with
        # m = 2 (Eq. 4 of the paper): u_e proportional to 1 / d2_e
        centers = router_w.t().to(torch.float32)               # (E, D)
        x32 = xf.to(torch.float32)
        d2 = (torch.sum(x32 * x32, dim=-1, keepdim=True)
              - 2.0 * (x32 @ centers.t())
              + torch.sum(centers * centers, dim=-1)[None, :])
        p = 1.0 / torch.clamp(d2, min=1e-6)
        probs = p / torch.sum(p, dim=-1, keepdim=True)
    else:
        logits = xf.to(torch.float32) @ router_w.to(torch.float32)
        probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, e.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux loss
    density = torch.mean(_one_hot(idx[:, 0], e.n_experts, torch.float32),
                         dim=0)
    mean_prob = torch.mean(probs, dim=0)
    aux = e.n_experts * torch.sum(density * mean_prob)
    return idx, gates.to(xf.dtype), aux


def _one_hot(x: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``x``'s one-hot rows over classes ``0 .. n - 1`` in ``dtype`` (a
    row of zeros past them), as an ``eq`` against the class ids: the
    same ops on real and fake tensors (``one_hot`` checks its range on
    real ones, a host sync on the card), so a dry-run counts what the
    card runs."""
    return (x[..., None] == torch.arange(n, device=x.device)).to(dtype)


def _local_expert_ffn(xf, idx, gates, wg, wu, wd, e_start: int,
                      capacity: int, dtype):
    """Capacity-bounded dispatch for the experts [e_start, e_start +
    E_loc). xf (T, D); idx / gates (T, K)."""
    t, dmodel = xf.shape
    k = idx.shape[1]
    e_loc = wg.shape[0]
    dev = xf.device
    le = idx.reshape(-1) - e_start                           # (T*K,)
    local = (le >= 0) & (le < e_loc)
    le_c = torch.where(local, le, e_loc)                     # overflow bucket
    # running rank within each expert (first-come capacity policy); the
    # overflow bucket has no column, as jax.nn.one_hot drops it
    onehot = _one_hot(le_c, e_loc, torch.int32)
    rank = torch.cumsum(onehot, dim=0) - onehot              # entries before
    pos = torch.sum(rank * onehot, dim=-1)                   # (T*K,)
    keep = local & (pos < capacity)
    slot = torch.where(keep, le_c * capacity + pos, e_loc * capacity)
    # scatter token ids, gather rows: no (T*K, D) repeated-token matrix
    tok_id = torch.arange(t * k, device=dev) // k
    buf_tok = torch.full((e_loc * capacity + 1,), t, dtype=torch.long,
                         device=dev)
    buf_tok[slot] = torch.where(keep, tok_id, t)
    xf_ext = torch.cat([xf.to(dtype),
                        torch.zeros((1, dmodel), dtype=dtype, device=dev)])
    xe = xf_ext[buf_tok[:-1]].reshape(e_loc, capacity, dmodel)
    h = torch.einsum("ecd,edf->ecf", xe, wg.to(dtype))
    u = torch.einsum("ecd,edf->ecf", xe, wu.to(dtype))
    h = Fn.silu(h) * u
    ye = torch.einsum("ecf,efd->ecd", h, wd.to(dtype))
    rows = torch.cat([ye.reshape(-1, dmodel),
                      torch.zeros((1, dmodel), dtype=dtype, device=dev)])
    contrib = rows[slot] * torch.where(keep, gates.reshape(-1), 0.0)[:, None]
    return contrib.reshape(t, k, dmodel).sum(dim=1)          # (T, D)


def _capacity(e, t_local: int) -> int:
    return int(max(e.top_k * t_local / e.n_experts * e.capacity_factor, 4))


def _rank_experts(w, r: int, e_loc: int, dev, ctx: sh.Parallelism,
                  share: float):
    """Rank ``r``'s ``e_loc`` experts of the stack ``w`` on ``dev``,
    padded with dead (zero) experts past the stack's end. A placed stack
    is gathered from the slots at tp index r over the fsdp axes; where
    its spec could not split the experts over tp (E not a multiple of
    tp) those slots hold every expert, and the rank's are cut from
    them."""
    if sh.is_placed(w):
        split = w.spec[0] is not None
        w = sh.gather(w, dev, keep={ctx.tp_axis: r}, share=share)
        if split:
            return w
    part = w[r * e_loc:(r + 1) * e_loc].to(dev)
    if part.shape[0] < e_loc:
        part = torch.cat([part, part.new_zeros(
            (e_loc - part.shape[0],) + tuple(part.shape[1:]))])
    return part


def _expert_parallel_ffn(p, xf, idx, gates, cfg, ctx: sh.Parallelism):
    """The expert-parallel dispatch: each (dp shard, tp rank) runs
    :func:`_local_expert_ffn` over its tokens and its experts on its
    device; per shard, the ranks' outputs summed on ``xf``'s device in
    rank order; the shards concatenated in order. xf (T, D) -> (T, D)."""
    e = cfg.moe
    tp = ctx.tp_size
    e_pad = -(-e.n_experts // tp) * tp
    e_loc = e_pad // tp
    stacks = [p[k] for k in EXPERT_STACKS]
    # the stacks' tensors (a placed stack's blocks) go into the loop as
    # its inputs, so that a dry-run's one trip carries their gradients
    counts = [len(sh.tensors_of(w)) for w in stacks]
    flat = [t for w in stacks for t in sh.tensors_of(w)]
    shards = sh.dp_shards(ctx, xf.shape[0])
    capacity = _capacity(e, xf.shape[0] // len(shards))
    lead = xf.device
    # every (shard, rank) costs the same: a dry-run counts one
    loop = op_cost.repeat(len(shards) * tp)

    def dispatch(trips, xf, gates, *ts):
        ws, i = [], 0
        for w, n in zip(stacks, counts):
            ws.append(w.with_tensors(ts[i:i + n]) if sh.is_placed(w)
                      else ts[i])
            i += n
        outs = []
        for rows, coords in shards[:max(1, trips // tp)]:
            total = None
            for r in range(min(tp, trips)):
                dev = sh.device_at(ctx.mesh, {**coords, ctx.tp_axis: r})
                part = _local_expert_ffn(
                    xf[rows].to(dev), idx[rows].to(dev), gates[rows].to(dev),
                    *(_rank_experts(w, r, e_loc, dev, ctx, 1 / len(shards))
                      for w in ws), r * e_loc, capacity, cfg.dtype).to(lead)
                total = part if total is None else total + part
            outs.append(total)
        return (torch.cat(outs),)

    # a placed stack's block is read by its tp rank's trips alone (a
    # fake tensor's reads stand for those of the blocks it stands for), a
    # whole stack by every trip
    reads = [len(shards) * tp] * 2 + [
        1 + w.stands_for() * (len(shards) - 1) if sh.is_placed(w)
        else len(shards) * tp
        for w, n in zip(stacks, counts) for _ in range(n)]
    out, = loop.run(dispatch, xf, gates, *flat, reads=reads)
    for rows, _ in shards:          # each shard's psum over the tp ranks
        op_cost.collective("all-reduce", (rows.stop - rows.start)
                           * out.shape[1] * out.element_size(), tp)
    return loop.fill(out, 0, len(shards))


def moe_ffn(p, x, cfg):
    """x (B, S, D) -> (out (B, S, D), aux_loss scalar)."""
    e = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    idx, gates, aux = _route(xf, p["router"], cfg)
    ctx = sh.current()
    if ctx.tp_size > 1:
        out = _expert_parallel_ffn(p, xf, idx, gates, cfg, ctx)
    else:
        out = _local_expert_ffn(xf, idx, gates, p["w_gate"], p["w_up"],
                                p["w_down"], 0, _capacity(e, t), cfg.dtype)
    if "shared" in p:
        out = out + L.mlp(p["shared"], x, cfg.dtype).reshape(t, d)
    return out.reshape(b, s, d), aux
