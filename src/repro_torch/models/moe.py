"""Mixture-of-experts MLP with group-limited capacity dispatch
(GShard-style); port of ``repro/models/moe.py``.

Tokens are split into groups of ``group_size``; within a group every
token scores every expert in fp32, the top-k gates are renormalised, and
tokens take expert slots in rank-major order (all rank-0 choices first)
up to the capacity C = ceil(k·g/X · capacity_factor). Overflow choices
are dropped: the token keeps its other choices and the shared experts.
Capacity is shared by everything in a group: the zero rows that pad T to
a multiple of g, and in a decode step every slot of the batch, so a
token's output depends on its groupmates, as in the reference.

The groups run as one batched computation (a leading group axis), the
expert products as batched matrix products over the expert axis. Two
dispatches, as the reference's: ``"einsum"`` (the GShard one-hot
products, ``cfg.moe_dispatch``'s default) and ``"gather"`` (a slot →
token table built by one scatter, then gathers). One-hot products in
fp32 select exactly, so both give the experts the same inputs; only the
combine's sum of k terms may round differently.

Ties: the reference's ``lax.top_k`` takes the lower expert index first
among equal probabilities, and ties are real here (zero pad rows route
uniformly; padded experts all sit at −1e9). ``torch.topk`` promises no
order for ties, so the top k come from a stable descending sort.

``apply_moe(..., routing=[])`` appends each call's routing decisions to
the list (a seam for the tests and ``chip_smoke.py``, in the manner of
the serving noise sources); the model path passes none.

Under a mesh (``shard``, ``mesh``) the router is replicated and every
rank routes the identical residual, so routing, capacity and drops are
the same on every rank. Where the experts shard over "model" (their
count divides it: deepseek) a rank runs ``_expert_ffn`` on its experts'
slots and combines only those; otherwise (granite's 40 experts against
16, padded experts) each expert's F shards and a rank runs every expert
on its slice of F. The shared experts shard on F. Each gives a partial
sum, and one all-reduce over "model" (``finish``) finishes the sum.
Under autograd the tokens enter the rank's experts and the router's
gates enter where they scale the rank's partial outputs
(``enter_model_region``); the aux loss reads the router whole on every
rank, and its gradient is not summed.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.layers import _act, dense_init
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import model_rank

Tensor = torch.Tensor

DEFAULT_GROUP = 512


def init_moe(cfg: ModelConfig, generator: torch.Generator, alloc=None) -> dict:
    """``router`` (E, X_phys) fp32 always; ``w_in``/``w_gate`` (X_phys,
    E, F) and ``w_out`` (X_phys, F, E) in the config's dtype; with shared
    experts the fused ``shared`` MLP (E, Fs)/(Fs, E). Drawn from
    ``generator`` in the reference's order, into leaves from ``alloc``
    where given (``layers.new_leaf``)."""
    mc = cfg.moe
    E, F, X = cfg.d_model, mc.expert_ffn, mc.physical_experts
    dtype = getattr(torch, cfg.dtype)
    draw = lambda shape, dt=dtype, fan=None: dense_init(shape, generator=generator, dtype=dt,
                                                        fan_in=fan, alloc=alloc)
    p = {"router": draw((E, X), torch.float32),
         "w_in": draw((X, E, F), fan=E),
         "w_gate": draw((X, E, F), fan=E),
         "w_out": draw((X, F, E), fan=F)}
    if mc.num_shared_experts:
        Fs = mc.shared_ffn or mc.num_shared_experts * F
        p["shared"] = {"w_in": draw((E, Fs)), "w_gate": draw((E, Fs)), "w_out": draw((Fs, E))}
    return p


def _capacity(group: int, mc: MoEConfig) -> int:
    return max(int(math.ceil(mc.top_k * group / mc.num_experts * mc.capacity_factor)), 1)


class Route(NamedTuple):
    """The routing of groups (n, g, E): gate_vals (n, g, k) fp32,
    expert_idx (n, g, k), onehot (n, g, k, X_phys) fp32, pos and keep
    (n, k·g) rank-major, aux (n,), and each token's top-k margin (n, g):
    the smallest gap among its k + 1 largest probabilities over the
    largest, how near the choice and order of its top k are to a tie."""
    gate_vals: Tensor
    expert_idx: Tensor
    onehot: Tensor
    pos: Tensor
    keep: Tensor
    aux: Tensor
    margin: Tensor


def _route_common(xg: Tensor, params: dict, cfg: ModelConfig, C: int) -> Route:
    """Router and slot assignment shared by both dispatches (reference :63)."""
    mc = cfg.moe
    n, g, _ = xg.shape
    X, Xp, k = mc.num_experts, mc.physical_experts, mc.top_k

    logits = xg.to(torch.float32) @ params["router"]  # (n, g, Xp)
    if Xp > X:  # padded experts (sharding alignment) are never routable
        logits = torch.cat([logits[..., :X], logits.new_full((n, g, Xp - X), -1e9)], dim=-1)
    probs = torch.softmax(logits, dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = ranked[..., :k], order[..., :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    onehot = torch.nn.functional.one_hot(expert_idx, Xp).to(torch.float32)  # (n, g, k, Xp)
    # fraction of routing decisions to each expert, normalised by k so a
    # perfectly balanced router scores exactly 1.0 before weighting
    fraction = onehot.sum(2).mean(1)[:, :X] / k
    aux = X * torch.sum(fraction * probs[..., :X].mean(1), dim=-1)

    # slot positions, rank-major priority, counted in integers: the same
    # values as the reference's fp32 cumsum, which is exact up to k·g
    oh_flat = onehot.transpose(1, 2).reshape(n, k * g, Xp).to(torch.int32)
    flat_expert = expert_idx.transpose(1, 2).reshape(n, k * g)
    pos = torch.cumsum(oh_flat, dim=1).gather(2, flat_expert[..., None])[..., 0] - 1
    keep = pos < C

    top = ranked[..., :k + 1]
    if top.shape[-1] > 1:
        margin = (top[..., :-1] - top[..., 1:]).min(-1).values / top[..., 0]
    else:  # one expert: no choice to make
        margin = torch.full_like(top[..., 0], math.inf)
    return Route(gate_vals, expert_idx, onehot, pos, keep, aux, margin)


def _expert_ffn(expert_in: Tensor, params: dict, cfg: ModelConfig) -> Tensor:
    """(n, X, C, E) → (n, X, C, E), batched products over the expert axis."""
    h = torch.einsum("nxce,xef->nxcf", expert_in, params["w_in"])
    gt = torch.einsum("nxce,xef->nxcf", expert_in, params["w_gate"])
    return torch.einsum("nxcf,xfe->nxce", _act(gt, cfg.act) * h, params["w_out"])


def _dispatch_einsum(xg: Tensor, params: dict, cfg: ModelConfig, C: int, route: Route,
                     experts: Optional[slice] = None) -> Tensor:
    """GShard one-hot products (reference ``_route_group``, :101); with
    ``experts`` (a rank's expert-sharded slice) only those experts' slots
    are filled and combined."""
    gate_vals, onehot, pos = route.gate_vals, route.onehot, route.pos
    n, g, _ = xg.shape
    k = cfg.moe.top_k
    # one_hot(pos, C) · keep: a dropped choice (pos ≥ C) matches no slot
    slot_oh = (pos[..., None] == torch.arange(C, device=xg.device)).to(xg.dtype)
    slot_oh = slot_oh.reshape(n, k, g, C).transpose(1, 2)  # (n, g, k, C)
    oh = onehot.to(xg.dtype)
    disp = torch.einsum("ntkx,ntkc->ntxc", oh, slot_oh)  # (n, g, X, C)
    combine = torch.einsum("ntkx,ntkc,ntk->ntxc", oh, slot_oh, gate_vals.to(xg.dtype))
    if experts is not None:
        disp, combine = disp[:, :, experts], combine[:, :, experts]
    expert_in = torch.einsum("ntxc,nte->nxce", disp, xg)  # (n, X, C, E)
    expert_out = _expert_ffn(expert_in, params, cfg)
    return torch.einsum("ntxc,nxce->nte", combine, expert_out)


def _dispatch_gather(xg: Tensor, params: dict, cfg: ModelConfig, C: int, route: Route,
                     experts: Optional[slice] = None) -> Tensor:
    """A slot → token table and gathers (reference
    ``_route_group_gather``, :125). Overflow choices write the dump column
    C, which is sliced off, so duplicate writes touch only that column.
    With ``experts`` (a rank's expert-sharded slice) only those experts'
    rows of the table run, and a choice of another expert reads zeros."""
    gate_vals, expert_idx, pos, keep = route.gate_vals, route.expert_idx, route.pos, route.keep
    n, g, E = xg.shape
    X, k = cfg.moe.physical_experts, cfg.moe.top_k
    dev = xg.device
    if experts is not None:
        mine = (expert_idx >= experts.start) & (expert_idx < experts.stop)  # (n, g, k)
        keep = keep & mine.transpose(1, 2).reshape(n, k * g)
        expert_idx = torch.where(mine, expert_idx - experts.start, 0)
        X = experts.stop - experts.start

    flat_expert = expert_idx.transpose(1, 2).reshape(n, k * g)  # rank-major
    token_of = torch.arange(g, device=dev).repeat(k).expand(n, k * g)
    pos_c = torch.where(keep, pos, C)
    table = torch.full((n, X * (C + 1)), g, dtype=torch.long, device=dev)  # g: no token
    table.scatter_(1, flat_expert * (C + 1) + pos_c, token_of)
    table = table.view(n, X, C + 1)[..., :C].reshape(n, X * C)
    xg_pad = torch.cat([xg, xg.new_zeros(n, 1, E)], dim=1)
    expert_in = torch.gather(xg_pad, 1, table[..., None].expand(n, X * C, E))
    expert_out = _expert_ffn(expert_in.view(n, X, C, E), params, cfg)

    # combine: token t, rank r reads expert_out[e_r(t), pos_r(t)]
    out_pad = torch.cat([expert_out.reshape(n, X * C, E), expert_out.new_zeros(n, 1, E)], dim=1)
    flat_slot = torch.where(keep, flat_expert * C + pos_c, X * C)
    picked = torch.gather(out_pad, 1, flat_slot[..., None].expand(n, k * g, E))
    gates = gate_vals.transpose(1, 2).reshape(n, k * g, 1).to(xg.dtype)
    return (picked * gates).view(n, k, g, E).sum(1)


def apply_moe(params: dict, x: Tensor, cfg: ModelConfig, *, group_size: int = DEFAULT_GROUP,
              dispatch: str = "einsum", routing: Optional[List[dict]] = None,
              shard: Optional[dict] = None, mesh=None, finish: Optional[Callable] = None
              ) -> Tuple[Tensor, Tensor]:
    """x (B, S, E) → (y (B, S, E), aux loss): T = B·S tokens padded with
    zero rows to a multiple of g = min(group_size, T), the groups routed
    as one batch by ``dispatch`` ("einsum" or "gather"), the shared
    experts over the true T; aux is the groups' mean Switch term times
    ``router_aux_weight``. ``routing`` (tests and the smoke only): a list
    to which the call appends its decisions as a dict of tensors
    ``expert_idx`` (n, g, k), ``pos``/``keep`` (n, k·g) rank-major,
    ``margin`` (n, g) and the int ``tokens`` (T) and ``capacity`` (C)."""
    if dispatch not in ("einsum", "gather"):
        raise ValueError(f"dispatch must be 'einsum' or 'gather', got {dispatch!r}")
    mc = cfg.moe
    B, S, E = x.shape
    T = B * S
    g = min(group_size, T)
    pad = (-T) % g
    xt = x.reshape(T, E)
    if pad:
        xt = torch.cat([xt, xt.new_zeros(pad, E)])
    xG = xt.reshape(-1, g, E)

    C = _capacity(g, mc)
    route = _route_common(xG, params, cfg, C)
    if routing is not None:
        routing.append({"expert_idx": route.expert_idx, "pos": route.pos, "keep": route.keep,
                        "margin": route.margin, "tokens": T, "capacity": C})
    run = _dispatch_gather if dispatch == "gather" else _dispatch_einsum
    # under a mesh, the rank's experts or F slices give partial sums
    n, r = (1, 0) if shard is None else model_rank(mesh)
    routed_split = shared_split = False
    experts = None
    if n > 1:
        routed_split = shard["w_in"].sharded_dim() is not None
        shared_split = mc.num_shared_experts and \
            shard["shared"]["w_out"].sharded_dim() is not None
        if shard["w_in"].sharded_dim() == 0:
            Xl = mc.physical_experts // n
            experts = slice(r * Xl, (r + 1) * Xl)
    partial, whole = [], []
    x_run = xG
    if routed_split:
        # enter: the tokens meet the rank's experts (or F slices), and the
        # router's gates scale the rank's partial expert outputs; the aux
        # loss reads the router whole, on every rank alike
        x_run = coll.enter_model_region(xG, mesh)
        route = route._replace(gate_vals=coll.enter_model_region(route.gate_vals, mesh))
    yt = run(x_run, params, cfg, C, route, experts).reshape(-1, E)[:T]
    (partial if routed_split else whole).append(yt)
    if mc.num_shared_experts:
        sh = params["shared"]
        xt_true = xt[:T]
        if shared_split:  # enter: the rank's F slice of the shared experts
            xt_true = coll.enter_model_region(xt_true, mesh)
        hs = _act(xt_true @ sh["w_gate"], cfg.act) * (xt_true @ sh["w_in"])
        (partial if shared_split else whole).append(hs @ sh["w_out"])
    if finish is None:
        finish = lambda y, split: coll.all_reduce_sum(y, mesh) if split else y
    parts = [finish(sum(p[1:], p[0]).reshape(B, S, E), split)
             for p, split in ((partial, True), (whole, False)) if p]
    return sum(parts[1:], parts[0]), route.aux.mean() * mc.router_aux_weight
