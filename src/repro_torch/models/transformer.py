"""Decoder assembly: embeds → blocks → norm → LM head; port of
``repro/models/transformer.py`` for the layer kinds the port runs.

The layer stack is ``num_repeats`` repeats of the config's (mixer, mlp)
pattern. As in the reference, each pattern position's weights are
stacked on a leading repeat axis (``params["blocks"]["p{i}"]``); where
the reference ``lax.scan``s over that axis, the port loops over it and
takes each layer's weights as views. Decode threads per-layer state,
stacked the same way: a ring-buffer KV cache for attention layers
(written in place), a recurrent state for Mamba2 layers.

Runs every layer kind of the reference: the global ("A"),
sliding-window ("L") and cross-attention ("X", over image embeddings
passed as ``cross_embeds``) mixers and the "M" (Mamba2 SSD) mixer, the
"N" (none), "D" (dense) and "E" (mixture-of-experts, ``models/moe.py``)
MLPs; one token stream or ``num_codebooks`` parallel ones (summed
embeddings, a head a codebook: tokens (B, S, K), logits (B, S, K, V)),
with an untied head or the embedding tied as the head. Parameters
are a nested dict of tensors with the reference's keys and layouts
(a tied model has no ``lm_head``); ``params_from_jax`` copies a
reference tree into one. ``forward(remat=)`` recomputes each layer's
activations in the backward pass ("full") or all but its products
without batch dimensions ("dots"), the reference's ``jax.checkpoint``
policies.
``init_model`` allocates each stacked leaf once and draws every layer
into its view, so building a model takes its weights' memory and no
more (deepseek-moe-16b's 62.9 GiB on an 80 GB card).

Under a ``("data", "model")`` mesh (``mesh=``: the reference's model
placed by ``param_shardings`` and run under an ambient mesh, made
explicit) each rank holds its shard (``init_model(mesh=)`` draws it,
``shard_params`` cuts it from a full tree) and the layers call the
collectives GSPMD inserts for the reference: the embedding looks up the
ids of the rank's vocab slice (zeros elsewhere) and all-reduces; the
mixers and MLPs run the rank's heads, experts or F slice and all-reduce
their partial sums over "model", so the residual is the same bits on
every model rank; the head gathers the vocab, or (``vocab_local``, the
steps' path) leaves each rank its vocab columns. Batch rows split over
"data" as the caller cuts them. The levers: ``attn_q_seq_shard``
(``models/attention.py``), ``residual_seq_shard`` (the residual held
split over the sequence between the sublayers: each partial sum is
reduce-scattered over the sequence and the rows gathered before the next
sublayer) and ``decode_flash_shard`` (the decode caches' sequence over
its axes, ``flash_decode``); a lever without a mesh that has its axis
raises ``ValueError``.

Under autograd (training, ``launch/steps.py::make_train_step(mesh=)``)
the same forward carries the collectives' backward passes
(``parallel/collectives.py``, the Megatron convention): the sums finish
partial outputs (identity backward) and ``enter_model_region`` marks
each entry into a rank's slice (the normed input of the sharded
mixers, MLPs and head; the replicated leaves a rank uses only in part,
in ``attention.py``, ``mamba2.py`` and ``moe.py``), whose backward sums
the ranks' partial gradients. A layout that also cuts leaves over the
data axes (``shardings=``, ZeRO-3) gathers each where it is used: the
embedding and head once a forward, a layer's leaves inside the layer
(``_Ctx.weights``), so that ``remat`` gathers them again in its
recompute instead of keeping them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.device import resolve_device
from repro_torch.models.attention import attention_decode, attention_forward, init_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import init_kv_cache
from repro_torch.models.layers import (
    Unseeded, apply_mlp, apply_norm, dense_init, init_mlp, init_norm, to_tensor)
from repro_torch.models.mamba2 import (
    init_mamba,
    init_mamba_decode_state,
    mamba_decode,
    mamba_forward,
)
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (
    ParamSharding, batch_sharding, check_levers, decode_cache_sharding, model_rank,
    param_shardings, split_rows, tree_map_with_path)

Tensor = torch.Tensor
Params = Dict[str, Any]

def _check_config(cfg: ModelConfig) -> None:
    for mix in cfg.mixer_pattern:
        if mix not in ("A", "L", "X", "M"):
            raise ValueError(f"unknown mixer kind {mix!r}")
    for mlp in cfg.mlp_pattern:
        if mlp not in ("N", "D", "E"):
            raise ValueError(f"unknown mlp kind {mlp!r}")


def _map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):  # MambaState, LayerKVCache (its sharding kept)
        return type(tree)(**{f.name: fn(v) if isinstance(v, Tensor) else v
                             for f in dataclasses.fields(tree)
                             for v in (getattr(tree, f.name),)})
    return fn(tree)


def _stack(trees):
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if dataclasses.is_dataclass(first):
        return type(first)(**{
            f.name: torch.stack([getattr(t, f.name) for t in trees])
            if isinstance(getattr(first, f.name), Tensor) else getattr(first, f.name)
            for f in dataclasses.fields(first)})
    return torch.stack(trees)


def param_count(params: Params) -> int:
    sizes = []
    _map(lambda a: sizes.append(a.numel()), params)
    return sum(sizes)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_block_position(cfg: ModelConfig, pos: int, generator: torch.Generator,
                         alloc=None) -> Params:
    """One layer of pattern position ``pos``: the mixer, then the MLP,
    drawn from ``generator`` into leaves from ``alloc`` (``new_leaf``)."""
    dtype = getattr(torch, cfg.dtype)
    dev = generator.device
    mix, mlp = cfg.mixer_pattern[pos], cfg.mlp_pattern[pos]
    norm = lambda: init_norm(cfg.d_model, cfg.norm_type, dtype, dev, alloc)
    p: Params = {"norm1": norm()}
    if mix == "M":
        p["mixer"] = init_mamba(cfg, generator, alloc)
    else:
        p["mixer"] = init_attention(cfg, mix, generator, alloc)
    if mlp != "N":
        p["norm2"] = norm()
        if mlp == "D":
            p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, cfg.glu, generator=generator,
                                dtype=dtype, alloc=alloc)
        else:
            p["mlp"] = init_moe(cfg, generator, alloc)
    return p


class _StackedLeaves:
    """The ``alloc`` of one pattern position's layers: layer 0's k-th
    call allocates the k-th leaf stacked over the repeats, (R, *shape),
    and returns its view 0; layer r's k-th call returns view r of it.
    ``stacked_of`` maps layer 0's views (by ``id``) to their leaves."""

    def __init__(self, repeats: int, device):
        self.repeats, self.device = repeats, device
        self.stacked: list = []
        self.stacked_of: dict = {}
        self.layer = self.k = 0

    def start(self, layer: int) -> None:
        self.layer, self.k = layer, 0

    def __call__(self, shape, dtype) -> Tensor:
        if self.layer == 0:
            self.stacked.append(torch.empty((self.repeats, *shape), dtype=dtype,
                                            device=self.device))
        leaf = self.stacked[self.k]
        self.k += 1
        view = leaf[self.layer]
        if self.layer == 0:
            self.stacked_of[id(view)] = leaf
        return view


def _init_stacked(cfg: ModelConfig, pos: int, generator: torch.Generator) -> Params:
    """Pattern position ``pos`` over its ``num_repeats`` layers, each leaf
    allocated once on the generator's device and each layer drawn into
    its view in turn: the generator is consumed layer by layer in the
    order of one ``_init_block_position`` call a layer, so the values
    are those of stacking separately drawn layers, and the peak is the
    weights (plus one fp32 leaf where the dtype is not fp32)."""
    leaves = _StackedLeaves(cfg.num_repeats, generator.device)
    first = _init_block_position(cfg, pos, generator, leaves)
    for r in range(1, cfg.num_repeats):
        leaves.start(r)
        _init_block_position(cfg, pos, generator, leaves)
    return _map(lambda view: leaves.stacked_of[id(view)], first)


class _ShardedLeaves:
    """The ``alloc`` of one pattern position's layers under a mesh: each
    call returns a whole scratch leaf that the initialiser draws into;
    at the next call (and at ``flush``) the rank's block of the finished
    leaf is copied into view r of its stacked local leaf (R,
    *local_shape), and the scratch is emptied, so a rank holds its shard
    and one whole leaf. ``shardings`` are the leaves' ``ParamSharding``
    in call order (stacked: the repeat axis first)."""

    def __init__(self, repeats: int, device, shardings: list):
        self.repeats, self.device, self.shardings = repeats, device, shardings
        self.stacked: list = []
        self.pending = None
        self.layer = self.k = 0

    def start(self, layer: int) -> None:
        self.flush()
        self.layer, self.k = layer, 0

    def flush(self) -> None:
        if self.pending is None:
            return
        k, scratch = self.pending
        sh = self.shardings[k]
        block = scratch[sh.index((self.repeats, *scratch.shape))[1:]]
        if self.layer == 0:
            local = sh.local_shape((self.repeats, *scratch.shape))
            self.stacked.append(torch.empty(local, dtype=scratch.dtype, device=self.device))
        self.stacked[k][self.layer].copy_(block)
        scratch.set_()  # the initialiser's reference keeps an empty tensor
        self.pending = None

    def __call__(self, shape, dtype) -> Tensor:
        self.flush()
        scratch = torch.empty(tuple(shape), dtype=dtype, device=self.device)
        self.pending = (self.k, scratch)
        self.k += 1
        return scratch


def _leaf_paths(cfg: ModelConfig, pos: int) -> Tuple[list, Params]:
    """The tree path of each leaf of a pattern position's layer, in the
    order its initialiser allocates them, and the layer's tree on the
    meta device (one run there)."""
    made = []

    def alloc(shape, dtype):
        made.append(torch.empty(shape, dtype=dtype, device="meta"))
        return made[-1]

    tree = _init_block_position(cfg, pos, Unseeded(), alloc)
    where = {}
    tree_map_with_path(lambda path, t: where.__setitem__(id(t), path), tree)
    return [where[id(t)] for t in made], tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _init_stacked_sharded(cfg: ModelConfig, pos: int, generator: torch.Generator,
                          shardings: dict) -> Params:
    """``_init_stacked`` under a mesh: the same draws, layer by layer, into
    whole scratch leaves, of which the rank keeps its blocks
    (``_ShardedLeaves``); ``shardings`` is the position's stacked
    ``ParamSharding`` tree."""
    paths, tree = _leaf_paths(cfg, pos)
    leaves = _ShardedLeaves(cfg.num_repeats, generator.device,
                            [_at(shardings, p) for p in paths])
    for r in range(cfg.num_repeats):
        leaves.start(r)
        _init_block_position(cfg, pos, generator, leaves)
    leaves.flush()
    # the meta tree's structure, so that a leafless norm ({}) keeps its key
    stacked = dict(zip(paths, leaves.stacked))
    return tree_map_with_path(lambda path, _: stacked[path], tree)


def init_model(cfg: ModelConfig, seed: int = 0, *, device="cuda", mesh=None) -> Params:
    """Fresh parameters, drawn from a ``torch.Generator`` seeded ``seed``
    on ``device`` (the card unless the caller asks for the CPU): the
    embedding ((V, E), or (K, V, E) with K codebooks), each pattern
    position's layers in turn (``_init_stacked``), the head ((E, V) or
    (K, E, V); none when the embedding is tied as the head). On
    ``device="meta"`` the leaves are allocated and nothing is drawn (the
    dry run's abstract parameters).

    With ``mesh`` the rank's shard (``model_shardings``): every leaf is
    drawn whole, as without a mesh, and the rank keeps its block, so a
    shard is bitwise the slice of the unsharded init and a rank's peak is
    its shard plus one whole leaf."""
    _check_config(cfg)
    dev = resolve_device(device)
    g = Unseeded() if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    K = cfg.num_codebooks
    lead = (K,) if K > 1 else ()
    shards = None if mesh is None else model_shardings(cfg, mesh)

    def kept(name, leaf):  # the rank's block of a whole leaf
        return leaf if shards is None else shards[name].local(leaf).clone()

    params: Params = {
        "embed": kept("embed", dense_init((*lead, cfg.vocab_size, cfg.d_model), generator=g,
                                          dtype=dtype, fan_in=cfg.d_model)),
        "blocks": {f"p{i}": _init_stacked(cfg, i, g) if shards is None
                   else _init_stacked_sharded(cfg, i, g, shards["blocks"][f"p{i}"])
                   for i in range(len(cfg.mixer_pattern))},
        "final_norm": init_norm(cfg.d_model, cfg.norm_type, dtype, dev),
    }
    if not cfg.tie_embeddings:
        # fan-in shape[0], as the reference: K for the codebook heads
        params["lm_head"] = kept("lm_head", dense_init((*lead, cfg.d_model, cfg.vocab_size),
                                                       generator=g, dtype=dtype))
    return params


_SHARDINGS: dict = {}


def model_shardings(cfg: ModelConfig, mesh) -> Params:
    """The ``ParamSharding`` tree of ``cfg``'s parameters on ``mesh``
    (``param_shardings`` over the meta tree, with the unpadded expert
    count, as the reference's ``train.py``), cached a (config, mesh)."""
    key = (cfg, id(mesh))
    if key not in _SHARDINGS or _SHARDINGS[key][0] is not mesh:
        shapes = init_model(cfg, device="meta")
        tree = param_shardings(shapes, mesh, cfg.moe.num_experts if cfg.moe else None)
        _SHARDINGS[key] = (mesh, tree)
    return _SHARDINGS[key][1]


def _layer_shardings(tree):
    """A pattern position's stacked shardings → one layer's model-axis
    layout (the repeat axis and the data axes dropped)."""
    return tree_map_with_path(
        lambda _, s: ParamSharding(s.mesh, tuple(s.model_part().spec[1:])), tree)


def _has_data_axes(tree) -> bool:
    found = []
    tree_map_with_path(lambda _, s: found.append(s.data_dim() is not None), tree)
    return any(found)


def shard_params(params: Params, mesh, cfg: ModelConfig, shardings=None) -> Params:
    """This rank's shard of a full parameter tree (``init_model`` or
    ``params_from_jax``): each leaf's block by ``shardings`` (default
    ``model_shardings``), a copy."""
    shards = shardings if shardings is not None else model_shardings(cfg, mesh)
    return tree_map_with_path(lambda path, t: _at(shards, path).local(t).clone(), params)


def data_blocks(params: Params, shardings) -> Params:
    """The ZeRO-3 shard from a tensor-parallel one: each leaf's block over
    the data axes of ``shardings`` (``ParamSharding.data_part``), a copy
    (a leaf no data axis cuts is the same tensor)."""
    def one(path, t):
        part = _at(shardings, path).data_part()
        return part.local(t).clone() if part.axes() else t
    return tree_map_with_path(one, params)


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig, device="cpu") -> Params:
    """The reference's ``init_model`` tree (nested dicts of numpy arrays
    or tensors, the blocks stacked on their repeat axis) → the port's
    parameters on ``device`` holding the same values. Keys and shapes
    must be those of the port's ``init_model(cfg)`` (so a tied tree given
    to an untied config, or the reverse, raises); each leaf keeps the
    config's dtype."""
    params = init_model(cfg, device=device)
    with torch.no_grad():
        _copy_tree(params, tree, "")
    return params


def _copy_tree(dst, src, path: str) -> None:
    if isinstance(dst, Mapping):
        if not isinstance(src, Mapping) or set(src) != set(dst):
            got = sorted(src) if isinstance(src, Mapping) else type(src).__name__
            raise ValueError(f"{path or '/'}: keys {got} != {sorted(dst)}")
        for k in dst:
            _copy_tree(dst[k], src[k], f"{path}/{k}")
        return
    value = to_tensor(src)
    if tuple(value.shape) != tuple(dst.shape):
        raise ValueError(f"{path}: shape {tuple(value.shape)} != {tuple(dst.shape)}")
    dst.copy_(value.to(dst.dtype))


# --------------------------------------------------------------------------
# embedding / head
# --------------------------------------------------------------------------

def _vocab_split(shard: Optional[ParamSharding], dim: int, mesh) -> bool:
    return shard is not None and model_rank(mesh)[0] > 1 and shard.sharded_dim() == dim


def embed_tokens(params: Params, tokens: Tensor, cfg: ModelConfig, *,
                 shard: Optional[ParamSharding] = None, mesh=None) -> Tensor:
    """tokens (B, S) → (B, S, E); with K codebooks tokens (B, S, K) → the
    sum of the K codebooks' embeddings, added in order k = 0..K−1
    (reference :105). A vocab-sharded embedding (``shard``, ``mesh``)
    looks up the ids of the rank's slice (zeros for the others) and
    all-reduces over "model" (exact: one rank holds each row), the K
    codebooks' lookups in one all-reduce, then summed in order."""
    tokens = tokens.long()
    K = cfg.num_codebooks
    if _vocab_split(shard, 1 if K > 1 else 0, mesh):
        n, r = model_rank(mesh)
        Vl = cfg.vocab_size // n

        def lookup(table, ids):
            local = ids - r * Vl
            inside = (local >= 0) & (local < Vl)
            return table[local.clamp(0, Vl - 1)].masked_fill(~inside[..., None], 0)

        if K > 1:
            parts = coll.all_reduce_sum(torch.stack(
                [lookup(params["embed"][k], tokens[..., k]) for k in range(K)]), mesh)
            x = parts[0]
            for k in range(1, K):
                x = x + parts[k]
            return x
        return coll.all_reduce_sum(lookup(params["embed"], tokens), mesh)
    if cfg.num_codebooks > 1:
        x = params["embed"][0][tokens[..., 0]]
        for k in range(1, cfg.num_codebooks):
            x = x + params["embed"][k][tokens[..., k]]
        return x
    return params["embed"][tokens]


def lm_logits(params: Params, x: Tensor, cfg: ModelConfig, *,
              shard: Optional[ParamSharding] = None, mesh=None, vocab_local: bool = False):
    """x (B, S, E) → logits (B, S, V), or (B, S, K, V) with K codebooks;
    through the embedding when it is tied as the head (reference :116).
    A vocab-sharded head (``shard``: the head's, or the tied embedding's
    sharding) computes the rank's vocab columns and gathers the vocab
    over "model". ``vocab_local`` returns (logits, first) instead: the
    rank's columns, ids [first, first + V/n), ungathered, as the
    reference's GSPMD leaves them; first is None where the rank computes
    every column (no mesh, one rank of "model", or a head whose vocab
    does not divide "model" and stays replicated)."""
    K = cfg.num_codebooks
    vocab_dim = (1 if K > 1 else 0) if cfg.tie_embeddings else (2 if K > 1 else 1)
    if _vocab_split(shard, vocab_dim, mesh):
        # enter: the head's input meets the rank's vocab columns; after the
        # gather every rank computes the same loss ("own"); a vocab-local
        # loss's backward gives each rank its columns' gradient alone
        x = coll.enter_model_region(x, mesh)
        local = lm_logits(params, x, cfg)
        if vocab_local:
            return local, model_rank(mesh)[1] * local.shape[-1]
        return coll.all_gather_dim(local, -1, mesh, backward="own")
    if cfg.tie_embeddings:
        if cfg.num_codebooks > 1:
            out = torch.einsum("bse,kve->bskv", x, params["embed"])
        else:
            out = torch.einsum("bse,ve->bsv", x, params["embed"])
    elif cfg.num_codebooks > 1:
        out = torch.einsum("bse,kev->bskv", x, params["lm_head"])
    else:
        out = x @ params["lm_head"]
    return (out, None) if vocab_local else out


# --------------------------------------------------------------------------
# forward (train / prefill)
# --------------------------------------------------------------------------

def _layer(tree, r: int):
    """Layer r's weights: views into the stacked tensors."""
    return _map(lambda a: a[r], tree)


def _layers(tree, repeats: int) -> list:
    """Every layer's weights, views through one ``unbind`` a stacked leaf:
    under autograd a leaf's gradient is then one stack of its layers'
    gradients, where a view a layer (``_layer``) would add a zero-padded
    full-size gradient for each layer."""
    unbound = _map(lambda a: a.unbind(0), tree)
    return [_map(lambda u: u[r], unbound) for r in range(repeats)]


class _Ctx:
    """One layer's place under a mesh: its ``ParamSharding`` tree
    (``shard``), the mesh, and how a sublayer's output is finished
    (``finish(y, partial)``: a partial sum is all-reduced over "model", a
    whole one kept; under ``residual_seq_shard`` both become the rank's
    sequence rows, and ``gather`` rebuilds every row of the residual);
    ``rows_of``, the ``RowSharding`` of the batch rows the rank holds;
    ``fsdp``, the position's stacked ``ParamSharding`` tree where a leaf
    is cut over the data axes (ZeRO-3; ``weights`` gathers a layer's),
    else None."""

    def __init__(self, shard, mesh, seq_len: Optional[int] = None, rows=None, fsdp=None,
                 repeats: int = 1):
        self.shard, self.mesh, self.rows_of, self.fsdp = shard, mesh, rows, fsdp
        self.repeats = repeats
        self.seq_len = seq_len
        if seq_len is not None:
            n, r = model_rank(mesh)
            self.n, self.rows = n, split_rows(seq_len, n, r)
            self.block = -(-seq_len // n)

    def finish(self, y: Tensor, partial: bool) -> Tensor:
        if self.seq_len is None:
            return coll.all_reduce_sum(y, self.mesh) if partial else y
        a, b = self.rows
        if not partial:
            return self.split(y)
        pad = self.n * self.block - y.shape[1]
        if pad:
            y = torch.cat([y, y.new_zeros((y.shape[0], pad, *y.shape[2:]))], dim=1)
        return coll.reduce_scatter_dim(y, 1, self.mesh)[:, :b - a]

    def split(self, x: Tensor) -> Tensor:
        """The rank's sequence rows of a replicated x (all-gather backward)."""
        return coll.split_dim(x, 1, self.mesh)

    def gather(self, x: Tensor) -> Tensor:
        if self.seq_len is None:
            return x
        if x.shape[1] < self.block:
            x = torch.cat([x, x.new_zeros((x.shape[0], self.block - x.shape[1],
                                           *x.shape[2:]))], dim=1)
        # every rank computes the same from the gathered residual ("own")
        return coll.all_gather_dim(x, 1, self.mesh, backward="own")[:, :self.seq_len]

    def weights(self, bp: Params, r: int) -> Params:
        """Layer r's weights for its computation: under ZeRO-3 each leaf cut
        over the data axes gathered whole over them (``fsdp_gather``; a
        leaf cut on the repeat axis broadcast by the rank that holds layer
        r, ``fsdp_broadcast``), where the layer runs. Without ``remat``
        autograd keeps each layer's gathered weights for its backward
        pass; under ``remat`` it keeps none, and the recompute gathers
        them again, so a rank holds one layer's at a time."""
        if self.fsdp is None:
            return bp

        def one(path, t):
            sh = _at(self.fsdp, path)
            d = sh.data_dim()
            if d is None:
                return t
            axes = sh.data_axes()
            if d == 0:
                owner, _ = _repeat_owner(sh, r, self.repeats)
                return coll.fsdp_broadcast(t, self.mesh, axes, owner,
                                           owner == self.mesh.index(axes))
            return coll.fsdp_gather(t, d - 1, self.mesh, axes)

        return tree_map_with_path(one, bp)


def _repeat_owner(sh: ParamSharding, r: int, repeats: int) -> Tuple[int, int]:
    """Where layer r of a stacked leaf cut over data axes on its repeat
    axis lives: (the data index holding it, its index in that block)."""
    per = repeats // coll.axes_size(sh.mesh, sh.data_axes())
    return r // per, r % per


def _layer_inputs(tree: Params, fsdp, repeats: int, mesh) -> list:
    """Every layer's local weights, as ``_layers`` gives them; a leaf cut
    over the data axes on its repeat axis (ZeRO-3) holds only its block
    of layers, so layer r is its view where this rank holds it, and
    another view of the leaf elsewhere (``fsdp_broadcast`` reads no value
    of it there, and gives it no gradient)."""
    if fsdp is None:
        return _layers(tree, repeats)
    unbound = _map(lambda a: a.unbind(0), tree)

    def pick(r):
        def one(path, u):
            sh = _at(fsdp, path)
            if sh.data_dim() != 0:
                return u[r]
            owner, j = _repeat_owner(sh, r, repeats)
            return u[j] if owner == mesh.index(sh.data_axes()) else u[0]
        return tree_map_with_path(one, unbound)

    return [pick(r) for r in range(repeats)]


def _sharded(ctx: Optional[_Ctx]) -> bool:
    """Whether a layer runs the rank's slices (a mesh with more than one
    rank of "model")."""
    return ctx is not None and model_rank(ctx.mesh)[0] > 1


def _mlp_residual(bp: Params, x: Tensor, cfg: ModelConfig, pos: int,
                  moe_routing: Optional[list], ctx: Optional[_Ctx] = None
                  ) -> Tuple[Tensor, Optional[Tensor]]:
    """x plus the layer's MLP of its normed x, and an "E" layer's aux
    loss (None for the others). Under ``residual_seq_shard`` x holds the
    rank's rows and the normed input is gathered first."""
    kind = cfg.mlp_pattern[pos]
    if kind == "N":
        return x, None
    h = apply_norm(ctx.gather(x) if ctx is not None else x, cfg.norm_type, bp["norm2"])
    mlp = bp["mlp"]
    if kind == "E":
        # routing groups span the whole batch, as in the reference under
        # GSPMD: row-sharded ranks route every row and keep theirs (so
        # their gradients differ after the gather: "reduce_scatter")
        split = ctx is not None and ctx.rows_of is not None and ctx.rows_of.n_shards > 1
        if split:
            h = coll.all_gather_dim(h, 0, ctx.mesh, ctx.rows_of.axes, backward="reduce_scatter")
            if h.shape[0] != ctx.rows_of.batch:
                raise ValueError(f"an 'E' layer routes groups of the whole batch: the data "
                                 f"ranks' rows gather to {h.shape[0]}, not the "
                                 f"{ctx.rows_of.batch} rows the unsharded groups hold")
        kw = {}
        if _sharded(ctx):
            kw = dict(shard=ctx.shard["mlp"], mesh=ctx.mesh,
                      finish=None if split else ctx.finish)
        y, aux = apply_moe(mlp, h, cfg, dispatch=cfg.moe_dispatch, routing=moe_routing, **kw)
        if split:
            y = y[ctx.rows_of.rows]
            if ctx.seq_len is not None:
                y = ctx.finish(y, False)
        return x + y, aux
    split = _sharded(ctx) and ctx.shard["mlp"]["w_out"].sharded_dim() is not None
    if split:  # enter: the normed h meets the rank's F slice of w_in/w_gate
        h = coll.enter_model_region(h, ctx.mesh)
    y = apply_mlp(h, mlp["w_in"], mlp["w_out"], mlp.get("w_gate"), act=cfg.act)
    if _sharded(ctx):
        y = ctx.finish(y, split)
    return x + y, None


def _block_forward(bp: Params, x: Tensor, cfg: ModelConfig, pos: int, positions: Tensor,
                   cross_embeds: Optional[Tensor], use_kernel_ssd: bool, use_flash: bool,
                   moe_routing: Optional[list], ctx: Optional[_Ctx] = None, r: int = 0):
    mix = cfg.mixer_pattern[pos]
    if ctx is not None:
        bp = ctx.weights(bp, r)
    h = apply_norm(ctx.gather(x) if ctx is not None else x, cfg.norm_type, bp["norm1"])
    kw = {} if ctx is None else dict(mesh=ctx.mesh)
    if _sharded(ctx):
        kw.update(shard=ctx.shard["mixer"], finish=ctx.finish)
    if mix == "M":
        x = x + mamba_forward(bp["mixer"], h, cfg, use_kernel=use_kernel_ssd, **kw)
    else:
        x = x + attention_forward(bp["mixer"], h, cfg, mix, positions,
                                  cross_kv=cross_embeds if mix == "X" else None,
                                  use_flash=use_flash, **kw)
    return _mlp_residual(bp, x, cfg, pos, moe_routing, ctx)


def _save_unbatched_products(ctx, op, *args, **kwargs):
    """``remat="dots"``'s policy, the reference's
    ``checkpoint_dots_with_no_batch_dims``: keep the outputs of products
    without batch dimensions (``mm``, ``addmm``, and ``bmm`` over a batch
    of 1, which is how ``torch.einsum`` runs the projections), recompute
    the rest (the attention's per-head products, the experts', norms,
    activations)."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str):
    """``fn`` run under ``torch.utils.checkpoint`` as ``remat`` asks:
    "none" as it is, "full" keeping only its inputs, "dots" keeping the
    unbatched products' outputs too."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        ctx = functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                _save_unbatched_products)
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False, context_fn=ctx)
    raise ValueError(f"remat must be 'none', 'full' or 'dots', got {remat!r}")


def forward(params: Params, tokens: Tensor, cfg: ModelConfig, *,
            cross_embeds: Optional[Tensor] = None,
            use_kernel_ssd: bool = True, use_flash: bool = True,
            remat: str = "none", last_logits_only: bool = False,
            moe_routing: Optional[list] = None, mesh=None,
            rows=None, residual: Optional[list] = None,
            shardings=None, vocab_local: bool = False) -> Tuple[Any, Tensor]:
    """tokens (B, S) or, with K codebooks, (B, S, K) → (logits (B, S or 1,
    V) or (B, S or 1, K, V), the "E" layers' aux loss summed over the
    layers in order, fp32; 0 without "E" layers). ``cross_embeds`` (B,
    num_patches, vision_dim) are the image embeddings every "X" layer
    attends to (the reference's stubbed vision tower).

    ``use_kernel_ssd`` (the default) routes every Mamba2 layer's scan
    through ``kernels.ssd.ops`` (K7 on the card), ``False`` through the
    plain ``ssd_chunked``; ``use_flash`` (the default) every attention
    layer's causal attention through ``kernels.flash_attention.ops`` (K3
    on the card; windowed on "L" layers), ``False`` through the plain
    ``_ref_attention``. Positions are ``arange(S)``. ``last_logits_only``
    applies the head to the last position only, as a serving prefill
    needs. ``remat`` ("none", "full", "dots") checkpoints each layer for
    training (``_remat``). ``moe_routing`` (tests and the smoke only)
    collects every "E" layer's routing decisions in layer order
    (``moe.apply_moe``); ``residual`` (the same) the residual the final
    norm reads (the last position's with ``last_logits_only``).

    ``mesh``: ``params`` is this rank's shard on it, laid out by
    ``shardings`` (a ``ParamSharding`` tree; default ``model_shardings``,
    the tensor-parallel layout; a leaf it cuts over the data axes too,
    ZeRO-3, is gathered where it is used), ``tokens`` (and
    ``cross_embeds``) the rank's rows, cut by ``rows`` (a
    ``RowSharding``; None: every rank holds every row); the logits are
    the rank's rows over the whole vocab (module docstring). An "E"
    layer routes every row of the batch, as the reference does under
    GSPMD (its routing groups span the batch). Under autograd the
    collectives carry their backward passes (``parallel/collectives.py``),
    and ``remat`` recomputes a layer's collectives with it, in the same
    order on every rank. ``vocab_local``: the logits are ``lm_logits``'s
    (logits, first), the rank's vocab columns ungathered (the train,
    prefill and serve steps take them into the vocab-parallel loss and
    pick)."""
    _check_config(cfg)
    check_levers(cfg, mesh)
    if "X" in cfg.mixer_pattern and cross_embeds is None:
        raise ValueError(f"{cfg.name} has cross-attention layers: pass cross_embeds "
                         f"(B, {cfg.num_patches}, {cfg.vision_dim})")
    shards = None if mesh is None else (
        shardings if shardings is not None else model_shardings(cfg, mesh))
    if shards is not None:
        params = _gather_top(params, shards, mesh)
    x = embed_tokens(params, tokens, cfg, **_head_kw(shards, "embed", mesh))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    stacked = [None if shards is None else shards["blocks"][f"p{i}"]
               for i in range(len(cfg.mixer_pattern))]
    fsdp = [st if st is not None and _has_data_axes(st) else None for st in stacked]
    blocks = [_layer_inputs(params["blocks"][f"p{i}"], fsdp[i], cfg.num_repeats, mesh)
              for i in range(len(cfg.mixer_pattern))]
    seq = cfg.residual_seq_shard is not None and mesh is not None and model_rank(mesh)[0] > 1
    ctxs = [None] * len(cfg.mixer_pattern) if shards is None else [
        _Ctx(_layer_shardings(stacked[i]), mesh, x.shape[1] if seq else None, rows, fsdp[i],
             cfg.num_repeats) for i in range(len(cfg.mixer_pattern))]
    if seq:  # the residual holds the rank's sequence rows between sublayers
        x = ctxs[0].split(x)
    for r in range(cfg.num_repeats):
        for i in range(len(cfg.mixer_pattern)):
            layer = functools.partial(_block_forward, blocks[i][r],
                                      cfg=cfg, pos=i, positions=positions,
                                      cross_embeds=cross_embeds,
                                      use_kernel_ssd=use_kernel_ssd, use_flash=use_flash,
                                      moe_routing=moe_routing, ctx=ctxs[i], r=r)
            x, a = _remat(layer, remat)(x)
            if a is not None:
                aux = aux + a
    if seq:
        x = ctxs[0].gather(x)
    if last_logits_only:
        x = x[:, -1:]
    if residual is not None:
        residual.append(x)
    x = apply_norm(x, cfg.norm_type, params["final_norm"])
    return lm_logits(params, x, cfg, vocab_local=vocab_local,
                     **_head_kw(shards, _head_name(cfg), mesh)), aux


def _head_name(cfg: ModelConfig) -> str:
    return "embed" if cfg.tie_embeddings else "lm_head"


def _head_kw(shards, name: str, mesh) -> dict:
    return {} if shards is None else dict(shard=shards[name].model_part(), mesh=mesh)


def _gather_top(params: Params, shards, mesh) -> Params:
    """``params`` with the embedding and the head gathered over the data
    axes where ZeRO-3 cuts them (once a forward: a tied embedding serves
    as the head from the same gather); the blocks gather in their layers."""
    out = dict(params)
    for name in ("embed", "lm_head"):
        sh = shards.get(name)
        d = None if sh is None else sh.data_dim()
        if d is not None:
            out[name] = coll.fsdp_gather(params[name], d, mesh, sh.data_axes())
    return out


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      device="cuda", *, mesh=None) -> Dict[str, Any]:
    """Per-pattern-position decode state, stacked over repeats, on
    ``device`` (the card unless the caller asks for the CPU): an "A"
    layer's KV cache holds ``cache_len`` tokens, an "L" layer's
    ``min(cache_len, sliding_window)`` (a ring buffer of its window); a
    Mamba2 state does not grow with the sequence; an "X" layer has none
    (``{}``: it recomputes the image K/V each step).

    With ``mesh`` the rank's block of the global state of ``batch`` rows
    (``launch.specs.decode_state_shardings``): each KV cache laid out by
    ``kv_cache_spec`` (or over ``decode_flash_shard``'s axes,
    ``parallel.sharding.decode_cache_sharding``) and carrying that
    sharding; a Mamba2 state the rank's rows, heads and conv channels."""
    _check_config(cfg)
    check_levers(cfg, mesh)
    device = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    state = {}
    for i, mix in enumerate(cfg.mixer_pattern):
        if mix == "X":
            state[f"p{i}"] = {}
            continue
        if mix == "M":
            rows, heads = batch, None
            if mesh is not None:
                rows = batch // batch_sharding(mesh, batch, 1).n_shards
                H = cfg.mamba.num_heads(cfg.d_model)
                n = model_rank(mesh)[0]
                shard = _layer_shardings(model_shardings(cfg, mesh)["blocks"][f"p{i}"])
                heads = H // n if shard["mixer"]["A_log"].sharded_dim() is not None else H
            one = init_mamba_decode_state(cfg, rows, device, heads=heads)
        else:
            eff = cache_len if mix == "A" else min(cache_len, cfg.sliding_window)
            full = (batch, eff, cfg.num_kv_heads, cfg.head_dim)
            if mesh is None:
                one = init_kv_cache(batch, eff, cfg.num_kv_heads, cfg.head_dim, dtype, device)
            else:
                sh = decode_cache_sharding(cfg, mesh, batch, eff)
                b, sl, kv, dh = sh.local_shape(full)
                one = init_kv_cache(b, sl, kv, dh, dtype, device)
                one.sharding = sh
        state[f"p{i}"] = _map(lambda a: a.expand((cfg.num_repeats,) + a.shape).clone(), one)
    return state


def decode_step(params: Params, tokens: Tensor, state: Dict[str, Any], cfg: ModelConfig, *,
                cross_embeds: Optional[Tensor] = None, start_pos: Optional[Tensor] = None,
                moe_routing: Optional[list] = None, mesh=None, rows=None, shardings=None,
                vocab_local: bool = False) -> Tuple[Any, Dict[str, Any]]:
    """One decode step. tokens (B, 1) or (B, 1, K) → (logits (B, 1, V) or
    (B, 1, K, V), state'). ``cross_embeds`` as in ``forward``.

    The state is written in place and state' is ``state``, holding the
    same tensors: the attention layers' caches at their ring slot, each
    Mamba2 layer's conv and SSM state into its view of the stacked state
    (bitwise the values a new state would hold), so a captured CUDA
    graph of the step can replay it (``launch.steps.make_serve_step``).
    ``start_pos`` (B,), on the state's device, hides
    from each batch lane the cache positions before its own request
    (continuous batching). An "E" layer routes the step's B tokens as one
    group, so every lane (a free batcher slot too) takes capacity, and
    its aux loss is discarded, as in the reference; ``moe_routing`` as in
    ``forward``. ``mesh``, ``rows`` and ``shardings``: the rank's shard,
    rows and state (``init_decode_state(mesh=)``), and ``vocab_local``,
    as in ``forward``."""
    _check_config(cfg)
    check_levers(cfg, mesh)
    shards = None if mesh is None else (
        shardings if shardings is not None else model_shardings(cfg, mesh))
    if shards is not None:
        params = _gather_top(params, shards, mesh)
    x = embed_tokens(params, tokens, cfg, **_head_kw(shards, "embed", mesh))
    stacked = [None if shards is None else shards["blocks"][f"p{i}"]
               for i in range(len(cfg.mixer_pattern))]
    fsdp = [st if st is not None and _has_data_axes(st) else None for st in stacked]
    ctxs = [None if shards is None else
            _Ctx(_layer_shardings(stacked[i]), mesh, rows=rows, fsdp=fsdp[i],
                 repeats=cfg.num_repeats)
            for i in range(len(cfg.mixer_pattern))]
    zero3 = [None if f is None else _layer_inputs(params["blocks"][f"p{i}"], f,
                                                  cfg.num_repeats, mesh)
             for i, f in enumerate(fsdp)]
    for r in range(cfg.num_repeats):
        for i, mix in enumerate(cfg.mixer_pattern):
            ctx = ctxs[i]
            kw = {} if ctx is None else dict(mesh=mesh, shard=ctx.shard["mixer"])
            if zero3[i] is None:
                bp = _layer(params["blocks"][f"p{i}"], r)
            else:  # ZeRO-3: the layer's leaves gathered over the data axes
                bp = ctx.weights(zero3[i][r], r)
            h = apply_norm(x, cfg.norm_type, bp["norm1"])
            st = _layer(state[f"p{i}"], r)
            if mix == "M":
                y, s_new = mamba_decode(bp["mixer"], h, cfg, st, **kw)
                st.conv.copy_(s_new.conv)  # layer r's views of the stacked state
                st.ssm.copy_(s_new.ssm)
            elif mix == "X":  # stateless
                y, _ = attention_decode(bp["mixer"], h, cfg, mix, None, cross_kv=cross_embeds,
                                        **kw)
            else:  # the views write into the stacked cache
                y, _ = attention_decode(bp["mixer"], h, cfg, mix, st, start_pos=start_pos, **kw)
            x, _ = _mlp_residual(bp, x + y, cfg, i, moe_routing, ctx)  # aux discarded
    x = apply_norm(x, cfg.norm_type, params["final_norm"])
    return lm_logits(params, x, cfg, vocab_local=vocab_local,
                     **_head_kw(shards, _head_name(cfg), mesh)), state
