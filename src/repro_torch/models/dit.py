"""DiT score network over image patches with adaLN time conditioning;
port of ``repro/models/dit.py``.

``DiT`` is an ``nn.Module`` whose parameters keep the reference's
layouts (``wq/wk/wv`` (E, H, Dh), ``wo`` (H, Dh, E), ``x @ w`` dense
weights), so ``params_from_jax`` copies a reference parameter tree in
without transposes. The blocks live in a ``ModuleList`` where the
reference stacks them on axis 0 for ``lax.scan``.

Precision (DESIGN.md §8): with a ``policy`` the activations and the
weight copies the matmuls consume run in ``policy.compute``; the
timestep embedding is computed in fp32 from the stored weights and the
norms take fp32 statistics. ``make_score_fn`` divides by std in fp32 and
returns the score in ``policy.state``.

A fresh ``init_dit`` sets ``ada``, ``ada_b``, ``final_ada``,
``final_ada_b`` and ``patch_out`` to zero, as the reference does, so the
fresh network returns exactly 0 for every input. ``liven_zero_init``
gives those leaves random values, so that a network made from a seed
carries signal through attention to its output.

Every leaf is a trainable ``nn.Parameter``, as every leaf of the
reference's tree is trained (``pos_emb`` included). The samplers run
under ``torch.no_grad()``; training runs with ``use_flash=False``, as
the reference trains, since the flash kernel has no backward (its
wrapper raises under grad mode, ``kernels.autograd``).

Under a mesh a rank's ``DiT`` holds its block of each leaf: built with
``shardings`` (a tree of ``parallel.sharding.ParamSharding`` over
``dit_param_shapes``, the reference's stacked tree, from the DiT's
tensor-parallel rules, ``launch/sample.py::_dit_param_shardings``), or
cut from a whole model by ``shard_dit`` (bitwise its slices). Over
"model" a block holds its query, key and value heads and ``wo``'s rows
when n divides the heads (else every head), its F columns of
``w_in``/``w_gate`` and rows of ``w_out``, and its columns of ``ada``;
``forward(mesh=)`` runs attention on its heads (K3 on the card with
``use_flash``), finishes ``wo``'s and ``w_out``'s partial products with
one all-reduce each over "model", and all-gathers the modulation's
columns before the six chunks are cut. ``enter_model_region`` marks
where the replicated normed input meets sharded weights (the backward's
sum). At one rank of "model" no collective runs and the forward is
bitwise the unsharded one. Cut over a pipeline axis, a rank holds its
stage's blocks (``layer_range``) and runs them through
``launch/sample.py::make_pipelined_dit_forward``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.sde import bcast
from repro_torch.models.attention import attention
from repro_torch.models import layers
from repro_torch.models.layers import (
    apply_mlp, apply_norm, dense_init, timestep_embedding, to_tensor,
)
from repro_torch.parallel import collectives as coll

Tensor = torch.Tensor

#: the leaves a fresh DiT holds at zero
ZERO_INIT_LAYER = ("ada", "ada_b")
ZERO_INIT_TOP = ("final_ada", "final_ada_b", "patch_out")


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    image_size: int = 32
    channels: int = 3
    patch: int = 4
    d_model: int = 256
    num_layers: int = 6
    num_heads: int = 8
    d_ff: int = 1024
    #: > 0 adds a label-embedding table with a trailing null row
    #: (DESIGN.md §9); 0 is the unconditional net
    num_classes: int = 0
    #: route block attention through the flash kernel (DESIGN.md §13)
    use_flash: bool = False

    @property
    def tokens(self) -> int:
        return (self.image_size // self.patch) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch * self.patch * self.channels

    @property
    def head_dim(self) -> int:
        """``d_model // num_heads``, the reference ``ModelConfig`` rule."""
        return self.d_model // self.num_heads


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(tuple(shape), dtype=dtype, device=device))


#: each block leaf's path in the reference's stacked ``layers`` tree
LAYER_PATHS = {"wq": ("attn", "wq"), "wk": ("attn", "wk"), "wv": ("attn", "wv"),
               "wo": ("attn", "wo"), "w_in": ("mlp", "w_in"), "w_gate": ("mlp", "w_gate"),
               "w_out": ("mlp", "w_out"), "ada": ("ada",), "ada_b": ("ada_b",)}


def _layer_shapes(cfg: DiTConfig) -> dict:
    """One block's leaf shapes, by attribute name."""
    E, H, Dh, Fd = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff
    return {"wq": (E, H, Dh), "wk": (E, H, Dh), "wv": (E, H, Dh), "wo": (H, Dh, E),
            "w_in": (E, Fd), "w_gate": (E, Fd), "w_out": (Fd, E),
            "ada": (E, 6 * E), "ada_b": (6 * E,)}


def dit_param_shapes(cfg: DiTConfig) -> dict:
    """The reference's ``init_dit`` tree as shapes: the blocks' leaves
    stacked on axis 0 under ``layers`` (the parameter-free norms, empty
    dicts there, left out)."""
    R = cfg.num_layers
    layers: dict = {}
    for name, shape in _layer_shapes(cfg).items():
        *outer, leaf = LAYER_PATHS[name]
        node = layers
        for k in outer:
            node = node.setdefault(k, {})
        node[leaf] = (R,) + shape
    E = cfg.d_model
    top = {"label_emb": (cfg.num_classes + 1, E)} if cfg.num_classes > 0 else {}
    top.update(patch_in=(cfg.patch_dim, E), pos_emb=(cfg.tokens, E), t_mlp1=(256, E),
               t_mlp2=(E, E), layers=layers, final_ada=(E, 2 * E), final_ada_b=(2 * E,),
               patch_out=(E, cfg.patch_dim))
    return top


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class DiTBlock(nn.Module):
    """adaLN-modulated attention + gated-MLP block. ``shapes`` are this
    rank's leaf shapes under a mesh (default: whole leaves)."""

    def __init__(self, cfg: DiTConfig, dtype, device, shapes: Optional[dict] = None):
        super().__init__()
        for name, shape in (shapes or _layer_shapes(cfg)).items():
            setattr(self, name, _param(shape, dtype, device))
        # a leaf cut over "model" holds the rank's heads, F columns or
        # modulation columns
        self.heads_split = self.wq.shape[1] < cfg.num_heads
        self.ffn_split = self.w_in.shape[1] < cfg.d_ff
        self.ada_split = self.ada.shape[1] < 6 * cfg.d_model

    def forward(self, h: Tensor, silu_temb: Tensor, cw, use_flash: bool,
                mesh=None) -> Tensor:
        B, S, E = h.shape
        H, Dh = self.wq.shape[1], self.wq.shape[2]
        enter = lambda a, split: coll.enter_model_region(a, mesh) if split else a
        mod = enter(silu_temb, self.ada_split) @ cw(self.ada)
        if self.ada_split:
            mod = coll.all_gather_dim(mod, 1, mesh, backward="own")
        mod = mod + cw(self.ada_b)
        s1, b1, g1, s2, b2, g2 = mod[:, None, :].chunk(6, dim=-1)
        hn = enter(apply_norm(h, "layernorm_np") * (1 + s1) + b1, self.heads_split)
        q = (hn @ cw(self.wq).reshape(E, H * Dh)).view(B, S, H, Dh)
        k = (hn @ cw(self.wk).reshape(E, H * Dh)).view(B, S, H, Dh)
        v = (hn @ cw(self.wv).reshape(E, H * Dh)).view(B, S, H, Dh)
        att = attention(q, k, v, causal=False, window=None, softcap=0.0,
                        use_flash=use_flash)
        o = att.reshape(B, S, H * Dh) @ cw(self.wo).reshape(H * Dh, E)
        if self.heads_split:
            o = coll.all_reduce_sum(o, mesh)
        h = h + g1 * o
        hn = enter(apply_norm(h, "layernorm_np") * (1 + s2) + b2, self.ffn_split)
        m = apply_mlp(hn, cw(self.w_in), cw(self.w_out), cw(self.w_gate))
        if self.ffn_split:
            m = coll.all_reduce_sum(m, mesh)
        return h + g2 * m


class DiT(nn.Module):
    """x (B, H, W, C), t (B,) → raw network output of x's shape.

    ``shardings`` (a tree of ``ParamSharding`` over ``dit_param_shapes``)
    builds a rank's DiT: each leaf at its local shape, and the blocks of
    ``layer_range`` (every layer unless a pipeline axis cuts the stack).
    """

    def __init__(self, cfg: DiTConfig, dtype=torch.float32, device="cpu", shardings=None):
        super().__init__()
        self.cfg = cfg
        self.shardings = shardings
        full = dit_param_shapes(cfg)

        def local(*path):
            shape = _leaf(full, path)
            return shape if shardings is None else _leaf(shardings, path).local_shape(shape)

        p = lambda name: _param(local(name), dtype, device)
        if cfg.num_classes > 0:
            self.label_emb = p("label_emb")
        self.patch_in = p("patch_in")
        self.pos_emb = p("pos_emb")
        self.t_mlp1, self.t_mlp2 = p("t_mlp1"), p("t_mlp2")
        rows = slice(None)
        if shardings is not None:
            rows = shardings["layers"]["ada"].index(full["layers"]["ada"])[0]
        self.layer_range = range(cfg.num_layers)[rows]
        shapes = {name: local("layers", *path)[1:] for name, path in LAYER_PATHS.items()}
        self.blocks = nn.ModuleList(DiTBlock(cfg, dtype, device, shapes)
                                    for _ in self.layer_range)
        self.final_ada, self.final_ada_b = p("final_ada"), p("final_ada_b")
        self.patch_out = p("patch_out")

    def _patchify(self, x: Tensor) -> Tensor:
        c = self.cfg
        B, Hh, W, C = x.shape
        p = c.patch
        x = x.reshape(B, Hh // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, c.tokens, c.patch_dim)

    def _unpatchify(self, t: Tensor) -> Tensor:
        c = self.cfg
        B, p, n = t.shape[0], c.patch, c.image_size // c.patch
        t = t.reshape(B, n, n, p, p, c.channels).permute(0, 1, 3, 2, 4, 5)
        return t.reshape(B, c.image_size, c.image_size, c.channels)

    def embed(self, x: Tensor, t: Tensor, y: Optional[Tensor] = None, policy=None):
        """The patch tokens before the first block: (h (B, S, E), the time
        (and label) embedding in h's dtype (B, E), ``cw``: the weight
        cast of ``policy``). The embedding is computed in fp32 from the
        stored weights."""
        c = self.cfg
        f32 = lambda w: w.to(torch.float32)
        temb = timestep_embedding(t, 256)
        temb = F.silu(temb @ f32(self.t_mlp1)) @ f32(self.t_mlp2)
        if y is not None and c.num_classes > 0:
            idx = torch.where(y < 0, c.num_classes, y).long()
            temb = temb + f32(self.label_emb)[idx]
        if policy is not None:
            x = x.to(policy.compute)
            cw = lambda w: w.to(policy.compute)
        else:
            cw = lambda w: w
        h = self._patchify(x) @ cw(self.patch_in) + cw(self.pos_emb)
        return h, temb.to(h.dtype), cw

    def run_blocks(self, h: Tensor, temb: Tensor, cw, mesh=None) -> Tensor:
        """This rank's blocks, in order, on h (B, S, E) under the embedding
        ``temb`` (B, E)."""
        silu_temb = F.silu(temb)
        for block in self.blocks:
            h = block(h, silu_temb, cw, self.cfg.use_flash, mesh)
        return h

    def head(self, h: Tensor, temb: Tensor, cw) -> Tensor:
        """The final adaLN and the output projection, unpatchified."""
        mod = F.silu(temb) @ cw(self.final_ada) + cw(self.final_ada_b)
        s, b = mod[:, None, :].chunk(2, dim=-1)
        h = apply_norm(h, "layernorm_np") * (1 + s) + b
        return self._unpatchify(h @ cw(self.patch_out))

    def graph_state(self) -> tuple:
        """``layers.graph_state``: what a cached graph of this net's forward
        depends on (the config, ``training``, each weight's buffer)."""
        return layers.graph_state(self)

    def forward(self, x: Tensor, t: Tensor, y: Optional[Tensor] = None,
                policy=None, mesh=None) -> Tensor:
        """The network's output. ``mesh``: the rank's blocks under the
        tensor-parallel rules (module docstring)."""
        if len(self.blocks) != self.cfg.num_layers:
            raise ValueError(f"this DiT holds layers {self.layer_range.start}-"
                             f"{self.layer_range.stop - 1} of {self.cfg.num_layers} (a "
                             f"pipeline stage): run it through make_pipelined_dit_forward")
        h, temb, cw = self.embed(x, t, y, policy)
        return self.head(self.run_blocks(h, temb, cw, mesh), temb, cw)


def shard_dit(model: DiT, shardings) -> DiT:
    """The rank's DiT under ``shardings`` (``DiT``'s), each leaf the rank's
    block of ``model``'s, copied: bitwise the slices, and only the
    rank's blocks held."""
    cfg = model.cfg
    first = next(model.parameters())
    out = DiT(cfg, dtype=first.dtype, device=first.device, shardings=shardings)
    full = dit_param_shapes(cfg)
    with torch.no_grad():
        for name, sh in shardings.items():
            if name != "layers":
                getattr(out, name).copy_(sh.local(getattr(model, name)))
        for i, r in enumerate(out.layer_range):
            for name, path in LAYER_PATHS.items():
                idx = _leaf(shardings["layers"], path).index(_leaf(full["layers"], path))[1:]
                getattr(out.blocks[i], name).copy_(getattr(model.blocks[r], name)[idx])
    return out


def init_dit(cfg: DiTConfig, generator: torch.Generator,
             dtype=torch.float32) -> DiT:
    """A DiT with the reference's initial distributions, drawn from
    ``generator`` on its device (the zero-init leaves stay zero)."""
    model = DiT(cfg, dtype=dtype, device=generator.device)
    E, H, Dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    init = lambda shape, **kw: dense_init(shape, generator=generator,
                                          dtype=dtype, **kw)
    normal = lambda shape: (0.02 * torch.randn(
        shape, generator=generator, device=generator.device)).to(dtype)
    with torch.no_grad():
        for blk in model.blocks:
            for name in ("wq", "wk", "wv"):
                getattr(blk, name).copy_(init((E, H, Dh), fan_in=E))
            blk.wo.copy_(init((H, Dh, E), fan_in=H * Dh))
            blk.w_in.copy_(init((E, cfg.d_ff)))
            blk.w_gate.copy_(init((E, cfg.d_ff)))
            blk.w_out.copy_(init((cfg.d_ff, E)))
        if cfg.num_classes > 0:
            model.label_emb.copy_(normal((cfg.num_classes + 1, E)))
        model.patch_in.copy_(init((cfg.patch_dim, E)))
        model.pos_emb.copy_(normal((cfg.tokens, E)))
        model.t_mlp1.copy_(init((256, E)))
        model.t_mlp2.copy_(init((E, E)))
    return model


def liven_zero_init(model: DiT, generator: torch.Generator,
                    scale: float = 0.02) -> DiT:
    """Set the zero-init leaves to ``scale``·N(0, 1) in place, so that the
    network's output is not identically 0 (the reference's fresh DiT
    returns exactly 0, which would hide the attention path)."""
    tensors = [getattr(b, n) for b in model.blocks for n in ZERO_INIT_LAYER]
    tensors += [getattr(model, n) for n in ZERO_INIT_TOP]
    with torch.no_grad():
        for w in tensors:
            w.copy_(scale * torch.randn(w.shape, generator=generator,
                                        device=generator.device))
    return model


def params_from_jax(tree: Mapping[str, Any], cfg: DiTConfig,
                    device="cpu") -> DiT:
    """The reference's ``init_dit`` parameter tree (nested dict of numpy
    arrays or tensors) → a ``DiT`` holding the same values.

    The reference stacks the per-layer leaves on axis 0 for
    ``lax.scan``; they are unstacked into the ``ModuleList``. Layouts are
    kept as they are. The module takes the tree's dtype.
    """
    # the norms are parameter-free: their leaves are empty dicts
    top = {k: to_tensor(v) for k, v in tree.items()
           if k != "layers" and not isinstance(v, Mapping)}
    dtype = top["patch_in"].dtype
    model = DiT(cfg, dtype=dtype, device=device)
    layers = tree["layers"]
    per_layer = {
        "wq": layers["attn"]["wq"], "wk": layers["attn"]["wk"],
        "wv": layers["attn"]["wv"], "wo": layers["attn"]["wo"],
        "w_in": layers["mlp"]["w_in"], "w_gate": layers["mlp"]["w_gate"],
        "w_out": layers["mlp"]["w_out"], "ada": layers["ada"],
        "ada_b": layers["ada_b"],
    }
    with torch.no_grad():
        for name, stacked in per_layer.items():
            stacked = to_tensor(stacked)
            if stacked.shape[0] != cfg.num_layers:
                raise ValueError(f"layers/{name}: {stacked.shape[0]} layers, "
                                 f"config has {cfg.num_layers}")
            for i, blk in enumerate(model.blocks):
                _assign(getattr(blk, name), stacked[i], f"layers/{name}[{i}]")
        for name, value in top.items():
            if not hasattr(model, name):
                raise ValueError(f"unexpected parameter {name!r}")
            _assign(getattr(model, name), value, name)
    return model


def _assign(param: Tensor, value: Tensor, name: str) -> None:
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"{name}: shape {tuple(value.shape)} != {tuple(param.shape)}")
    param.copy_(value.to(param.dtype))


def dit_forward(model: DiT, x: Tensor, t: Tensor, policy=None,
                y: Optional[Tensor] = None, mesh=None) -> Tensor:
    """Function form of ``model(x, t, y, policy, mesh)``."""
    return model(x, t, y=y, policy=policy, mesh=mesh)


def make_score_fn(model: DiT, sde, policy=None):
    """s(x, t) = −net(x, t)/std(t) (noise-prediction parametrisation).

    With ``policy`` the module's parameters are cast in place to
    ``policy.param`` by ``policy.cast_params`` (no second copy of the
    weights is kept), x is cast
    to ``policy.compute`` on entry, the division by std runs in fp32, and
    the score is returned in ``policy.state``. With a class-conditional
    config the score takes an optional ``y``. The score carries the net's
    ``graph_state``, which keys the solvers' graph cache on it.
    """
    if policy is not None:
        policy.cast_params(model)

    def score(x: Tensor, t: Tensor, y: Optional[Tensor] = None) -> Tensor:
        _, std = sde.marginal(t)
        if policy is not None:
            x = policy.to_compute(x)
        out = model(x, t, y=y, policy=policy)
        s = -out.to(torch.float32) / bcast(std, x)
        return s if policy is None else policy.to_state(s)

    score.graph_state = model.graph_state
    return score


def param_count(model: DiT) -> int:
    return sum(p.numel() for p in model.parameters())

