"""Step functions of the language-model path; port of
``repro/launch/steps.py``.

``make_train_step`` returns f(params, opt_state, batch) → (params,
opt_state, metrics): next-token cross-entropy plus the "E" layers' aux
loss, its gradients by autograd, one ``optim.AdamW`` update (in place).
``make_prefill_step`` returns f(params, batch) → next tokens (B, 1) int32
((B, 1, K) with K codebooks): the full-sequence forward with the head on
the last position only. ``make_serve_step`` returns f(params, batch,
state) → (next tokens (B, 1[, K]) int32, state'), greedy; on the card
(without a mesh) a ``GraphedServeStep``, the decode step and its argmax
captured once as a CUDA graph and replayed every later call (the
reference's ``jax.jit(make_serve_step(cfg))``). ``batch`` is a
dict with ``"tokens"`` and, as the model needs, ``"cross_embeds"`` (the
image embeddings of the cross-attention layers) and, for continuous
batching, ``"start_pos"`` (B,), as in the reference. The prefill and
serve steps run without autograd, every step in the config's dtype
(``ModelConfig.dtype``; fp32 products with TF32 off), on ``device``: the
card unless the caller asks for the CPU (or, for the dry run's meta
tensors, ``"meta"``); they raise at construction when no card is there.
Under an NCCL mesh on the card the serve step is graphed too, its
collectives captured; on a gloo mesh it stays eager.

``make_prefill_step(mesh=)`` and ``make_serve_step(mesh=)`` run under a
``("data", "model")`` mesh (on ``mesh.device``) with the rank's
parameter shard (``init_model(mesh=)``/``shard_params``) and, for
serving, its decode state (``init_decode_state(mesh=)``): every rank
calls the step with the whole batch, keeps its rows
(``parallel.sharding.batch_sharding``: rows over "data" when they
divide), picks its rows' tokens over its vocab columns where the head
is cut over "model" (``greedy_tokens``: no rank gathers the logits), and
returns the tokens of every row (gathered over "data").

``make_train_step(mesh=, shardings=)`` is the reference's train step
under its shardings (reference :25-56 under ``jit`` with
``in_shardings``/``out_shardings``), every reduction GSPMD inserts made
an explicit collective: the rank takes its shard laid out by
``shardings`` (``launch.specs.train_layout``: "tp", "fsdp" or "zero1";
default the tensor-parallel layout of ``init_model(mesh=)``), every rank
is called with the whole batch and keeps its rows (which must split
evenly over the data axes), the forward's collectives carry their
backward passes, ce_rows is the vocab-parallel cross-entropy over the
rank's vocab columns where the head is cut over "model"
(``collectives.vocab_parallel_cross_entropy``: GSPMD's loss on the
sharded vocabulary, no gather of the logits), each rank's objective is
(ce_rows + aux) / n_data (the mean of equal row blocks' means is the
batch's mean, and an "E" layer's aux, the same on every data rank, is
counted once by the sum), the
gradients of the leaves the data axes do not cut are summed over them
(one all-reduce a leaf; ZeRO-3's leaves arrive reduce-scattered), and
``AdamW.update`` clips by the norm over the mesh and updates the rank's
blocks (ZeRO-1: then gathers them). It returns the rank's new shard and
moment blocks and the global metrics, plus ``clip_scale``.
"""

from __future__ import annotations

import dataclasses
import math
import time
import weakref
from typing import Callable, Dict, Optional

import torch

from repro_torch.core.precision import pin_full_fp32_math
from repro_torch.core.solvers.adaptive import mesh_capturable
from repro_torch.data.tokens import lm_loss
from repro_torch.device import resolve_device
from repro_torch.kernels.graph_loop import ops as loop_ops
from repro_torch.models import decode_step, forward
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamW
from repro_torch.optim.tree import leaves, tree_map
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.collectives import gather_rows
from repro_torch.parallel.sharding import batch_sharding, data_axes

Tensor = torch.Tensor
Batch = Dict[str, Tensor]


def _cross(batch: Batch, dev):
    cross = batch.get("cross_embeds")
    return None if cross is None else cross.to(dev)


def make_loss_fn(cfg: ModelConfig, *, remat: str = "none", use_flash: bool = False,
                 use_kernel_ssd: bool = False, mesh=None, shardings=None) -> Callable:
    """The train step's loss (the reference's ``loss_fn``, reference :35):
    f(params, batch, rows=None) → (loss, ce, aux), with loss = ce + aux,
    ce the next-token cross-entropy (``data.tokens.lm_loss``) and aux the
    "E" layers' summed aux loss. The forward takes the plain attention and
    SSD paths by default, as the reference's (no kernel has a backward:
    on the card ``use_flash=True`` or ``use_kernel_ssd=True`` under grad
    raises, ``kernels/autograd.py``). With ``mesh`` the batch is the
    rank's rows (``rows``, their ``RowSharding``) and ce their mean; a
    vocab-sharded head leaves each rank its vocab columns, and ce is
    ``collectives.vocab_parallel_cross_entropy`` over them (the same bits
    on every model rank), as the reference's GSPMD keeps the loss on the
    sharded vocabulary."""

    def loss_fn(params, batch: Batch, rows=None):
        tokens = batch["tokens"]
        (logits, first), aux = forward(
            params, tokens, cfg, cross_embeds=batch.get("cross_embeds"), use_flash=use_flash,
            use_kernel_ssd=use_kernel_ssd, remat=remat, mesh=mesh, rows=rows,
            shardings=shardings, vocab_local=True)
        if first is None:  # the rank holds every vocab column
            ce = lm_loss(logits, tokens)
        else:
            ce = coll.vocab_parallel_cross_entropy(logits[:, :-1], tokens[:, 1:], first, mesh)
        return ce + aux, ce, aux

    return loss_fn


def greedy_tokens(logits: Tensor, first: Optional[int], mesh=None) -> Tensor:
    """The greedy pick (int64 ids) over the last dimension of ``forward``'s
    or ``decode_step``'s ``vocab_local`` logits: ``torch.argmax`` where
    the rank holds every column (``first`` None), else
    ``collectives.vocab_parallel_argmax`` over "model" (bitwise the
    argmax of the gathered logits)."""
    if first is None:
        return torch.argmax(logits, dim=-1)
    return coll.vocab_parallel_argmax(logits, first, mesh)


def make_train_step(cfg: ModelConfig, optimizer: AdamW, *, remat: str = "none",
                    use_flash: bool = False, use_kernel_ssd: bool = False,
                    device="cuda", mesh=None, shardings=None) -> Callable:
    """One training step (reference :25): the loss of ``make_loss_fn``,
    its gradient for every parameter leaf (``torch.autograd.grad``; the
    leaves are set to require grad), then ``optimizer.update``, which
    writes the parameters and the moments in place. ``remat`` is
    ``forward``'s: "none", "full" (each layer recomputed in the backward
    pass) or "dots" (all but its unbatched products). Metrics are 0-d
    fp32 tensors ``loss``, ``ce`` and ``moe_aux``.

    ``mesh`` and ``shardings`` (a ``launch.specs.TrainLayout``): the step
    on the rank's shard (module docstring), on ``mesh.device``; its
    metrics add ``clip_scale``, and the moments must come from
    ``init_opt_state``. ``record`` (a dict, tests and the selftest only)
    receives the gradient tree the update used."""
    if mesh is not None:
        return _mesh_train_step(cfg, optimizer, remat=remat, use_flash=use_flash,
                                use_kernel_ssd=use_kernel_ssd, mesh=mesh,
                                layout=shardings or tp_layout(cfg, mesh))
    dev = resolve_device(device)
    pin_full_fp32_math()
    loss_fn = make_loss_fn(cfg, remat=remat, use_flash=use_flash,
                           use_kernel_ssd=use_kernel_ssd)

    def train_step(params, opt_state, batch: Batch, record: Optional[dict] = None):
        batch = {**batch, "tokens": batch["tokens"].to(dev), "cross_embeds": _cross(batch, dev)}
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, ce, aux = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, flat)
        it = iter(grads)  # tree_map walks the leaves in leaves()' order
        tree = tree_map(lambda _: next(it), params)
        params, opt_state = optimizer.update(tree, opt_state, params, info=record)
        if record is not None:
            record["grads"] = tree
        metrics = {"loss": loss.detach(), "ce": ce.detach(), "moe_aux": aux.detach()}
        return params, opt_state, metrics

    return train_step


def tp_layout(cfg: ModelConfig, mesh):
    """The layout ``init_model(mesh=)`` builds and ``train_loop`` trains:
    the tensor-parallel rules with ``num_experts`` (reference
    ``train.py:48``), parameters and moments alike."""
    from repro_torch.launch.specs import TrainLayout
    from repro_torch.models.transformer import model_shardings

    tree = model_shardings(cfg, mesh)
    return TrainLayout("tp", tree, tree)


def init_opt_state(optimizer: AdamW, params, layout=None):
    """The optimizer state of a rank's shard: moments shaped as its
    parameter blocks, or, under ZeRO-1 (``layout.name == "zero1"``), as
    their blocks over the data axes (``TrainLayout.blocks``)."""
    if layout is None or layout.name != "zero1":
        return optimizer.init(params)
    return optimizer.init(params, blocks=layout.blocks())


def _mesh_train_step(cfg: ModelConfig, optimizer: AdamW, *, remat: str, use_flash: bool,
                     use_kernel_ssd: bool, mesh, layout) -> Callable:
    dev = mesh.device
    pin_full_fp32_math()
    loss_fn = make_loss_fn(cfg, remat=remat, use_flash=use_flash,
                           use_kernel_ssd=use_kernel_ssd, mesh=mesh, shardings=layout.params)
    axes = data_axes(mesh)
    n_data = math.prod(mesh.shape[a] for a in axes)
    cut = [sh.data_dim() is not None for sh in leaves(layout.params)]
    blocks = layout.blocks() if layout.name == "zero1" else None

    def train_step(params, opt_state, batch: Batch, record: Optional[dict] = None):
        B = batch["tokens"].shape[0]
        if B % n_data:
            raise ValueError(f"a batch of {B} rows does not split evenly over the "
                             f"{n_data} ranks of the data axes {axes}")
        local, rows = _rows(batch, mesh, dev)
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, ce, aux = loss_fn(params, local, rows)
            # the rank's part of the global objective: summed over the data
            # ranks it is the batch's mean ce plus aux, counted once
            obj = loss if n_data == 1 else ce / n_data + aux / n_data
            grads = list(torch.autograd.grad(obj, flat, allow_unused=True))
        for i, (g, p) in enumerate(zip(grads, flat)):
            if g is None:
                grads[i] = torch.zeros_like(p)
        grads = coll.reduce_gradients(grads, mesh, skip=cut)
        it = iter(grads)
        tree = tree_map(lambda _: next(it), params)
        info = {}
        params, opt_state = optimizer.update(tree, opt_state, params, shardings=layout.params,
                                             blocks=blocks, info=info)
        if record is not None:
            record.update(info, grads=tree)
        ce_all = ce.detach()
        if n_data > 1:
            ce_all = coll.sum_over(ce_all / n_data, mesh, axes, "metrics")
        metrics = {"loss": loss.detach() if n_data == 1 else ce_all + aux.detach(),
                   "ce": ce_all, "moe_aux": aux.detach(), "clip_scale": info["clip_scale"]}
        return params, opt_state, metrics

    return train_step


def _rows(batch: Batch, mesh, dev):
    """The rank's rows of every leaf of ``batch`` and their ``RowSharding``
    (None without a mesh)."""
    if mesh is None:
        return {k: v.to(dev) for k, v in batch.items() if v is not None}, None
    rows = batch_sharding(mesh, batch["tokens"].shape[0], 1)
    return {k: v[rows.rows].to(dev) for k, v in batch.items() if v is not None}, rows


def _gather(tokens: Tensor, mesh, rows) -> Tensor:
    return tokens if mesh is None else gather_rows(tokens, mesh, rows)


def make_serve_step(cfg: ModelConfig, *, device="cuda", mesh=None,
                    shardings=None) -> Callable:
    """One greedy decode step (reference :64): f(params, batch, state,
    moe_routing=None) → (next tokens (B, 1[, K]) int32, state'), the
    state written in place (``models.decode_step``). With ``mesh`` the
    rank's shard and state, the tokens picked over the rank's vocab
    columns (``greedy_tokens``); every row's tokens returned (module
    docstring). ``shardings`` lays the shard out (default
    ``model_shardings``; the dry run passes ``param_shardings`` with
    ``physical_experts``, or ZeRO-3's, whose data-cut leaves are gathered
    where they are used). ``moe_routing`` is ``decode_step``'s.

    On the card the step is a ``GraphedServeStep`` over this eager one
    (its ``eager``), under ``mesh`` too where the mesh is NCCL's: the
    graph captures its collectives (the tokens' gather over "data", the
    model axis's sums, ``flash_decode``'s, the vocab pick's gather). On a
    gloo mesh it stays eager: gloo collectives cannot be captured. On the
    CPU (and on meta tensors) it is the eager function."""
    dev = resolve_device(device if mesh is None else mesh.device)
    pin_full_fp32_math()

    @torch.no_grad()
    def serve_step(params, batch: Batch, state, moe_routing: Optional[list] = None):
        local, rows = _rows(batch, mesh, dev)
        (logits, first), state = decode_step(
            params, local["tokens"], state, cfg, cross_embeds=local.get("cross_embeds"),
            start_pos=local.get("start_pos"), moe_routing=moe_routing, mesh=mesh, rows=rows,
            shardings=shardings, vocab_local=True)
        return _gather(greedy_tokens(logits, first, mesh).to(torch.int32), mesh, rows), state

    if dev.type == "cuda" and (mesh is None or mesh_capturable(mesh.group())):
        return GraphedServeStep(serve_step, dev, mesh=mesh)
    return serve_step


def _clone_state(v):
    """A copy of a decode state's tensors (dicts, lists and the caches'
    dataclasses rebuilt around them); every other leaf, such as a
    cache's ``sharding`` over the mesh's process groups, is shared."""
    if isinstance(v, Tensor):
        return v.clone()
    if isinstance(v, dict):
        return {k: _clone_state(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_clone_state(x) for x in v)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return dataclasses.replace(v, **{
            f.name: _clone_state(getattr(v, f.name)) for f in dataclasses.fields(v)
            if isinstance(getattr(v, f.name), (Tensor, dict, list, tuple))})
    return v


class GraphedServeStep:
    """A serve step captured as one CUDA graph: ``eager`` (the decode step
    and its argmax) recorded once per (the parameters' leaves, the state,
    the mesh, the batch's leaf shapes and float dtypes), then replayed by
    every call with that key.

    The batch's ``tokens``, ``start_pos`` and ``cross_embeds`` are copied
    into static input buffers before each replay; the tokens come back
    from a static output, copied out. The state is the caller's and is
    written in place by the graph, so its tensors must stay where they
    are (``decode_step`` keeps them). Lazy library state is made by one
    eager step on a copy of the state first, on a side stream: the eager
    step writes a cache slot and advances ``length``, and a graph built
    after it on the real state would start one token late. Under a mesh
    (``mesh``, NCCL's) that step runs the same collectives on every rank,
    so every communicator and subgroup exists before the capture. A new
    key drops the old graph and captures again. ``moe_routing`` (a Python
    list the graph cannot append to) raises ``ValueError``: routing
    records come from ``eager``.

    The parameters are held weakly (each leaf): a graph never replays
    over weights that were freed (a dead leaf is a new key), and the step
    keeps no model alive. A replay launches what the capture recorded:
    the kernel wrappers' calls (``graph_loop.ops.captured_calls``) and
    the collectives (``collectives.captured_since``) are charged to their
    counts and books once a replay, as if the step had run eagerly.

    ``captures`` counts the graphs captured and ``build_s`` the host
    seconds the warm-up, the capture and the instantiation took.
    """

    def __init__(self, eager: Callable, device: torch.device, mesh=None):
        self.eager = eager
        self.device = device
        self.mesh = mesh
        self.captures = 0
        self.build_s = 0.0
        self.reset()

    def reset(self) -> None:
        """Drop the graph: the next call captures."""
        self._key = self._graph = self._inputs = self._tokens = self._held = None
        self._refs, self._books, self._recorded = (), None, {}

    def __call__(self, params, batch: Batch, state, moe_routing: Optional[list] = None):
        if moe_routing is not None:
            raise ValueError("a graphed serve step cannot record moe_routing (a Python list "
                             "a CUDA graph cannot append to); run the step's eager function "
                             "(GraphedServeStep.eager)")
        batch = {k: v for k, v in batch.items() if v is not None}
        flat = leaves(params)
        # integer inputs of any width share a graph: they are cast into the
        # static buffer (the prompts' int64 and the sampled int32 tokens)
        key = (tuple(id(p) for p in flat), id(state),
               None if self.mesh is None else self.mesh.key(),
               tuple((k, tuple(v.shape), v.dtype if v.dtype.is_floating_point else "int")
                     for k, v in sorted(batch.items())))
        if key != self._key or not all(r() is not None for r in self._refs):
            self._capture(params, batch, state, key, flat)
        for k, buf in self._inputs.items():
            buf.copy_(batch[k])
        self._graph.replay()
        coll.charge(self._books)
        for (module, counter), calls in self._recorded.items():
            setattr(module, counter, getattr(module, counter) + calls)
        return self._tokens.clone(), state

    def _capture(self, params, batch: Batch, state, key, flat) -> None:
        t0 = time.perf_counter()
        self.reset()
        dev = self.device
        inputs = {k: v.to(dev).clone() for k, v in batch.items()}
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.eager(params, inputs, _clone_state(state))
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        calls, books = loop_ops.captured_calls(), coll.captured_books()
        with torch.cuda.graph(graph):
            tokens, _ = self.eager(params, inputs, state)
        self._recorded = {k: n - calls[k] for k, n in loop_ops.captured_calls().items()
                          if n != calls[k]}
        self._books = coll.captured_since(books)
        self._graph, self._inputs, self._tokens = graph, inputs, tokens
        # the ids in the key stay the leaves' while these live
        self._key, self._held, self._refs = key, state, tuple(weakref.ref(p) for p in flat)
        self.captures += 1
        self.build_s += time.perf_counter() - t0


def make_prefill_step(cfg: ModelConfig, *, use_flash: bool = True,
                      use_kernel_ssd: bool = True, last_logits_only: bool = True,
                      device="cuda", mesh=None, shardings=None) -> Callable:
    """Full-sequence forward (reference :77); ``use_flash`` (the default)
    runs every "A"/"L" attention layer through
    ``kernels.flash_attention.ops`` (K3 on the card; "X" layers take the
    plain path), ``use_kernel_ssd`` (the default) every Mamba2 layer's
    scan through ``kernels.ssd.ops`` (K7 on the card); ``False`` takes the
    plain path. With ``mesh`` K3 and K7 run on the rank's heads and rows,
    the head computes the rank's vocab columns of the last position only
    and the token is picked over them (``greedy_tokens``), and every row's
    token is returned; ``shardings`` as ``make_serve_step``'s."""
    dev = resolve_device(device if mesh is None else mesh.device)
    pin_full_fp32_math()

    @torch.no_grad()
    def prefill_step(params, batch: Batch):
        local, rows = _rows(batch, mesh, dev)
        (logits, first), _ = forward(params, local["tokens"], cfg,
                                     cross_embeds=local.get("cross_embeds"),
                                     use_kernel_ssd=use_kernel_ssd, use_flash=use_flash,
                                     last_logits_only=last_logits_only, mesh=mesh, rows=rows,
                                     shardings=shardings, vocab_local=True)
        # the next token after the last position of every sequence
        tokens = greedy_tokens(logits[:, -1:], first, mesh)
        return _gather(tokens.to(torch.int32), mesh, rows)

    return prefill_step
