"""Sharding rules for data-parallel sampling and serving; port of the
diffusion half of ``repro/parallel/sharding.py`` (``data_axes``,
``batch_sharding``, ``replicated``, ``sample_state_shardings``,
``solver_carry_shardings``, ``serving_loop_shardings``).

In the reference a sharding is a ``NamedSharding``: it says how XLA lays
one global array over the mesh. In the port each rank holds only its own
rows, so a sharding here says which rows of a (B, ...) or (B,) leaf this
rank owns: a contiguous range when the batch divides the mesh's data
axes, every row otherwise (the reference then replicates). The rows of
shard i are [i·B/n, (i+1)·B/n), with i this rank's index over the data
axes, major to minor, which is where the reference's ``PartitionSpec``
puts them.

The LM's rules are the reference's, verbatim and in its order: a leaf's
path is matched against ``_RULES`` (the MoE ``mlp/(w_in|w_gate)$`` rule
comes first and also decides dense MLPs, whose stacked (R, E, F) leaves
it shards on F), each dimension takes the first candidate axis whose
size divides it, and a leaf no rule names is replicated. A spec is a
tuple with one entry a dimension, as a ``PartitionSpec``: None, an axis
name, or a tuple of names (major to minor). ``param_shardings`` returns
a tree of ``ParamSharding``: the spec and the mesh, which give a leaf's
local shape and this rank's slice of a full tensor. A ``Mesh`` without
a ``DeviceMesh`` is enough to read them. A leaf sharded over a data
axis too (``fsdp=True``, ZeRO-3) runs in training: the model path
gathers it over the data axes where its layer runs
(``collectives.fsdp_gather``, or ``fsdp_broadcast`` where the data axes
cut the repeat axis), and ``ParamSharding.data_part`` and
``model_part`` give the two halves of its block.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.parallel.mesh import Mesh

Tensor = torch.Tensor


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The batch axes present in this mesh: ("pod", "data") or ("data",)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


@dataclasses.dataclass(frozen=True, eq=False)
class RowSharding:
    """The rows of a (``batch``, ...) leaf of ``ndim`` dimensions that this
    rank of ``mesh`` owns: ``rows``, sharded over ``axes`` (empty when
    every rank holds every row). ``batch`` None means the leaf has no
    batch axis (a replicated scalar)."""

    mesh: Mesh
    axes: Tuple[str, ...]
    batch: Optional[int]
    ndim: int

    @property
    def n_shards(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.axes)

    @property
    def shard(self) -> int:
        """This rank's shard index over ``axes`` (0 when replicated)."""
        return self.mesh.index(self.axes)

    @property
    def replicated(self) -> bool:
        return not self.axes

    @property
    def rows(self) -> slice:
        if self.batch is None:
            return slice(None)
        n = self.batch // self.n_shards
        return slice(self.shard * n, (self.shard + 1) * n)

    @property
    def spec(self) -> tuple:
        """The reference's ``PartitionSpec`` as a tuple: the batch axes (or
        None) first, None for every other dimension."""
        return ((self.axes or None),) + (None,) * (self.ndim - 1) if self.ndim else ()

    def local(self, t: Tensor) -> Tensor:
        """This rank's rows of the global leaf ``t`` (a view)."""
        if self.batch is not None and t.shape[0] != self.batch:
            raise ValueError(f"leaf batch {t.shape[0]} != sharding batch {self.batch}")
        return t[self.rows]

    def global_shape(self, local_shape) -> tuple:
        """The global shape of a leaf whose local rows have ``local_shape``."""
        return (self.batch, *tuple(local_shape)[1:])

    def with_ndim(self, ndim: int) -> "RowSharding":
        return dataclasses.replace(self, ndim=ndim)


def batch_sharding(mesh: Mesh, batch: int, ndim: int) -> RowSharding:
    """Shard the leading batch dim over ("pod", "data") when divisible."""
    axes = data_axes(mesh)
    total = math.prod(mesh.shape[a] for a in axes) if axes else 1
    if axes and batch % total == 0:
        return RowSharding(mesh, axes, batch, ndim)
    return RowSharding(mesh, (), batch, ndim)


def replicated(mesh: Mesh) -> RowSharding:
    """Every rank holds the whole leaf (the PRNG generator, loop counters)."""
    return RowSharding(mesh, (), None, 0)


def sample_state_shardings(mesh: Mesh, batch: int, state_ndim: int):
    """Shardings for the adaptive-sampling carry (DESIGN.md §3).

    Returns ``(array, vector, replicated)``: ``array`` for (B, ...) state
    tensors (x, x'_prev, noise), ``vector`` for per-sample (B,) values
    (t, h, nfe, the accept/reject counters, done), ``replicated`` for the
    generator and loop counters. The batch shards over the mesh's data
    axes when divisible; otherwise everything replicates, so the caller
    never has to special-case indivisible batches.
    """
    arr = batch_sharding(mesh, batch, state_ndim)
    return arr, arr.with_ndim(1), replicated(mesh)


def solver_carry_shardings(mesh: Mesh, batch: int, state_ndim: int, *,
                           per_slot_keys: bool = False, cond=None,
                           tolerances: bool = False, telemetry: bool = False):
    """A ``SolverCarry`` whose leaves are the ``RowSharding`` of each leaf
    of the carry (DESIGN.md §7).

    ``per_slot_keys`` shards the noise source with the state: the
    carry's ``generator`` is then a ``SlotStreams`` (or a list of per-slot
    sources) whose seed and counter rows are this rank's rows, and each
    rank draws its own rows (P1 draws by (seed, counter), so no rank
    needs another's streams, and shard-local compaction never moves a
    stream across ranks). Without it the generator replicates: every
    rank draws the whole batch's noise and keeps its rows.

    ``cond`` is the condition payload (a dict of tensors, each leading
    with the batch); each leaf gets a batch sharding of its own ndim, so
    a slot's condition lives with the slot. ``tolerances`` gives the
    per-sample ``atol``/``rtol`` the (B,) vector sharding; False matches
    a carry with no tolerance leaves. ``telemetry`` shards the
    step-telemetry ring's (B, cap) buffers by rows and replicates its
    head cursor; False matches a carry without a ring.
    """
    from repro_torch.core.solvers.adaptive import SolverCarry
    from repro_torch.observability.telemetry import StepTelemetry

    arr, vec, rep = sample_state_shardings(mesh, batch, state_ndim)
    cond_s = ({k: batch_sharding(mesh, batch, v.ndim) for k, v in cond.items()}
              if cond is not None else None)
    tol = vec if tolerances else None
    tel = None
    if telemetry:
        ring = batch_sharding(mesh, batch, 2)
        tel = StepTelemetry(t=ring, h=ring, err=ring, accept=ring, head=rep)
    return SolverCarry(x=arr, x_prev=arr, t=vec, h=vec, nfe=vec, accepted=vec,
                       rejected=vec, done=vec, iterations=rep,
                       generator=vec if per_slot_keys else rep,
                       atol=tol, rtol=tol, cond=cond_s, telemetry=tel)


def serving_loop_shardings(mesh: Mesh, batch: int, state_ndim: int, *,
                           per_slot_keys: bool = True, cond=None,
                           tolerances: bool = False, telemetry: bool = False):
    """The sharding pair of the serve loop under a mesh (DESIGN.md §12):
    ``(carry_shardings, scalar_sharding)``.

    In the reference the pair pins the jitted driver's outputs to the
    carry's input shardings, so that XLA keeps the donated buffers. The
    port has no donation to pin: each rank's carry is its static block
    of rows, written in place by the host's event updates and, on the
    card, read and written by the captured horizon graph
    (``solver_carry_shardings``, ``per_slot_keys`` on). The scalar
    sharding (replicated) covers the driver's event state and the global
    flags the ranks agree on after every horizon.
    """
    carry = solver_carry_shardings(mesh, batch, state_ndim, per_slot_keys=per_slot_keys,
                                   cond=cond, tolerances=tolerances, telemetry=telemetry)
    return carry, replicated(mesh)


# --------------------------------------------------------------------------
# the language models' rules (reference :25-:215)
# --------------------------------------------------------------------------

MODEL_AXIS = "model"

#: (path regex, per-dimension candidate axes), most specific first; see the
#: module docstring and the reference (:38) for the candidates' meaning
_RULES: Sequence[Tuple[str, Sequence[Sequence[Optional[str]]]]] = (
    # --- MoE experts: prefer expert sharding, fall back to ffn dim -----
    (r"mlp/(w_in|w_gate)$", [["expert_or_none"], [None], ["model_if_expert_failed"]]),
    (r"mlp/w_out$", [["expert_or_none"], ["model_if_expert_failed"], [None]]),
    (r"mlp/router$", [[None], [None]]),
    (r"shared/(w_in|w_gate)$", [[None], [MODEL_AXIS]]),
    (r"shared/w_out$", [[MODEL_AXIS], [None]]),
    # --- attention ------------------------------------------------------
    (r"mixer/wq$", [[None], [MODEL_AXIS], [None]]),
    (r"mixer/w[kv]$", [[None], [MODEL_AXIS], [None]]),
    (r"mixer/wo$", [[MODEL_AXIS], [None], [None]]),
    (r"mixer/b[qkv]$", [[MODEL_AXIS], [None]]),
    # --- mamba ------------------------------------------------------------
    (r"mixer/in_[zx]$", [[None], [MODEL_AXIS]]),
    (r"mixer/in_(B|C|dt)$", [[None], [None]]),
    (r"mixer/conv_x$", [[None], [MODEL_AXIS]]),
    (r"mixer/conv_[BC]$", [[None], [None]]),
    (r"mixer/(A_log|D|dt_bias)$", [[MODEL_AXIS]]),
    (r"mixer/out$", [[MODEL_AXIS], [None]]),
    # --- dense MLP ---------------------------------------------------------
    (r"mlp/(w_in|w_gate)$", [[None], [MODEL_AXIS]]),
    (r"mlp/w_out$", [[MODEL_AXIS], [None]]),
    # --- norms & everything small -----------------------------------------
    (r"norm", [[None]] * 4),
)


def _embed_spec(path: str, shape, msize: int) -> Optional[tuple]:
    """Vocab-sharded embedding and head specs, by ndim (a codebook model
    adds a leading codebook dim); None for any other leaf."""
    def vm(d):
        return MODEL_AXIS if shape[d] % msize == 0 else None

    if re.search(r"(^|/)embed$", path):
        if len(shape) == 2:   # (V, E)
            return (vm(0), None)
        if len(shape) == 3:   # (K, V, E)
            return (None, vm(1), None)
    if re.search(r"(^|/)lm_head$", path):
        if len(shape) == 2:   # (E, V)
            return (None, vm(1))
        if len(shape) == 3:   # (K, E, V)
            return (None, None, vm(2))
    return None


def _path_str(path) -> str:
    """A tree path (a sequence of keys) as the rules' "a/b/c"."""
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _spec_for(path: str, shape: Tuple[int, ...], mesh, num_experts: Optional[int]) -> tuple:
    """The spec of the leaf at ``path`` of ``shape`` (reference :88). A
    stacked block leaf's leading repeat axis is the rule's offset; a leaf
    of fewer dims than its rule takes the rule's last dims."""
    msize = mesh.shape.get(MODEL_AXIS, 1)

    es = _embed_spec(path, shape, msize)
    if es is not None:
        return es

    for pat, dims in _RULES:
        if re.search(pat, path):
            offset = len(shape) - len(dims)
            if offset < 0:
                dims = dims[-len(shape):]
                offset = 0
            spec: list = [None] * len(shape)
            expert_sharded = False
            for i, cands in enumerate(dims):
                dim = offset + i
                for cand in cands:
                    if cand is None:
                        break
                    if cand == "expert_or_none":
                        if num_experts and shape[dim] == num_experts and shape[dim] % msize == 0:
                            spec[dim] = MODEL_AXIS
                            expert_sharded = True
                        break
                    if cand == "model_if_expert_failed":
                        if not expert_sharded and shape[dim] % msize == 0:
                            spec[dim] = MODEL_AXIS
                        break
                    if cand == "vocab_model":
                        if shape[dim] % msize == 0:
                            spec[dim] = MODEL_AXIS
                        break
                    if shape[dim] % mesh.shape.get(cand, 1) == 0:
                        spec[dim] = cand
                        break
            return tuple(spec)
    return ()  # replicate by default


def _spec_axes(entry) -> Tuple[str, ...]:
    """The axes of one spec entry: () for None, (name,) or the tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True, eq=False)
class ParamSharding:
    """How one parameter leaf lies over ``mesh``: ``spec`` has an entry a
    dimension (missing trailing entries are None). Dimension d is cut
    into ``n`` equal blocks over the axes of its entry, and this rank
    holds block ``mesh.index(axes)``."""

    mesh: Mesh
    spec: tuple

    def entry(self, dim: int):
        return self.spec[dim] if dim < len(self.spec) else None

    def axes(self) -> Tuple[str, ...]:
        """Every axis the leaf is sharded over."""
        return tuple(a for e in self.spec for a in _spec_axes(e))

    def sharded_dim(self, axis: str = MODEL_AXIS) -> Optional[int]:
        """The dimension sharded over ``axis``, or None."""
        for d, e in enumerate(self.spec):
            if axis in _spec_axes(e):
                return d
        return None

    def _block(self, dim: int, size: int) -> slice:
        axes = _spec_axes(self.entry(dim))
        if not axes:
            return slice(None)
        n = math.prod(self.mesh.shape[a] for a in axes)
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not split into {n} blocks")
        i, b = self.mesh.index(axes), size // n
        return slice(i * b, (i + 1) * b)

    def local_shape(self, shape) -> tuple:
        """This rank's shape of a leaf whose full shape is ``shape``."""
        out = []
        for d, size in enumerate(shape):
            axes = _spec_axes(self.entry(d))
            out.append(size // math.prod(self.mesh.shape[a] for a in axes) if axes else size)
        return tuple(out)

    def index(self, shape) -> tuple:
        """The slices that cut this rank's block out of a full leaf."""
        return tuple(self._block(d, size) for d, size in enumerate(shape))

    def local(self, t: Tensor) -> Tensor:
        """This rank's block of the full leaf ``t`` (a view)."""
        return t[self.index(t.shape)]

    def _keep(self, keep) -> "ParamSharding":
        spec = []
        for e in self.spec:
            axes = tuple(a for a in _spec_axes(e) if keep(a))
            spec.append(None if not axes else axes[0] if len(axes) == 1 else axes)
        return ParamSharding(self.mesh, tuple(spec))

    def data_part(self) -> "ParamSharding":
        """The spec's data axes alone: the block of a leaf's model-axis
        block (``local``) that this rank holds under ZeRO-3, as ``local``
        gives the model-axis block of a whole leaf."""
        return self._keep(lambda a: a != MODEL_AXIS)

    def model_part(self) -> "ParamSharding":
        """The spec's "model" axis alone (the tensor-parallel layout)."""
        return self._keep(lambda a: a == MODEL_AXIS)

    def data_dim(self) -> Optional[int]:
        """The dimension cut over data axes (ZeRO-3), or None."""
        for d, e in enumerate(self.spec):
            if set(_spec_axes(e)) - {MODEL_AXIS}:
                return d
        return None

    def data_axes(self) -> Tuple[str, ...]:
        d = self.data_dim()
        return () if d is None else _spec_axes(self.spec[d])

    def replicas(self) -> int:
        """How many ranks hold each block: the mesh's size over the blocks'."""
        return self.mesh.size // math.prod(self.mesh.shape[a] for a in self.axes())


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of nested dicts (``path``: the keys)."""
    if isinstance(tree, Mapping):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_shardings(params_shapes, mesh: Mesh, num_experts: Optional[int] = None, *,
                    fsdp: bool = False):
    """A tree of ``ParamSharding`` matching a tree of tensors (meta tensors
    do: ``launch/specs.py::abstract_params``) or of shapes (reference
    :130). ``fsdp=True``: after the tensor-parallel rules, the largest
    remaining unsharded dim of every ≥2-dim leaf that the data axes'
    total size divides also shards over the data axes (ZeRO-3 style;
    the model path gathers such a leaf where its layer runs)."""
    axes = data_axes(mesh)
    dsize = math.prod(mesh.shape[a] for a in axes) if axes else 1

    def fn(path, leaf):
        shape = tuple(getattr(leaf, "shape", leaf))
        spec = _spec_for(_path_str(path), shape, mesh, num_experts)
        if fsdp and len(shape) >= 2 and dsize > 1:
            parts = list(spec) + [None] * (len(shape) - len(spec))
            cands = sorted((i for i in range(len(shape))
                            if parts[i] is None and shape[i] % dsize == 0
                            and shape[i] >= dsize), key=lambda i: -shape[i])
            if cands:
                parts[cands[0]] = axes if len(axes) > 1 else axes[0]
                spec = tuple(parts)
        return ParamSharding(mesh, spec)

    return tree_map_with_path(fn, params_shapes)


def kv_cache_spec(axis_sizes: dict, axes: Tuple[str, ...], batch: int, cache_len: int,
                  kv_heads: int) -> tuple:
    """The spec of a (B, S_cache, Kv, Dh) decode cache (reference :173):
    the batch over the data axes when it divides them; the KV heads over
    "model" when they divide it, else the cache sequence over "model"
    (distributed flash-decode); when the batch cannot shard, the
    sequence over the data axes too (long context at B = 1)."""
    total = math.prod(axis_sizes[a] for a in axes) if axes else 1
    msize = axis_sizes.get(MODEL_AXIS, 1)
    if kv_heads % msize == 0:
        head_ax, seq_model = MODEL_AXIS, None
    else:
        head_ax, seq_model = None, MODEL_AXIS if cache_len % msize == 0 else None
    if axes and total > 1 and batch % total == 0:
        return (axes, seq_model, head_ax, None)
    if axes and total > 1 and cache_len % total == 0:
        seq_ax = (axes + (MODEL_AXIS,)) if seq_model else axes
        return (None, seq_ax, head_ax, None)
    return (None, seq_model, head_ax, None)


def kv_cache_sharding(mesh: Mesh, batch: int, cache_len: int, kv_heads: int) -> ParamSharding:
    """``kv_cache_spec`` on ``mesh``, as a ``ParamSharding`` (reference :201)."""
    return ParamSharding(mesh, kv_cache_spec(mesh.shape, data_axes(mesh), batch, cache_len,
                                             kv_heads))


def lever_axes(value) -> Tuple[str, ...]:
    """The mesh axes a lever or a spec entry names: None → (), "a" or
    "a,b" → ("a", ...), a tuple as it is."""
    if not value:
        return ()
    if isinstance(value, str):
        return tuple(a for a in value.split(",") if a)
    return tuple(value)


_LEVERS = ("attn_q_seq_shard", "residual_seq_shard", "decode_flash_shard")


def check_levers(cfg, mesh: Optional[Mesh]) -> None:
    """Raise ``ValueError`` for a mesh lever of ``cfg`` that names an axis
    ``mesh`` lacks, or any lever when no mesh is passed (the reference's
    sharding constraint and ``shard_map`` fail without a mesh that has the
    axis). The port splits rows over "model" only, where every rank holds
    the same activations: ``attn_q_seq_shard`` and ``residual_seq_shard``
    naming another axis raise too."""
    for lever in _LEVERS:
        axes = lever_axes(getattr(cfg, lever))
        if not axes:
            continue
        if mesh is None:
            raise ValueError(f"{lever}={getattr(cfg, lever)!r} names mesh axes, but no mesh "
                             f"was passed (mesh=)")
        missing = [a for a in axes if a not in mesh.axis_names]
        if missing:
            raise ValueError(f"{lever} names {missing}, which the mesh over "
                             f"{mesh.axis_names} lacks")
        if lever != "decode_flash_shard" and axes != (MODEL_AXIS,):
            raise ValueError(f"{lever}={getattr(cfg, lever)!r}: the port splits the "
                             f"sequence over {MODEL_AXIS!r} only (the data axes carry "
                             f"different rows on each rank)")


def model_rank(mesh: Mesh) -> Tuple[int, int]:
    """(size of "model", this rank's coordinate on it); (1, 0) without it."""
    if MODEL_AXIS not in mesh.axis_names:
        return 1, 0
    return mesh.shape[MODEL_AXIS], mesh.coord(MODEL_AXIS)


def split_rows(size: int, n: int, i: int) -> Tuple[int, int]:
    """Block i of ``size`` rows cut into n blocks of ⌈size/n⌉ (the last
    ones short or empty): (start, stop)."""
    block = -(-size // n)
    start = min(size, i * block)
    return start, min(size, start + block)


def decode_cache_sharding(cfg, mesh: Mesh, batch: int, cache_len: int) -> ParamSharding:
    """How one (B, S_cache, Kv, Dh) decode cache lies on the port's ranks:
    ``kv_cache_spec``, except that ``decode_flash_shard`` puts the
    sequence over its axes (what the reference's ``flash_decode``
    ``shard_map`` reshards the cache to), with every KV head where the
    axes include "model" and the batch over the data axes the sequence
    does not take."""
    spec = kv_cache_spec(mesh.shape, data_axes(mesh), batch, cache_len, cfg.num_kv_heads)
    axes = lever_axes(cfg.decode_flash_shard)
    if axes:
        b = spec[0] if spec[0] and not set(lever_axes(spec[0])) & set(axes) else None
        h = None if MODEL_AXIS in axes else spec[2]
        spec = (b, axes if len(axes) > 1 else axes[0], h, None)
    sh = ParamSharding(mesh, spec)
    n = math.prod(mesh.shape[a] for a in lever_axes(sh.entry(1)))
    if cache_len % n:
        raise ValueError(f"a cache of {cache_len} slots does not split over the {n} ranks "
                         f"of {sh.entry(1)!r}")
    return sh
