"""Port ↔ reference parity: the language models' sharding rules
(``repro_torch.parallel.sharding``: ``_spec_for``, ``param_shardings``,
``kv_cache_spec``) against the reference's (``repro/parallel/
sharding.py``), on meshes that exist only as sizes (the port's ``Mesh``
without a ``DeviceMesh``; the reference's duck-typed stand-in).

First every case of ``tests/test_sharding_rules.py`` through the port's
``_spec_for``; then, for every registered architecture at full size, each
leaf's spec from the port's ``param_shardings`` over its meta-device
parameters against the reference's ``param_shardings`` over
``jax.eval_shape(init_model)``, on (data, model) ∈ {(16, 16), (1, 2),
(1, 4), (2, 2)}, with ``fsdp`` off and on; the decode caches'
``kv_cache_spec`` too. Specs are compared padded with None to the leaf's
ndim (a ``PartitionSpec`` leaves trailing dims out). ``ParamSharding``
is held to its spec: local shapes and slices of a full tensor, and an
``fsdp`` leaf's data and model parts. The train layouts
(``launch.specs.train_layout``: "tp", "fsdp", "zero1") leaf by leaf
against the reference's ``build_dryrun`` train branch's calls of
``param_shardings`` (parameters, then moments with ``fsdp or zero1``,
``physical_experts``), and a padded-expert config whose two expert
counts lay the parameters out otherwise refused.
"""

import dataclasses


import jax
import pytest
import torch

import repro.configs as jconfigs
from repro.models import transformer as jtr
from repro.parallel import sharding as jsh
from repro_torch import configs
from repro_torch.launch import specs as tspecs
from repro_torch.models import transformer as tr
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.mesh import Mesh

MESHES = ((16, 16), (1, 2), (1, 4), (2, 2))


class FakeMesh:
    """The reference's stand-in: ``.shape`` and ``.axis_names``."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


def _mesh(data, model, coord=(0, 0)):
    return Mesh(("data", "model"), (data, model), coord)


def _norm(spec, ndim):
    """A spec as a tuple of ndim entries; a one-axis tuple entry as its
    name (``PartitionSpec`` equates the two)."""
    spec = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)
    return spec + (None,) * (ndim - len(spec))


def spec(path, shape, num_experts=None):
    return _norm(sh._spec_for(path, shape, _mesh(16, 16), num_experts), len(shape))


def test_attention_projections():
    assert spec("blocks/p0/mixer/wq", (4, 2048, 16, 128)) == (None, None, "model", None)
    assert spec("blocks/p0/mixer/wk", (4, 2048, 8, 128)) == (None, None, None, None)
    assert spec("blocks/p0/mixer/wo", (4, 16, 128, 2048)) == (None, "model", None, None)


def test_dense_mlp():
    assert spec("blocks/p0/mlp/w_in", (4, 2048, 8192)) == (None, None, "model")
    assert spec("blocks/p0/mlp/w_out", (4, 8192, 2048)) == (None, "model", None)


def test_moe_expert_sharding_divisible():
    assert spec("blocks/p0/mlp/w_in", (1, 64, 2048, 1408), 64) == (None, "model", None, None)
    assert spec("blocks/p0/mlp/w_out", (1, 64, 1408, 2048), 64) == (None, "model", None, None)


def test_moe_expert_sharding_fallback():
    assert spec("blocks/p0/mlp/w_in", (1, 40, 1536, 512), 40) == (None, None, None, "model")
    assert spec("blocks/p0/mlp/w_out", (1, 40, 512, 1536), 40) == (None, None, "model", None)


def test_router_replicated():
    assert spec("blocks/p0/mlp/router", (1, 2048, 64), 64) == (None, None, None)


def test_vocab_sharding():
    assert spec("embed", (50304, 2048)) == ("model", None)
    assert spec("lm_head", (2048, 50304)) == (None, "model")
    assert spec("embed", (4, 2048, 1536)) == (None, "model", None)
    assert spec("embed", (49155, 1536)) == (None, None)


def test_mamba_projections():
    assert spec("blocks/p0/mixer/in_x", (8, 2560, 5120)) == (None, None, "model")
    assert spec("blocks/p0/mixer/in_B", (8, 2560, 128)) == (None, None, None)
    assert spec("blocks/p0/mixer/A_log", (8, 80)) == (None, "model")
    assert spec("blocks/p0/mixer/out", (8, 5120, 2560)) == (None, "model", None)


def test_norms_replicated():
    assert spec("blocks/p0/norm1/scale", (4, 2048)) == (None, None)


def test_kv_cache_policy():
    sizes = {"data": 16, "model": 16}
    assert sh.kv_cache_spec(sizes, ("data",), 128, 32768, 8) == (("data",), "model", None, None)
    assert sh.kv_cache_spec(sizes, ("data",), 128, 32768, 16) == (("data",), None, "model", None)
    assert sh.kv_cache_spec(sizes, ("data",), 1, 524288, 8) == (None, ("data", "model"), None, None)
    assert sh.kv_cache_spec(sizes, ("data",), 1, 524288, 16) == (None, ("data",), "model", None)
    sizes2 = {"pod": 2, "data": 16, "model": 16}
    assert sh.kv_cache_spec(sizes2, ("pod", "data"), 128, 32768, 16) == (
        ("pod", "data"), None, "model", None)


def _ref_specs(jcfg, data, model, fsdp, monkeypatch):
    """The reference's ``param_shardings`` on a stand-in mesh, its
    ``NamedSharding`` replaced by the spec it would hold."""
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    shapes = jax.eval_shape(lambda k: jtr.init_model(jcfg, k), jax.random.PRNGKey(0))
    tree = jsh.param_shardings(shapes, FakeMesh(data=data, model=model),
                               jcfg.moe.num_experts if jcfg.moe else None, fsdp=fsdp)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        spec_leaf = tree
        for p in path:
            spec_leaf = spec_leaf[p.key]
        out[jsh._path_str(path)] = (_norm(spec_leaf, leaf.ndim), tuple(leaf.shape))
    return out


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_shardings_equal_reference(arch, monkeypatch):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    meta = tr.init_model(cfg, device="meta")
    for data, model in MESHES:
        for fsdp in (False, True):
            want = _ref_specs(jcfg, data, model, fsdp, monkeypatch)
            got = {}
            tree = sh.param_shardings(meta, _mesh(data, model),
                                      cfg.moe.num_experts if cfg.moe else None, fsdp=fsdp)
            sh.tree_map_with_path(lambda p, s: got.__setitem__(
                "/".join(p), _norm(s.spec, len(tr._at(meta, p).shape))), tree)
            assert got == {k: v[0] for k, v in want.items()}, (arch, data, model, fsdp)
            if fsdp and data > 1:  # ZeRO-3 leaves run: their two parts
                plain = sh.param_shardings(meta, _mesh(data, model),
                                           cfg.moe.num_experts if cfg.moe else None)
                sh.tree_map_with_path(lambda p, s: _check_parts(
                    s, tr._at(plain, p), len(tr._at(meta, p).shape), data), tree)


def _check_parts(s, plain, ndim, data):
    """An fsdp sharding is the tensor-parallel one plus the data axes on
    one dimension: its model part is the plain spec, its data part that
    dimension alone."""
    assert _norm(s.model_part().spec, ndim) == _norm(plain.spec, ndim)
    d = s.data_dim()
    data_spec = _norm(s.data_part().spec, ndim)
    assert all(e is None for i, e in enumerate(data_spec) if i != d)
    assert (d is None) == (s.replicas() == plain.replicas())
    if d is not None:
        assert data_spec[d] == "data" and s.replicas() * data == plain.replicas()


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_train_layouts_equal_reference(arch, monkeypatch):
    """``train_layout`` against the reference's train branch of
    ``build_dryrun`` (``specs.py:125-138``): parameters by
    ``param_shardings(fsdp=fsdp)``, moments by ``fsdp or zero1``, both with
    ``physical_experts``; on the file's meshes, leaf by leaf."""
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    shapes = jax.eval_shape(lambda k: jtr.init_model(jcfg, k), jax.random.PRNGKey(0))
    nexp = jcfg.moe.physical_experts if jcfg.moe else None
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    for data, model in MESHES:
        fake = FakeMesh(data=data, model=model)
        for layout, fsdp, zero1 in (("tp", False, False), ("fsdp", True, False),
                                    ("zero1", False, True)):
            want_p = jsh.param_shardings(shapes, fake, nexp, fsdp=fsdp)
            want_m = jsh.param_shardings(shapes, fake, nexp, fsdp=fsdp or zero1)
            got = tspecs.train_layout(cfg, _mesh(data, model), layout)
            assert got.name == layout
            for path, leaf in flat:
                keys = [p.key for p in path]
                for want, tree in ((want_p, got.params), (want_m, got.moments)):
                    w = want
                    for k in keys:
                        w = w[k]
                    assert _norm(tr._at(tree, keys).spec, leaf.ndim) == _norm(w, leaf.ndim), \
                        (arch, data, model, layout, keys)
            blocks = got.blocks()
            sh.tree_map_with_path(lambda p, b: _check_block(
                b, tr._at(got.params, p), tr._at(got.moments, p), layout), blocks)


def _check_block(b, p, m, layout):
    """ZeRO-1's blocks: the data part of a moment cut over data axes that
    its parameter is not cut over; none elsewhere (and none but zero1)."""
    if layout == "zero1" and m.data_dim() is not None:
        assert b is not None and b.data_dim() == m.data_dim() and not b.model_part().axes()
    else:
        assert b is None


def test_train_layout_refuses_padded_experts_that_differ():
    """A padded-expert config (granite's 40 experts padded to 48, the
    reference's moe-pad48 perf variant) on a 16-rank "model" axis:
    ``physical_experts`` (``specs.py``) shards the experts, ``num_experts``
    (``train.py``) their F; the two layouts differ, so ``train_layout``
    raises, naming the two; an unpadded config and a mesh where both
    agree pass."""
    cfg = configs.get_config("granite-moe-3b-a800m")
    padded = cfg.replace(moe=dataclasses.replace(cfg.moe, padded_experts=48))
    with pytest.raises(ValueError, match="physical_experts.*num_experts"):
        tspecs.train_layout(padded, _mesh(1, 16), "tp")
    tspecs.train_layout(cfg, _mesh(1, 16), "tp")
    tspecs.train_layout(padded, _mesh(2, 1), "zero1")
    with pytest.raises(ValueError, match="layout"):
        tspecs.train_layout(cfg, _mesh(2, 1), "zero3")


class _Named:
    """Stands in for ``NamedSharding`` on the stand-in mesh."""

    def __init__(self, mesh, spec):
        self.spec = spec


@pytest.mark.parametrize("arch", ["gemma3-12b", "qwen3-14b", "jamba-v0.1-52b"])
def test_kv_cache_specs_equal_reference(arch, monkeypatch):
    """The port's ``kv_cache_spec`` against the reference's over meshes,
    batches, cache lengths and KV heads; ``decode_state_shardings`` leaf
    by leaf of the stacked decode state."""
    from repro.launch import specs as jspecs

    monkeypatch.setattr(jsh, "NamedSharding", _Named)
    monkeypatch.setattr(jspecs, "NamedSharding", _Named)
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    for data, model in MESHES:
        sizes = {"data": data, "model": model}
        for batch in (1, 2, 16, 128):
            for cache_len in (8, 4096, 32768, 524288):
                for kv in (cfg.num_kv_heads, 16, 40):
                    want = jsh.kv_cache_spec(sizes, ("data",), batch, cache_len, kv)
                    got = sh.kv_cache_spec(sizes, ("data",), batch, cache_len, kv)
                    assert _norm(got, 4) == _norm(want, 4)
        fake = FakeMesh(data=data, model=model)
        for batch, cache_len in ((1, 4096), (16, 4096)):
            state = jax.eval_shape(lambda: jtr.init_decode_state(jcfg, batch, cache_len))
            tree = jspecs.decode_state_shardings(jcfg, fake, state)
            got = tspecs.decode_state_shardings(cfg, _mesh(data, model),
                                                tspecs.decode_state_specs(cfg, batch, cache_len))
            for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
                s = tree
                for p in path:
                    s = s[p.key] if hasattr(p, "key") else getattr(s, p.name)
                key, name = path[0].key, path[-1].name
                assert _norm(got[key][name], leaf.ndim) == _norm(s.spec, leaf.ndim), \
                    (arch, data, model, key, name)


def test_param_sharding_local_blocks():
    """A ParamSharding's local shape and block: rank (d, m) of a (2, 2)
    mesh holds block m of a model-sharded dim, block 2d+m of one sharded
    over (data, model)."""
    t = torch.arange(8 * 6).reshape(8, 6)
    for d in range(2):
        for m in range(2):
            mesh = _mesh(2, 2, (d, m))
            s = sh.ParamSharding(mesh, ("model", None))
            assert s.local_shape((8, 6)) == (4, 6)
            assert torch.equal(s.local(t), t[4 * m:4 * m + 4])
            s2 = sh.ParamSharding(mesh, (("data", "model"), None))
            i = 2 * d + m
            assert s2.local_shape((8, 6)) == (2, 6)
            assert torch.equal(s2.local(t), t[2 * i:2 * i + 2])
            assert sh.ParamSharding(mesh, ()).local_shape((8, 6)) == (8, 6)
