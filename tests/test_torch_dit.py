"""Port ↔ reference parity: the DiT score network.

Parameters come from the reference's ``init_dit``, livened (the leaves it
initialises to zero get a seeded numpy perturbation, since a fresh DiT
returns exactly 0 and every comparison would pass vacuously), and are
carried across by ``params_from_jax``. Bounds are the ``TOLS`` of
``tests/test_score_hotpath.py``: fp32 1e-4 (matmul and attention sums in
another order), bf16 presets 5e-2 (bf16 matmul inputs, roundings at
other places in the two frameworks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.precision import resolve_policy as jpolicy
from repro.core.sde import VPSDE as JVPSDE
from repro.models import dit as jdit
from repro_torch.core.precision import resolve_policy
from repro_torch.core.sde import VPSDE
from repro_torch.models import dit as tdit

torch.set_num_threads(2)

TOLS = {"fp32": dict(rtol=1e-4, atol=1e-4),
        "bf16": dict(rtol=5e-2, atol=5e-2),
        "bf16_full": dict(rtol=5e-2, atol=5e-2)}
JCFG = jdit.DiTConfig(image_size=16, patch=4, d_model=64, num_layers=2,
                      num_heads=4, d_ff=128)
TCFG = tdit.DiTConfig(image_size=16, patch=4, d_model=64, num_layers=2,
                      num_heads=4, d_ff=128)


def liven(tree, seed=7, scale=0.02):
    """numpy tree with the zero-init leaves replaced by scale·N(0, 1)."""
    rng = np.random.default_rng(seed)
    bump = lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32)
    tree["layers"]["ada"] = bump(tree["layers"]["ada"])
    tree["layers"]["ada_b"] = bump(tree["layers"]["ada_b"])
    for name in ("final_ada", "final_ada_b", "patch_out"):
        tree[name] = bump(tree[name])
    return tree


def reference_params(cfg=JCFG, livened=True):
    tree = jax.tree_util.tree_map(np.asarray, jdit.init_dit(cfg, jax.random.PRNGKey(0)))
    return liven(tree) if livened else tree


def _inputs(B=2, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 16, 16, 3)).astype(np.float32),
            np.linspace(0.1, 1.0, B).astype(np.float32))


def _f32(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else a, np.float32)


def test_fresh_dit_is_zero_and_livened_is_not():
    x, t = _inputs()
    fresh = tdit.params_from_jax(reference_params(livened=False), TCFG)
    assert not fresh(torch.from_numpy(x), torch.from_numpy(t)).any()
    live = tdit.params_from_jax(reference_params(), TCFG)
    out = live(torch.from_numpy(x), torch.from_numpy(t))
    assert float(out.abs().mean()) > 1e-2


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("preset", sorted(TOLS))
def test_forward_and_score_match_reference(preset, use_flash):
    tree = reference_params()
    x, t = _inputs()
    jcfg = dataclasses.replace(JCFG, use_flash=use_flash)
    tcfg = dataclasses.replace(TCFG, use_flash=use_flash)
    jp, tp = jpolicy(preset), resolve_policy(preset)
    jparams = jp.cast_params(jax.tree_util.tree_map(jnp.asarray, tree))
    want = jdit.dit_forward(jparams, jnp.asarray(x), jnp.asarray(t), jcfg, policy=jp)
    model = tdit.params_from_jax(tree, tcfg).to(tp.param)
    got = tdit.dit_forward(model, torch.from_numpy(x), torch.from_numpy(t), policy=tp)
    assert got.dtype == tp.compute and got.shape == x.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **TOLS[preset])
    assert np.abs(_f32(got)).mean() > 1e-2  # the livened net carries signal

    jscore = jdit.make_score_fn(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                                JVPSDE(), policy=jp)
    tscore = tdit.make_score_fn(tdit.params_from_jax(tree, tcfg), VPSDE(), policy=tp)
    want = jscore(jnp.asarray(x), jnp.asarray(t))
    got = tscore(torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == tp.state
    np.testing.assert_allclose(_f32(got), _f32(want), **TOLS[preset])


def test_class_conditional_null_row():
    jcfg = dataclasses.replace(JCFG, num_classes=3)
    tcfg = dataclasses.replace(TCFG, num_classes=3)
    tree = liven(jax.tree_util.tree_map(
        np.asarray, jdit.init_dit(jcfg, jax.random.PRNGKey(1))))
    x, t = _inputs()
    y = np.array([2, -1], np.int32)
    want = jdit.dit_forward(jax.tree_util.tree_map(jnp.asarray, tree),
                            jnp.asarray(x), jnp.asarray(t), jcfg, y=jnp.asarray(y))
    model = tdit.params_from_jax(tree, tcfg)
    got = model(torch.from_numpy(x), torch.from_numpy(t), y=torch.from_numpy(y))
    np.testing.assert_allclose(_f32(got), _f32(want), **TOLS["fp32"])
    null = model(torch.from_numpy(x), torch.from_numpy(t), y=torch.tensor([3, 3]))
    assert torch.equal(null[1], got[1])  # a negative label is the null row


def test_port_init_matches_reference_layout():
    """The port's own init draws every leaf the reference draws, with the
    reference's shapes, and keeps the zero-init leaves at zero."""
    model = tdit.init_dit(TCFG, torch.Generator().manual_seed(0))
    ref_tree = reference_params(livened=False)
    ported = tdit.params_from_jax(ref_tree, TCFG)
    for (name, p), (_, q) in zip(model.named_parameters(), ported.named_parameters()):
        assert p.shape == q.shape, name
        leaf = name.split(".")[-1]
        if leaf in tdit.ZERO_INIT_LAYER + tdit.ZERO_INIT_TOP:
            assert not p.any(), name
        else:
            assert p.std() > 0, name
    x, t = _inputs()
    assert not model(torch.from_numpy(x), torch.from_numpy(t)).any()
    tdit.liven_zero_init(model, torch.Generator().manual_seed(1))
    assert model(torch.from_numpy(x), torch.from_numpy(t)).abs().mean() > 1e-2
    assert tdit.param_count(model) == sum(a.size for a in jax.tree_util.tree_leaves(ref_tree))


def test_params_from_jax_rejects_a_wrong_tree():
    tree = reference_params()
    with pytest.raises(ValueError):
        tdit.params_from_jax(tree, dataclasses.replace(TCFG, num_layers=3))
    tree["patch_out"] = tree["patch_out"][:, :5]
    with pytest.raises(ValueError):
        tdit.params_from_jax(tree, TCFG)


def test_params_from_jax_takes_a_bf16_tree():
    """A bf16_full reference tree (ml_dtypes bfloat16 numpy leaves) loads
    bit for bit: the same bits as the port casting the fp32 tree."""
    tree = reference_params()
    bf16_tree = jax.tree_util.tree_map(
        np.asarray, jpolicy("bf16_full").cast_params(
            jax.tree_util.tree_map(jnp.asarray, tree)))
    model = tdit.params_from_jax(bf16_tree, TCFG)
    want = tdit.params_from_jax(tree, TCFG).to(torch.bfloat16)
    assert model.patch_in.dtype == torch.bfloat16
    for (name, p), (_, q) in zip(model.named_parameters(), want.named_parameters()):
        assert torch.equal(p.view(torch.int16), q.view(torch.int16)), name
