"""Checkpoints cross the packages bit-exactly: the reference's
``save_checkpoint`` → the port's ``restore_checkpoint`` (and back),
including bf16 leaves stored as uint16 views.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.core.precision import resolve_policy as jpolicy
from repro.models import dit as jdit
from repro_torch.checkpoint import io as tio
from repro_torch.models import dit as tdit

from test_torch_dit import JCFG, TCFG, _inputs, liven

torch.set_num_threads(2)


def _bits(a):
    """Raw bit pattern of a numpy array or tensor (bf16 included)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy().view(np.uint8)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.uint8)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("preset", ["fp32", "bf16_full"])
def test_reference_checkpoint_restores_bit_exact(preset, tmp_path):
    params = jpolicy(preset).cast_params(jdit.init_dit(JCFG, jax.random.PRNGKey(0)))
    tree = jax.tree_util.tree_map(np.asarray, params)
    tree["step_count"] = np.arange(3, dtype=np.int32)
    jio.save_checkpoint(str(tmp_path), 7, tree, metadata={"arch": "small"})
    restored, step = tio.restore_checkpoint(str(tmp_path))
    assert step == 7
    want, got = _flat(tree), _flat(restored)
    assert set(got) == {k for k in want if not isinstance(want[k], dict)}
    for key, value in want.items():
        assert np.array_equal(_bits(got[key]), _bits(value)), key
    if preset == "bf16_full":
        assert got["patch_in"].dtype == torch.bfloat16
    # the restored tree loads into the port's DiT and runs
    restored.pop("step_count")
    model = tdit.params_from_jax(restored, TCFG)
    assert model.patch_in.dtype == (torch.bfloat16 if preset == "bf16_full"
                                    else torch.float32)


def test_port_checkpoint_restores_in_reference(tmp_path):
    """The port writes the same format: the reference restores it."""
    params = liven(jax.tree_util.tree_map(
        np.asarray, jdit.init_dit(JCFG, jax.random.PRNGKey(1))))
    model = tdit.params_from_jax(params, TCFG).to(torch.bfloat16)
    tree = {"patch_in": model.patch_in.data, "pos_emb": model.pos_emb.data,
            "nested": {"ada": model.blocks[0].ada.data,
                       "counter": torch.arange(4, dtype=torch.int32)}}
    tio.save_checkpoint(str(tmp_path), 3, tree)
    like = {"patch_in": jnp.zeros((48, 64), jnp.bfloat16),
            "pos_emb": jnp.zeros((16, 64), jnp.bfloat16),
            "nested": {"ada": jnp.zeros((64, 384), jnp.bfloat16),
                       "counter": jnp.zeros((4,), jnp.int32)}}
    restored, step = jio.restore_checkpoint(str(tmp_path), like)
    assert step == 3
    for key, value in _flat(tree).items():
        assert np.array_equal(_bits(_flat(restored)[key]), _bits(value)), key
    back, _ = tio.restore_checkpoint(str(tmp_path))
    x, t = _inputs()
    assert torch.equal(back["patch_in"], model.patch_in.data)
    assert model(torch.from_numpy(x).bfloat16(), torch.from_numpy(t)).isfinite().all()


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tio.restore_checkpoint(str(tmp_path))
