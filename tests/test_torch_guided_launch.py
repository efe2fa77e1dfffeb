"""Port ↔ reference parity: the sampling launcher's controlled generation
(``repro_torch.launch.sample``: ``demo_cfg``, ``demo_inpaint``,
``--cfg-scale``, ``--inpaint``) and the dry run's ``--skip-existing``.

* ``demo_cfg`` and ``demo_inpaint`` solve on the reference demos' 16 px,
  2-layer DiT (class-conditional for CFG) with the reference's weights
  (livened, carried over by ``params_from_jax``), its prior and its
  noise (``ReferenceNoise``: z, then inpainting's projection draw),
  against the reference's ``sample(..., config=AdaptiveConfig(
  conditioner=...), cond=...)`` on the same key: per-sample nfe,
  accepted, rejected and the iterations exactly equal, x within the
  bounds of ``tests/test_torch_adaptive.py``; observed pixels exactly
  ``observed`` in both packages. The port's checkerboard is the
  reference demo's mask and observed values bit for bit.
* ``main`` with ``--cfg-scale`` / ``--inpaint`` on the CPU returns its
  record (inpainting's residual exactly 0), ``--cfg-scale`` wins over
  ``--inpaint`` as in the reference, and a run without either flag is
  bitwise a ``sample()`` of the seeded net.
* ``serve_diffusion`` with ``cfg_scale`` / ``inpaint``: the
  device-resident drain bitwise the host-driven one, a request bitwise
  its solo run (``uids=[u]``), observed pixels exact.
* ``launch.dryrun --skip-existing`` skips a record already in ``--out``
  with the reference's message and counts nothing on meta tensors.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import guidance as jgd
from repro.core import sampling as jsampling
from repro.core import sde as jsde
from repro.models import dit as jdit
from repro_torch.core.sampling import sample
from repro_torch.core.sde import VPSDE
from repro_torch.launch import dryrun
from repro_torch.launch import serve as tserve
from repro_torch.launch import sample as launcher
from repro_torch.models import dit as tdit

from test_torch_adaptive import ReferenceNoise, _assert_same_solve
from test_torch_dit import liven

jad = importlib.import_module("repro.core.solvers.adaptive")

torch.set_num_threads(2)

SHAPE = (8, 16, 16, 3)
JNET = jdit.DiTConfig(image_size=16, patch=4, d_model=96, num_layers=2, num_heads=4, d_ff=256)
#: the CLI runs: a short solve of the default arch
CLI = ["--device", "cpu", "--batch", "2", "--max-iters", "4"]


def _reference_demo_payload():
    """``demo_inpaint``'s mask and observed values, as the reference builds them."""
    yy, xx = jnp.mgrid[:16, :16]
    mask = jnp.broadcast_to((((yy // 4 + xx // 4) % 2) == 0)[None, :, :, None],
                            SHAPE).astype(jnp.float32)
    observed = jnp.broadcast_to(jnp.linspace(-0.5, 0.5, 16)[None, :, None, None], SHAPE)
    return mask, observed


@pytest.mark.parametrize("kind", ["cfg", "inpaint"])
def test_demo_solves_match_reference(kind):
    """The demo's solve on the reference's net, prior and noise takes the
    reference's decisions; inpainting pins the observed pixels exactly."""
    jnet = dataclasses.replace(JNET, num_classes=10) if kind == "cfg" else JNET
    tree = liven(jax.tree_util.tree_map(np.asarray, jdit.init_dit(jnet, jax.random.PRNGKey(0))))
    js = jsde.VPSDE()
    jscore = jdit.make_score_fn(jax.tree_util.tree_map(jnp.asarray, tree), jnet, js)
    if kind == "cfg":
        jc, jcond = jgd.class_conditional(jnp.arange(8) % 10, 1.5)
    else:
        mask, observed = _reference_demo_payload()
        jc, jcond = jgd.inpaint(mask, observed)
    key = jax.random.PRNGKey(0)
    want = jax.jit(lambda k: jsampling.sample(
        js, jscore, SHAPE, k, method="adaptive",
        config=jad.AdaptiveConfig(eps_rel=0.05, conditioner=jc), cond=jcond))(key)
    k_prior, k_solve = jax.random.split(key)
    prior = torch.from_numpy(np.array(js.prior_sample(k_prior, SHAPE)))

    net = dataclasses.replace(launcher.DEMO_DIT, num_classes=jnet.num_classes, use_flash=True)
    model = tdit.params_from_jax(tree, net)
    demo = launcher.demo_cfg if kind == "cfg" else launcher.demo_inpaint
    args = (1.5,) if kind == "cfg" else ()
    rec = demo(*args, device="cpu", fused=True, model=model, prior=prior,
               noise_fn=ReferenceNoise(k_solve))
    got = rec["result"]
    _assert_same_solve(got, want)
    assert rec["finite"] and rec["shape"] == list(SHAPE)
    assert rec["conditioner"] == ("cfg:1.5" if kind == "cfg" else "inpaint")
    if kind == "inpaint":
        m = np.asarray(mask) > 0
        obs = np.asarray(observed)
        np.testing.assert_array_equal(got.x.numpy()[m], obs[m])
        np.testing.assert_array_equal(np.asarray(want.x)[m], obs[m])
        assert rec["observed_residual"] == 0.0
    else:
        assert rec["observed_residual"] is None


def test_checkerboard_is_the_reference_payload():
    mask, observed = _reference_demo_payload()
    tm, to = launcher.checkerboard(*SHAPE[:2], SHAPE[3])
    assert tm.dtype == to.dtype == torch.float32
    np.testing.assert_array_equal(tm.numpy(), np.asarray(mask))
    np.testing.assert_array_equal(to.numpy(), np.asarray(observed))
    assert float(tm.mean()) == 0.5


def test_cli_guided_runs_and_precedence():
    """``--cfg-scale`` and ``--inpaint`` each run one adaptive solve of the
    default arch made class-conditional or inpainted; with both flags
    ``--cfg-scale`` wins, bit for bit the run with it alone."""
    (cfg,) = launcher.main(CLI + ["--cfg-scale", "1.5"])
    (inp,) = launcher.main(CLI + ["--inpaint"])
    (both,) = launcher.main(CLI + ["--inpaint", "--cfg-scale", "1.5"])
    assert cfg["method"] == inp["method"] == "adaptive"
    assert cfg["conditioner"] == both["conditioner"] == "cfg:1.5"
    assert inp["conditioner"] == "inpaint"
    assert cfg["finite"] and inp["finite"] and cfg["shape"] == [2, 32, 32, 3]
    assert inp["observed_residual"] == 0.0 and cfg["observed_residual"] is None
    assert torch.equal(both["result"].x, cfg["result"].x)
    assert torch.equal(both["result"].nfe, cfg["result"].nfe)
    assert not torch.equal(inp["result"].x, cfg["result"].x)
    assert cfg["params"] > inp["params"]  # the label table: (10 + 1) × d_model
    mask, observed = launcher.checkerboard(2, 32, 3)
    pinned = inp["result"].x[mask > 0]
    assert torch.equal(pinned, observed[mask > 0])


def test_cli_plain_run_is_unchanged():
    """Without the flags the launcher runs adaptive then EM, as before:
    the adaptive record's sample is bitwise ``sample()`` of the seeded,
    livened net, and the record names no conditioner."""
    recs = launcher.main(CLI)
    assert [r["method"] for r in recs] == ["adaptive", "em"]
    assert "conditioner" not in recs[0] and "philox_normal" not in recs[0]["launches"]
    _, _, score = launcher.build_score("cifar_dit", flash=False, precision="fp32", seed=0,
                                       liven_seed=0, device="cpu")
    want = sample(VPSDE(), score, (2, 32, 32, 3), seed=0, device="cpu", eps_rel=0.05,
                  max_iters=4, use_fused_kernel=False, precision="fp32")
    got = recs[0]["result"]
    assert torch.equal(got.x, want.x) and torch.equal(got.nfe, want.nfe)


def test_guided_runs_refuse_a_mesh_or_a_baseline():
    with pytest.raises(ValueError, match="one conditioner"):
        launcher.guidance(2, launcher.DEMO_DIT, cfg_scale=1.0, inpaint=True)
    with pytest.raises(ValueError, match="Algorithm-1"):
        launcher.run("cifar_dit", batch=2, device="cpu", method="em", n_steps=2, inpaint=True)


def test_cli_guided_refused_under_torchrun(monkeypatch, capsys):
    monkeypatch.setenv("WORLD_SIZE", "2")
    for flag in (["--cfg-scale", "1.5"], ["--inpaint"]):
        with pytest.raises(SystemExit):
            launcher.main(CLI + flag)
        assert "torchrun" in capsys.readouterr().err


def test_dryrun_skip_existing(tmp_path, monkeypatch, capsys):
    """A record already in ``--out`` is skipped with the reference's message
    and not counted again; without the flag it is counted."""
    calls = []
    monkeypatch.setattr(dryrun, "run_one", lambda arch, shape, **kw: calls.append(
        (arch, shape, kw["mesh"])))
    (tmp_path / "olmo-1b_train_4k_1card.json").write_text("{}")
    args = ["--arch", "olmo-1b", "--shape", "train_4k", "--out", str(tmp_path)]
    dryrun.main(args + ["--skip-existing"])
    assert calls == []
    assert "[olmo-1b × train_4k × 1card] cached, skipping" in capsys.readouterr().out
    dryrun.main(args)
    dryrun.main(["--arch", "olmo-1b", "--shape", "train_4k", "--multi-pod", "--skip-existing",
                 "--out", str(tmp_path)])
    assert calls == [("olmo-1b", "train_4k", "1card"), ("olmo-1b", "train_4k", "2pod")]


@pytest.mark.parametrize("guide", [dict(cfg_scale=1.5), dict(inpaint=True)], ids=["cfg", "inpaint"])
def test_served_guided_requests_are_their_solo_runs(guide):
    """``serve_diffusion`` with a conditioner on both drivers: the
    device-resident drain is bitwise the host-driven one, a request is
    bitwise the same request served alone (``uids=[u]``), and inpainted
    requests hold their observed pixels exactly."""
    kw = dict(slots=2, requests=4, device="cpu", **guide)
    host = tserve.serve_diffusion(**kw)["delivered"]
    resident = tserve.serve_diffusion(device_resident=True, **kw)["delivered"]
    solo = tserve.serve_diffusion(uids=[3], **kw)["delivered"]
    assert sorted(host) == sorted(resident) == list(range(4)) and list(solo) == [3]
    for u, r in host.items():
        assert resident[u].nfe == r.nfe
        np.testing.assert_array_equal(resident[u].result, r.result)
        assert np.isfinite(r.result).all()
        if "mask" in (r.cond or {}):
            m = np.asarray(r.cond["mask"]) > 0
            np.testing.assert_array_equal(r.result[m], np.asarray(r.cond["observed"])[m])
    assert solo[3].nfe == host[3].nfe
    np.testing.assert_array_equal(solo[3].result, host[3].result)
