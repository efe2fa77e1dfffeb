"""The end-to-end paper pipeline on the CPU: the mirror of
``tests/test_e2e_diffusion.py``'s three tests on the port's own
training and solves. An MLP score net (hidden 96, depth 3) trained 400
steps at batch 256 (EMA 0.99) on the two-mode mixture (means ±1.5, std
0.3); adaptive at eps_rel 0.05 and EM at 500 steps each within
w2_gaussianized 0.35 of 1024 data draws; adaptive no worse than EM at
half its NFE in steps + 0.15; and the paper's "rarely rejects" at image
dimensionality, (32, 3072) on the closed-form score, below 5 %.
"""

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import common as bench
from repro_torch.core.sampling import sample
from repro_torch.core.sde import VPSDE
from repro_torch.data.images import GMM2D
from repro_torch.models.score_unet import MLPScoreConfig, init_mlp_score

torch.set_num_threads(2)

GMM = GMM2D(means=((-1.5, 0.0), (1.5, 0.0)), std=0.3, weights=(0.5, 0.5))


@pytest.fixture(scope="module")
def trained():
    model = init_mlp_score(MLPScoreConfig(dim=2, hidden=96, depth=3),
                           torch.Generator().manual_seed(0))
    net = bench.train_mlp("vp", 400, 0, "cpu", batch=256, model=model, data=GMM,
                          ema_decay=0.99)
    data = GMM.sample(torch.Generator().manual_seed(9), 1024).numpy()
    return net, data


def _w2(res, data) -> float:
    return bench.w2_gaussianized(res.x.numpy(), data)


@pytest.mark.parametrize("method,kw", [("adaptive", dict(eps_rel=0.05)),
                                       ("em", dict(n_steps=500))])
def test_trained_sampling_matches_data(trained, method, kw):
    net, data = trained
    res = sample(net.sde, net.score_fn, (1024, 2), seed=0, method=method, device="cpu", **kw)
    assert torch.isfinite(res.x).all()
    assert _w2(res, data) < 0.35, (method, _w2(res, data))


def test_adaptive_beats_em_at_matched_nfe(trained):
    """The paper's same-budget comparison: at the adaptive solver's NFE,
    EM with that many score evaluations is no better."""
    net, data = trained
    ad = sample(net.sde, net.score_fn, (1024, 2), seed=0, method="adaptive", eps_rel=0.05,
                device="cpu")
    nfe = int(float(ad.mean_nfe))
    em = sample(net.sde, net.score_fn, (1024, 2), seed=0, method="em",
                n_steps=max(nfe // 2, 2), device="cpu")
    assert _w2(ad, data) <= _w2(em, data) + 0.15, (_w2(ad, data), _w2(em, data), nfe)


def test_rejection_rate_low_at_image_dimensionality():
    """The ℓ2 scaled error concentrates at CIFAR's dimensionality: the
    solver rejects below 5 % of its steps at d = 3072."""
    sde = VPSDE()

    def score(x, t):
        m, std = sde.marginal(t)
        m, std = m[:, None], std[:, None]
        return -(x - m * 0.3) / (m * m * 0.25 + std * std)

    res = sample(sde, score, (32, 3072), seed=0, method="adaptive", eps_rel=0.05, device="cpu")
    rej = float(res.rejected.sum()) / float((res.accepted + res.rejected).sum())
    assert rej < 0.05, rej
    assert np.isfinite(res.x.numpy()).all()
