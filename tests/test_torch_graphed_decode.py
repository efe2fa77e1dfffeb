"""The LM decode state kept in place, and the graphed serve step's
contract, on the CPU.

``decode_step`` writes each Mamba2 layer's conv and SSM state into its
view of the stacked state, as the ring-buffer KV caches already were, so
state' is state, every tensor where it was (held here by ``data_ptr``),
with the values the step computes (held bitwise against the states
``mamba_decode`` returns). That is what lets ``launch.steps``'s
``GraphedServeStep`` replay one captured step on the card, where
``chip_smoke.py`` gates it bitwise against the eager step; here the step
is the eager function, and the graphed step's refusals are checked.
"""

import copy

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch.serve import greedy_decode, serve_batch
from repro_torch.launch.steps import GraphedServeStep, make_serve_step
from repro_torch.models import init_decode_state, init_model
from repro_torch.models import transformer as tr
from repro_torch.serving.scheduler import ContinuousBatcher, Request

torch.set_num_threads(2)

ARCHS = ("mamba2-2.7b", "jamba-v0.1-52b", "gemma3-12b", "deepseek-moe-16b",
         "llama-3.2-vision-90b", "musicgen-medium")


def _tensors(tree) -> list:
    return [t for t in torch.utils._pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _setup(arch, B=2, P=3):
    cfg = configs.get_config(arch).scaled_down()
    params = init_model(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(1)
    shape = (B, P) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1 else ())
    prompts = torch.randint(0, cfg.vocab_size, shape, generator=g)
    cross = None
    if cfg.vision_dim:
        cross = torch.randn((B, cfg.num_patches, cfg.vision_dim), generator=g).to(
            getattr(torch, cfg.dtype))
    return cfg, params, prompts, cross


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_is_written_in_place(arch, monkeypatch):
    cfg, params, prompts, cross = _setup(arch)
    state = init_decode_state(cfg, prompts.shape[0], 8, device="cpu")
    ptrs = [t.data_ptr() for t in _tensors(state)]
    returned = []
    real = tr.mamba_decode

    def spy(*a, **kw):
        y, s_new = real(*a, **kw)
        returned.append(copy.deepcopy(s_new))
        return y, s_new

    monkeypatch.setattr(tr, "mamba_decode", spy)
    for i in range(prompts.shape[1]):
        returned.clear()
        logits, out = tr.decode_step(params, prompts[:, i:i + 1], state, cfg,
                                     cross_embeds=cross)
        assert out is state
        assert [t.data_ptr() for t in _tensors(out)] == ptrs
        # layer r of position p holds the state its mamba_decode returned
        layers = [(f"p{p}", r) for r in range(cfg.num_repeats)
                  for p, mix in enumerate(cfg.mixer_pattern) if mix == "M"]
        assert len(returned) == len(layers)
        for (p, r), s_new in zip(layers, returned):
            assert torch.equal(state[p].conv[r], s_new.conv)
            assert torch.equal(state[p].ssm[r], s_new.ssm)
        assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_is_serve_batch(arch):
    cfg, params, prompts, cross = _setup(arch)
    stats = {}
    toks = serve_batch(cfg, params, prompts, gen_len=3, cross_embeds=cross, device="cpu",
                       stats=stats)
    # the CPU's step is eager
    assert stats == {"captures": 0, "build_s": 0.0, "graphed": False}
    step = make_serve_step(cfg, device="cpu")
    assert not isinstance(step, GraphedServeStep)
    state = init_decode_state(cfg, prompts.shape[0], prompts.shape[1] + 3, device="cpu")
    ptrs = [t.data_ptr() for t in _tensors(state)]
    got = greedy_decode(step, params, prompts, state, gen_len=3, cross_embeds=cross)
    assert torch.equal(got, toks)
    assert [t.data_ptr() for t in _tensors(state)] == ptrs


def test_graphed_step_refuses_moe_routing():
    """Routing records are a Python list a graph cannot append to: the
    graphed step raises before anything runs, and the eager step records
    them."""
    cfg, params, prompts, _ = _setup("deepseek-moe-16b")
    eager = make_serve_step(cfg, device="cpu")
    graphed = GraphedServeStep(eager, torch.device("cuda"))
    state = init_decode_state(cfg, prompts.shape[0], 4, device="cpu")
    with pytest.raises(ValueError, match="moe_routing"):
        graphed(params, {"tokens": prompts[:, :1]}, state, moe_routing=[])
    assert graphed.captures == 0 and graphed.eager is eager
    routing = []
    toks, out = graphed.eager(params, {"tokens": prompts[:, :1]}, state, moe_routing=routing)
    assert routing and out is state and toks.shape == (prompts.shape[0], 1)


def test_serve_step_under_a_mesh_and_on_meta_stays_eager():
    cfg = configs.get_config("gemma3-12b").scaled_down()
    assert not isinstance(make_serve_step(cfg, device="meta"), GraphedServeStep)


def test_continuous_batcher_reports_no_capture_on_the_cpu():
    cfg, params, _, _ = _setup("gemma3-12b")
    b = ContinuousBatcher(cfg, params, slots=2, cache_len=32, device="cpu")
    for i in range(3):
        b.submit(Request(uid=i, prompt=np.arange(2) + i, max_new_tokens=2))
    done = b.run_to_completion()
    assert sorted(done) == [0, 1, 2] and all(len(r.output) == 2 for r in done.values())
    assert b.captures == 0 and b.build_s == 0.0
