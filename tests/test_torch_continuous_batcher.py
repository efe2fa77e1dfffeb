"""Port ↔ reference parity: ``serving.ContinuousBatcher``, greedy
continuous-batching decode of an attention LM over a fixed slot batch.

Two models: the reference's own 2-layer test model
(``tests/test_serving_scheduler.py:18``, global attention, GQA 4:2) and
gemma3-12b's ``scaled_down()`` (five sliding-window layers of window 16
and a global one), whose requests run past the window. The reference's
``init_model`` draws the weights and ``params_from_jax`` carries them
across; prompts are numpy draws.

Against the reference's batcher on the same requests: every request's
tokens, the finishing order, the step count and ``wasted_step_fraction``
exactly equal (greedy tokens from logits within the LM bound, 2e-4, of
each other). Then the reference's three scheduler tests on the port
alone: batched ≡ solo decoding, no leakage through a reused slot, EOS.
"""

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import ModelConfig as JModelConfig
from repro.models import init_model as jinit_model
from repro.serving import scheduler as jsched
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import ModelConfig, decode_step, init_decode_state
from repro_torch.models import transformer as tr
from repro_torch.serving.scheduler import ContinuousBatcher, Request

torch.set_num_threads(2)

TINY = dict(name="t", arch_type="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=61)


def _build(name):
    if name == "tiny":
        jcfg, cfg, key = JModelConfig(**TINY), ModelConfig(**TINY), jax.random.PRNGKey(3)
    else:
        jcfg = jconfigs.get_config(name).scaled_down()
        cfg = configs.get_config(name).scaled_down()
        key = jax.random.PRNGKey(4)
    jparams = jinit_model(jcfg, key)
    params = tr.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def tiny():
    return _build("tiny")


def _requests(vocab, lens, news, seed=0, eos=None):
    rng = np.random.RandomState(seed)
    return [(uid, rng.randint(0, vocab, size=n).astype(np.int32), m, eos)
            for uid, (n, m) in enumerate(zip(lens, news))]


def _run(module, cfg, params, reqs, slots, cache_len, **kw):
    b = module.ContinuousBatcher(cfg, params, slots=slots, cache_len=cache_len, **kw)
    for uid, p, m, eos in reqs:
        b.submit(module.Request(uid=uid, prompt=p, max_new_tokens=m, eos_id=eos))
    done = b.run_to_completion()
    return b, done


class _PortModule:
    ContinuousBatcher = staticmethod(lambda *a, **k: ContinuousBatcher(*a, device="cpu", **k))
    Request = Request


@pytest.mark.parametrize("name,lens,news,slots,cache_len", [
    ("tiny", (3, 5, 2, 4, 3, 6), (4, 3, 5, 2, 4, 3), 2, 64),
    ("gemma3-12b", (9, 4, 12, 6, 3, 10, 7, 5), (14, 6, 9, 12, 5, 8, 11, 7), 3, 96),
], ids=["tiny", "gemma3_window"])
def test_batcher_matches_reference(name, lens, news, slots, cache_len):
    jcfg, cfg, jparams, params = _build(name)
    reqs = _requests(cfg.vocab_size, lens, news)
    jb, jdone = _run(jsched, jcfg, jparams, reqs, slots, cache_len)
    b, done = _run(_PortModule, cfg, params, reqs, slots, cache_len)
    assert list(done) == list(jdone)  # finishing order
    for uid in jdone:
        assert done[uid].output == jdone[uid].output, uid
        assert done[uid].done
    assert (b.total_steps, b.useful_steps) == (jb.total_steps, jb.useful_steps)
    assert b.wasted_step_fraction == jb.wasted_step_fraction
    if name != "tiny":  # the run passes the sliding window
        assert b.total_steps > 2 * cfg.sliding_window


def test_batcher_with_eos_matches_reference(tiny):
    """An EOS id that some requests emit: the same early retirements."""
    jcfg, cfg, jparams, params = tiny
    reqs = _requests(cfg.vocab_size, (3, 4, 2, 5, 3), (12, 12, 12, 12, 12), seed=1)
    _, probe = _run(jsched, jcfg, jparams, reqs, 2, 96)
    eos = probe[0].output[2]
    reqs = [(uid, p, m, eos) for uid, p, m, _ in reqs]
    jb, jdone = _run(jsched, jcfg, jparams, reqs, 2, 96)
    b, done = _run(_PortModule, cfg, params, reqs, 2, 96)
    assert list(done) == list(jdone)
    assert {u: d.output for u, d in done.items()} == {u: d.output for u, d in jdone.items()}
    assert b.wasted_step_fraction == jb.wasted_step_fraction
    assert any(len(d.output) < 12 for d in done.values())


def _decode_alone(cfg, params, prompt, n_new):
    """Single-sequence greedy decode, as the reference's test does it."""
    state = init_decode_state(cfg, 1, 64, device="cpu")
    tok = None
    for t in prompt:
        logits, state = decode_step(params, torch.tensor([[t]], dtype=torch.int32), state, cfg)
        tok = int(torch.argmax(logits[0, 0]))
    out = [tok]
    for _ in range(n_new - 1):
        logits, state = decode_step(params, torch.tensor([[out[-1]]], dtype=torch.int32),
                                    state, cfg)
        out.append(int(torch.argmax(logits[0, 0])))
    return out


def test_batched_outputs_match_solo_decoding(tiny):
    _, cfg, _, params = tiny
    reqs = _requests(cfg.vocab_size, (3, 5, 2, 4, 3, 6), (4, 3, 5, 2, 4, 3))
    _, finished = _run(_PortModule, cfg, params, reqs, 2, 64)
    assert len(finished) == len(reqs)
    for uid, p, n, _ in reqs:
        assert finished[uid].output == _decode_alone(cfg, params, p.tolist(), n), uid
    # and serve_batch, one request at a time, gives the same tokens
    uid, p, n, _ = reqs[5]
    alone = serve.serve_batch(cfg, params, torch.from_numpy(p[None]), gen_len=n, device="cpu")
    assert alone[0].tolist() == finished[uid].output


def test_slot_reuse_no_leakage(tiny):
    """The same prompt twice, with other traffic through the one slot
    between them: identical outputs."""
    _, cfg, _, params = tiny
    p = np.asarray([7, 11, 13], np.int32)
    reqs = [(0, p, 4, None), (1, np.asarray([3, 5], np.int32), 3, None), (2, p, 4, None)]
    _, finished = _run(_PortModule, cfg, params, reqs, 1, 64)
    assert finished[0].output == finished[2].output


def test_eos_stops_early(tiny):
    _, cfg, _, params = tiny
    p = np.asarray([1, 2], np.int32)
    _, probe = _run(_PortModule, cfg, params, [(0, p, 1, None)], 1, 64)
    first = probe[0].output[0]
    _, done = _run(_PortModule, cfg, params, [(0, p, 10, first)], 1, 64)
    out = done[0].output
    assert out[-1] == first and len(out) <= 10


def test_refuses_ssm_and_codebooks(tiny):
    _, cfg, _, params = tiny
    ssm = configs.get_config("mamba2-2.7b").scaled_down()
    with pytest.raises(ValueError, match="SSM"):
        ContinuousBatcher(ssm, params, device="cpu")
    with pytest.raises(ValueError, match="codebook"):
        ContinuousBatcher(cfg.replace(num_codebooks=4), params, device="cpu")
    b = ContinuousBatcher(cfg, params, slots=2, cache_len=8, device="cpu")
    assert b.wasted_step_fraction == 0.0 and b.step() == 0 and b.run_to_completion() == {}
