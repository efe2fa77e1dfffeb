"""Port ↔ reference parity: the serving-stage policies
(``repro_torch.serving.scheduler``).

Mirrors all six rows of ``tests/test_admission_policy.py`` on the
port's classes, with the reference file's strategies and its
``hypothesis`` fallback shim (imported, so both files draw the same
examples), and holds the two packages' ``EdfPriorityAdmission`` to the
same choice: the same queue selects the same uids in the same order.
"""

import copy
from collections import deque

import numpy as np
import pytest
import torch

from repro.serving.scheduler import EdfPriorityAdmission as JEdf
from repro.serving.scheduler import TierAccounting as JAccounting
from repro_torch.serving.scheduler import (
    EdfPriorityAdmission, FifoAdmission, TierAccounting,
)
from test_admission_policy import Req, _queue_of, given, req_specs, st

torch.set_num_threads(2)


@given(req_specs, st.integers(1, 8), st.floats(0.0, 200.0))
def test_fifo_is_exactly_popleft(specs, n_free, now):
    q = _queue_of(specs)
    want, rest = list(q)[:n_free], list(q)[n_free:]
    assert FifoAdmission().select(q, n_free, now) == want
    assert list(q) == rest


@given(req_specs, st.integers(1, 8), st.floats(0.0, 200.0))
def test_edf_bands_never_inverted(specs, n_free, now):
    """The chosen set is the n_free smallest by the order key, returned in
    key order, and no skipped request outranks a seated one."""
    policy = EdfPriorityAdmission()
    q = _queue_of(specs)
    everyone = list(q)
    chosen = policy.select(q, n_free, now)
    keys = {r.uid: policy.order_key(r, now) for r in everyone}
    got = [keys[r.uid] for r in chosen]
    assert got == sorted(got)
    assert len(chosen) == min(n_free, len(everyone))
    left = list(q)
    if chosen and left:
        assert max(got) <= min(keys[r.uid] for r in left)
        assert max(r.priority for r in chosen) <= min(r.priority for r in left)


@given(req_specs, st.floats(0.0, 200.0))
def test_edf_within_band(specs, now):
    chosen = EdfPriorityAdmission().select(_queue_of(specs), len(specs), now)
    for a, b in zip(chosen, chosen[1:]):
        if a.priority == b.priority:
            da = float("inf") if a.deadline_at is None else a.deadline_at
            db = float("inf") if b.deadline_at is None else b.deadline_at
            assert (da, a._submit_t, a.uid) <= (db, b._submit_t, b.uid)
        else:
            assert a.priority < b.priority


@given(req_specs, st.integers(1, 8), st.floats(0.0, 200.0),
       st.one_of(st.none(), st.floats(0.5, 20.0)))
def test_edf_selects_the_reference_uids(specs, n_free, now, aging_s):
    """The same queue through both packages' policies: the same uids in
    the same order, and the same requests left queued in the same order."""
    q_port, q_ref = _queue_of(specs), _queue_of(specs)
    got = EdfPriorityAdmission(aging_s=aging_s).select(q_port, n_free, now)
    want = JEdf(aging_s=aging_s).select(q_ref, n_free, now)
    assert [r.uid for r in got] == [r.uid for r in want]
    assert [r.uid for r in q_port] == [r.uid for r in q_ref]


def _saturating_flood(aging_s, rounds=40):
    """One old background request against a fresh urgent arrival every
    tick, one free slot a tick: the tick the victim is seated, or None."""
    policy = EdfPriorityAdmission(aging_s=aging_s)
    q = deque([Req(uid=0, priority=3, _submit_t=0.0)])
    for t in range(1, rounds + 1):
        q.append(Req(uid=1000 + t, priority=0, deadline_at=t + 0.5, _submit_t=float(t)))
        for r in policy.select(q, 1, float(t)):
            if r.uid == 0:
                return t
    return None


def test_aging_prevents_starvation_and_its_absence_demonstrates_it():
    assert _saturating_flood(aging_s=None) is None
    seated_at = _saturating_flood(aging_s=1.0)
    assert seated_at is not None and seated_at <= 5


@given(st.lists(
    st.tuples(st.one_of(st.none(), st.floats(0.0, 10.0)), st.floats(0.0, 20.0),
              st.integers(0, 500), st.sampled_from(["draft", "standard", None])),
    min_size=1, max_size=32,
))
def test_deadline_miss_counters_match_oracle_replay(items):
    """Per-class counters against an independent replay and against the
    reference's ``TierAccounting`` fed the same deliveries."""
    acc, ref = TierAccounting(), JAccounting()
    oracle = {}
    for uid, (deadline, deliver_t, nfe, tier) in enumerate(items):
        req = Req(uid=uid, deadline_at=deadline, nfe=nfe, tier=tier)
        acc.on_deliver(req, now=deliver_t)
        ref.on_deliver(copy.copy(req), now=deliver_t)
        o = oracle.setdefault(tier or "default", dict(n=0, miss=0, nfe=0))
        missed = deadline is not None and deliver_t > deadline
        o["n"] += 1
        o["nfe"] += nfe
        o["miss"] += int(missed)
        assert req.deadline_missed is missed
    assert set(acc.stats) == set(oracle)
    for name, o in oracle.items():
        s = acc.stats[name]
        assert (s.delivered, s.deadline_misses, s.deadline_met, s.nfe_total) == (
            o["n"], o["miss"], o["n"] - o["miss"], o["nfe"])
        assert s.mean_nfe == pytest.approx(o["nfe"] / o["n"])
        assert s.as_dict() == ref.stats[name].as_dict()


def test_server_deadline_accounting_matches_request_stamps():
    """Through the port's batcher with an injected fake clock: the
    per-class miss counters equal a recount over the delivered requests'
    own (deadline_at, delivery time) stamps."""
    from repro_torch.core.analytic import gaussian_noise_pred
    from repro_torch.core.sde import VPSDE
    from repro_torch.core.solvers.adaptive import AdaptiveConfig
    from repro_torch.launch.sample import make_sample_step
    from repro_torch.serving.diffusion_server import DiffusionBatcher, ImageRequest

    sde = VPSDE()
    cfg = AdaptiveConfig(eps_rel=0.05)
    fwd = gaussian_noise_pred(sde, 0.3, 0.5)
    step = make_sample_step(sde, cfg, forward_fn=lambda p, x, t: fwd(x, t))
    ticks = iter(range(1, 100_000))
    clock = lambda: float(next(ticks))  # 1 s a read
    log = []

    class LoggingAccounting(TierAccounting):
        def on_deliver(self, req, now):
            log.append((req.uid, req.deadline_at, now))
            super().on_deliver(req, now)

    acc = LoggingAccounting()
    b = DiffusionBatcher(sde, step, None, (16,), slots=4, cfg=cfg, sync_horizon=4,
                         tolerance_classes=True, delivery=acc, clock=clock, device="cpu")
    deadlines = [0.0, None, 1e9, 0.0, None, 1e9, 0.0, None]
    for uid, dl in enumerate(deadlines):
        b.submit(ImageRequest(uid=uid, seed=uid, tier="draft", deadline_ms=dl))
    done = b.run_to_completion()
    assert len(done) == len(deadlines)
    misses = sum(1 for _, dl, now in log if dl is not None and now > dl)
    s = acc.stats["draft"]
    assert s.delivered == len(deadlines)
    assert s.deadline_misses == misses == 3
    assert s.deadline_met == len(deadlines) - 3
    for uid, dl, now in log:
        assert done[uid].deadline_missed is (dl is not None and now > dl)
    assert np.isfinite(np.stack([r.result for r in done.values()])).all()
