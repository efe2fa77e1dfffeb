"""The graphed loops under a mesh, on the CPU: every solver family through
the cached plain driver under a gloo mesh, the one-shot rule's branch
agreed by the ranks, ``serve_batch``'s pool across calls, and the guard
that keys a cached graph on its net's state.

Ranks are spawned processes in a gloo process group at world 2 and 4
(one spawn each, both at once), each with one thread. On every rank, for
adaptive and Heun on VP and VE, EM, PC, PC-HMC, DDIM and the ODE:
``sample(mesh=)`` three times with one score function builds 0, 1, 0
drivers (the one-shot rule: the first call is the host-driven sharded
chain), and the graphed calls are that chain bit for bit (x, nfe,
accepted, rejected, iterations) and, gathered, the unsharded rows. The
Algorithm-1 solve's telemetry ring is the host-driven chain's, and the
unsharded ring's rows; ``solve_in_chunks(mesh=)``'s windows are the
host-driven chunks, each carry ``on_sync`` sees included. A fixed grid's
window adds no collective a step to the books: a graphed solve books the
branch's agreement alone. One rank clearing its cache between two solves
sends every rank down the host-driven branch (no rank hangs), and the
next solve captures on every rank.

At world 2 the graphed adaptive solve (VP) and EM are held against the
reference's ``sample(mesh=)`` on an Auto-axes ``jax.sharding.Mesh`` of
2 forced host devices (one subprocess, run while the ranks do), fed the
port's stream draws (``jax.random`` patched so that a key indexes a
table of them): nfe, accepted, rejected and iterations exactly, x within
``tests/test_torch_adaptive.py``'s bounds (rtol 1e-4, atol
1e-5·max|x|).

In this process: ``serve_batch`` keeps its decode state across calls
(the same tensors, reset bitwise to ``init_decode_state``'s values, the
tokens bitwise a fresh call's) and drops it with the parameters; the
stale-graph guard makes a flipped ``use_flash``, a ``cast_params`` and a
rebound parameter new keys, and keeps the key across an in-place AdamW
step. The card's captured collectives are gated in ``chip_smoke.py``
(phases 7, 8 and 10) and ``tests/test_torch_gpu.py``.
"""

import dataclasses
import datetime
import gc
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import analytic
from repro_torch.core import sde as tsde
from repro_torch.core.precision import resolve_policy
from repro_torch.core.sampling import gather_result, sample, seed_streams, solve_in_chunks
from repro_torch.core.solvers import adaptive as ad
from repro_torch.launch import serve
from repro_torch.launch.sharded_selftest import put_result, spawn_ranks
from repro_torch.models import dit as tdit
from repro_torch.models import init_decode_state, init_model
from repro_torch.optim import AdamW
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import init_mesh, sample_state_shardings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (8, 16)
FIELDS = ("x", "nfe", "accepted", "rejected", "iterations")
SDES = {"vp": tsde.VPSDE, "ve": lambda: tsde.VESDE(sigma_max=10.0)}
#: (method, sde, kwargs); VP PC grids keep n_steps > β_max = 20
CASES = [
    ("adaptive", "vp", dict(eps_rel=0.05)),
    ("adaptive", "ve", dict(eps_rel=0.05, use_fused_kernel=True)),
    ("heun", "vp", dict(eps_rel=0.05)),
    ("heun", "ve", dict(eps_rel=0.05)),
    ("em", "vp", dict(n_steps=13)),
    ("pc", "vp", dict(n_steps=25)),
    ("pc_hmc", "ve", dict(n_steps=9, hmc_leapfrog=2)),
    ("ddim", "vp", dict(n_steps=11)),
    ("ode", "vp", dict(rtol=1e-3, atol=1e-3)),
]
CASE_IDS = [f"{m}-{s}" + ("-fused" if k.get("use_fused_kernel") else "") for m, s, k in CASES]
#: the reference comparison at world 2: seed, EM's steps, the draws table
REF_SEED, REF_EM_STEPS, REF_DRAWS = 5, 40, 300
#: the patched ``jax.random.split(k) = (k + 1, k + OFFSET)``: the prior's key
#: is 1, the solver's i-th draw's 2·OFFSET + i
OFFSET = 1000


def _same(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


def _rows(res, rows):
    return type(res)(x=res.x[rows], nfe=res.nfe[rows], iterations=res.iterations,
                     accepted=res.accepted[rows], rejected=res.rejected[rows])


def _built(calls) -> list:
    """The drivers the cache built (``adaptive.builds``: the card's
    captures) in each of ``calls``."""
    out = []
    for call in calls:
        n = ad.builds
        call()
        out.append(ad.builds - n)
    return out


def _families(mesh) -> dict:
    out = {}
    for (method, name, kw), cid in zip(CASES, CASE_IDS):
        sde = SDES[name]()
        score = analytic.gaussian_score(sde, 0.3, 0.5)
        want = sample(sde, score, SHAPE, seed=3, method=method, device="cpu", **kw)
        res = []
        counts = _built([lambda: res.append(sample(
            sde, score, SHAPE, seed=3, method=method, device="cpu", mesh=mesh, **kw))] * 3)
        rows = sample_state_shardings(mesh, SHAPE[0], 2)[0].rows
        out[cid] = {"counts": counts, "graphed_is_host": _same(res[1], res[0])
                    and _same(res[2], res[0]), "rows_are_unsharded": _same(res[0], _rows(want, rows)),
                    "gathered": _same(gather_result(res[2], mesh, SHAPE[0]), want),
                    "rejected": int(want.rejected.sum())}
    return out


def _telemetry(mesh) -> dict:
    """Algorithm 1's ring under the mesh (``solve_graphed`` on a carry with
    a ring): host-driven, then graphed twice, against the unsharded ring."""
    sde = tsde.VPSDE()
    score = analytic.gaussian_score(sde, 0.3, 0.5)
    cfg = ad.AdaptiveConfig(eps_rel=0.05)
    st = seed_streams(4, SHAPE[0], "cpu")
    x0 = sde.prior_sample(SHAPE, st)
    sh = sample_state_shardings(mesh, SHAPE[0], 2)[0]
    full = ad.solve_chunk(sde, score, ad.init_carry(sde, x0, st.advanced(1), config=cfg,
                                                    telemetry=64),
                          max_sync_iters=cfg.max_iters, config=cfg)
    outs = []
    counts = _built([lambda: outs.append(ad.solve_graphed(
        sde, score, ad.init_carry(sde, x0, st.advanced(1), config=cfg, sharding=sh,
                                  telemetry=64), config=cfg, sharding=sh))] * 3)
    ring = lambda c: [getattr(c.telemetry, f.name) for f in dataclasses.fields(c.telemetry)
                      if f.name != "head"]
    same = lambda a, b: all(torch.equal(u, v) for u, v in zip(ring(a), ring(b))) and \
        torch.equal(a.x, b.x) and torch.equal(a.generator.counter, b.generator.counter)
    return {"counts": counts, "graphed_is_host": same(outs[1], outs[0]) and same(outs[2], outs[0]),
            "rows_are_unsharded": all(torch.equal(u[sh.rows], v) for u, v in
                                      zip(ring(full), ring(outs[0]))),
            "heads": [int(o.telemetry.head) for o in outs] + [int(full.telemetry.head)],
            "recorded": int(full.iterations)}


def _chunks(mesh) -> dict:
    sde = tsde.VPSDE()
    score = analytic.gaussian_score(sde, 0.3, 0.5)
    seen, res = [], []

    def run():
        syncs = []
        res.append(solve_in_chunks(sde, score, SHAPE, max_sync_iters=5, seed=6, device="cpu",
                                   mesh=mesh, eps_rel=0.05,
                                   on_sync=lambda c: syncs.append((int(c.iterations),
                                                                   c.x.clone()))))
        seen.append(syncs)

    counts = _built([run] * 3)
    same_syncs = all(len(s) == len(seen[0]) and all(
        a[0] == b[0] and torch.equal(a[1], b[1]) for a, b in zip(s, seen[0])) for s in seen)
    want = sample(sde, score, SHAPE, seed=6, device="cpu", eps_rel=0.05)
    rows = sample_state_shardings(mesh, SHAPE[0], 2)[0].rows
    return {"counts": counts, "graphed_is_host": _same(res[1], res[0]) and _same(res[2], res[0]),
            "syncs_equal": same_syncs, "syncs": len(seen[0]),
            "rows_are_unsharded": _same(res[0], _rows(want, rows))}


def _grid_books(mesh) -> dict:
    """The books of EM solves at two grids, host-driven and graphed: the
    branch's agreement and nothing a step."""
    sde = tsde.VPSDE()
    score = analytic.gaussian_score(sde, 0.3, 0.5)
    out = []
    for n_steps in (7, 7, 7, 19):
        coll.reset()
        sample(sde, score, SHAPE, seed=2, method="em", device="cpu", mesh=mesh, n_steps=n_steps)
        out.append(coll.counts())
    return {"books": out}


def _clear_on_one_rank(mesh) -> dict:
    sde = tsde.VPSDE()
    score = analytic.gaussian_score(sde, 0.3, 0.5)
    res, counts = [], []
    for i in range(5):
        if i == 2 and dist.get_rank() == 1:
            ad.clear_graph_cache()
        counts += _built([lambda: res.append(sample(
            sde, score, SHAPE, seed=8, device="cpu", mesh=mesh, eps_rel=0.05))])
    return {"counts": counts, "same": all(_same(r, res[0]) for r in res)}


def _reference_side(mesh) -> dict:
    """The port's graphed world-2 solves the reference is held against:
    the second call at each key (a graph), gathered."""
    sde = tsde.VPSDE()
    score = analytic.gaussian_score(sde)
    out = {}
    for method, kw in (("adaptive", dict(eps_rel=0.05)), ("em", dict(n_steps=REF_EM_STEPS))):
        for _ in range(2):
            got = sample(sde, score, SHAPE, seed=REF_SEED, method=method, device="cpu",
                         mesh=mesh, **kw)
        full = gather_result(got, mesh, SHAPE[0])
        out[method] = {f: getattr(full, f).numpy() for f in FIELDS}
    return out


def _rank(rank, world, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_mesh(world, 1, device="cpu")
        out = {"families": _families(mesh), "telemetry": _telemetry(mesh),
               "chunks": _chunks(mesh), "grid_books": _grid_books(mesh),
               "clear": _clear_on_one_rank(mesh)}
        if world == 2:
            out["reference"] = _reference_side(mesh)
        put_result(out_dir, rank, out)
    finally:
        dist.destroy_process_group()


_REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.core import analytic as jan, sde as jsde
from repro.core.sampling import sample
from repro.core.solvers.adaptive import AdaptiveConfig

shape, em_steps, offset, draws_path, out_path = json.loads(sys.argv[1])
table = jnp.asarray(np.load(draws_path))
jax.random.split = lambda k, num=2: (k + jnp.array([1, 0], k.dtype),
                                     k + jnp.array([offset, 0], k.dtype))
jax.random.normal = lambda k, shape, dtype=jnp.float32: table[k[0]].astype(dtype)
mesh = Mesh(np.array(jax.devices()), ("data",))
sde = jsde.VPSDE()
key = jnp.zeros((2,), jnp.int32)
out = {}
for method, kw in (("adaptive", dict(config=AdaptiveConfig(eps_rel=0.05))),
                   ("em", dict(n_steps=em_steps))):
    res = jax.jit(lambda k: sample(sde, jan.gaussian_score(sde), tuple(shape), k,
                                   method=method, mesh=mesh, **kw))(key)
    assert len(res.x.sharding.device_set) == 2
    for f in ("x", "nfe", "accepted", "rejected", "iterations"):
        out[f"{method}/{f}"] = np.asarray(getattr(res, f))
np.savez(out_path, **out)
"""


def _draws_table(path) -> None:
    """The port's stream draws as the patched reference indexes them: the
    prior (counter 0) at 1, the solver's i-th draw (counter 1 + i) at
    2·OFFSET + i."""
    st = seed_streams(REF_SEED, SHAPE[0], "cpu")
    table = np.zeros((2 * OFFSET + REF_DRAWS,) + SHAPE, np.float32)
    table[1] = st.draw(SHAPE[1:], 0).numpy()
    for i in range(REF_DRAWS):
        table[2 * OFFSET + i] = st.draw(SHAPE[1:], 1 + i).numpy()
    np.save(path, table)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The reference's run (a subprocess) and the spawns at world 2 and 4,
    all at once: {world: [rank results]} and the reference's arrays."""
    tmp = tmp_path_factory.mktemp("ref")
    _draws_table(tmp / "draws.npy")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.path.join(ROOT, "src"))
    args = json.dumps([SHAPE, REF_EM_STEPS, OFFSET, str(tmp / "draws.npy"), str(tmp / "ref.npz")])
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out, errors = {}, []

    def spawn(world):
        try:
            out[world] = spawn_ranks(_rank, world)
        except Exception as e:  # noqa: BLE001  (re-raised below, in the test's thread)
            errors.append(e)

    threads = [threading.Thread(target=spawn, args=(w,)) for w in (2, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    _, stderr = proc.communicate(timeout=240)
    assert not any(t.is_alive() for t in threads), "a spawn did not end"
    if errors:
        raise errors[0]
    assert proc.returncode == 0, stderr[-3000:]
    out["reference"] = dict(np.load(tmp / "ref.npz"))
    return out


@pytest.mark.parametrize("case", CASE_IDS)
@pytest.mark.parametrize("world", [2, 4])
def test_family_under_a_mesh_is_the_host_chain_and_the_unsharded_rows(spawned, world, case):
    for r in spawned[world]:
        res = r["families"][case]
        assert res["counts"] == [0, 1, 0]  # host-driven, capture, replay
        assert res["graphed_is_host"] and res["rows_are_unsharded"] and res["gathered"]
    if not case.startswith(("ddim", "ode")):  # the stochastic families reject some steps
        assert spawned[world][0]["families"][case]["rejected"] >= 0


@pytest.mark.parametrize("world", [2, 4])
def test_telemetry_ring_under_a_mesh(spawned, world):
    for r in spawned[world]:
        res = r["telemetry"]
        assert res["counts"] == [0, 1, 0]
        assert res["graphed_is_host"] and res["rows_are_unsharded"]
        assert len(set(res["heads"])) == 1 and res["recorded"] > 0


@pytest.mark.parametrize("world", [2, 4])
def test_solve_in_chunks_windows_are_the_host_chunks(spawned, world):
    for r in spawned[world]:
        res = r["chunks"]
        assert res["counts"] == [0, 1, 0]
        assert res["graphed_is_host"] and res["syncs_equal"] and res["rows_are_unsharded"]
        assert res["syncs"] > 2


@pytest.mark.parametrize("world", [2, 4])
def test_grid_window_books_no_collective_a_step(spawned, world):
    for r in spawned[world]:
        books = r["grid_books"]["books"]
        # the one-shot rule's agreement (one int32) and nothing else, at any
        # grid, host-driven (the first), captured and replayed alike
        assert books == [{"loop_control": (1, 4)}] * 4


@pytest.mark.parametrize("world", [2, 4])
def test_one_rank_clearing_its_cache_sends_every_rank_host_driven(spawned, world):
    for r in spawned[world]:
        res = r["clear"]
        # solve 3: rank 1 cleared → every rank host-driven (rank 0 keeps its
        # driver); solve 4: every rank captures (rank 0 drops and rebuilds)
        assert res["counts"] == [0, 1, 0, 1, 0]
        assert res["same"]


@pytest.mark.parametrize("method", ["adaptive", "em"])
def test_graphed_world2_matches_the_reference_sharded_sample(spawned, method):
    ref = spawned["reference"]
    for r in spawned[2]:
        got = r["reference"][method]
        for f in ("nfe", "accepted", "rejected"):
            np.testing.assert_array_equal(got[f], ref[f"{method}/{f}"], err_msg=f)
        assert int(got["iterations"]) == int(ref[f"{method}/iterations"])
        want_x = ref[f"{method}/x"]
        np.testing.assert_allclose(got["x"], want_x, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(want_x).max())))
    if method == "adaptive":
        assert int(ref["adaptive/rejected"].sum()) > 0
        assert int(ref["adaptive/iterations"]) < REF_DRAWS


# ------------------------------------------------------- in this process

@pytest.fixture(autouse=True)
def _empty_caches():
    ad.clear_graph_cache()
    serve.clear_serve_pool()
    yield
    ad.clear_graph_cache()
    serve.clear_serve_pool()


def test_serve_batch_keeps_its_state_across_calls():
    cfg = get_config("gemma3-12b").scaled_down()
    params = init_model(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (2, 5), generator=g)
    stats = []
    toks = []
    for _ in range(3):
        stats.append({})
        toks.append(serve.serve_batch(cfg, params, prompts, gen_len=4, device="cpu",
                                      stats=stats[-1]))
        if len(toks) == 1:
            (entry,) = serve._pool.values()
            ptrs = [t.data_ptr() for t in serve.state_tensors(entry.state)]
    (again,) = serve._pool.values()
    assert again is entry and [t.data_ptr() for t in serve.state_tensors(entry.state)] == ptrs
    assert all(s == {"captures": 0, "build_s": 0.0, "graphed": False} for s in stats)
    # tokens bitwise a fresh call's: a new pool entry on a fresh state
    serve.clear_serve_pool()
    fresh = serve.serve_batch(cfg, params, prompts, gen_len=4, device="cpu")
    assert all(torch.equal(t, fresh) for t in toks)
    # the reset state is bitwise init_decode_state's
    (entry,) = serve._pool.values()
    used = [t.clone() for t in serve.state_tensors(entry.state)]
    serve.reset_decode_state_(entry.state)
    want = serve.state_tensors(init_decode_state(cfg, 2, 9, device="cpu"))
    got = serve.state_tensors(entry.state)
    assert len(got) == len(want) > 0
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
    assert any(not torch.equal(a, b) for a, b in zip(used, want))
    # a model its caller dropped leaves no entry behind
    del params, entry
    gc.collect()
    assert not serve._pool


def test_serve_batch_pool_is_keyed_by_shape_and_model():
    cfg = get_config("mamba2-2.7b").scaled_down()
    p1, p2 = init_model(cfg, 0, device="cpu"), init_model(cfg, 1, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 4), generator=torch.Generator().manual_seed(1))
    serve.serve_batch(cfg, p1, prompts, gen_len=3, device="cpu")
    serve.serve_batch(cfg, p2, prompts, gen_len=3, device="cpu")
    serve.serve_batch(cfg, p1, prompts, gen_len=3, cache_len=16, device="cpu")
    serve.serve_batch(cfg, p1, prompts[:1], gen_len=3, device="cpu")
    assert len(serve._pool) == 4
    del p2
    gc.collect()
    assert len(serve._pool) == 3


def _small_dit():
    net = tdit.DiTConfig(image_size=8, patch=4, d_model=32, num_layers=1, num_heads=2,
                         d_ff=64)
    model = tdit.init_dit(net, torch.Generator().manual_seed(0))
    tdit.liven_zero_init(model, torch.Generator().manual_seed(1))
    return model


def _solve(score, n=1):
    sde = tsde.VPSDE()
    for _ in range(n):
        res = sample(sde, score, (2, 8, 8, 3), seed=0, device="cpu", eps_rel=0.3,
                     max_iters=16)
    return res


def test_stale_guard_new_key_after_use_flash_and_rebinding():
    model = _small_dit()
    score = tdit.make_score_fn(model, tsde.VPSDE())
    _solve(score, 2)
    assert len(ad._drivers) == 1 and len(ad._seen) == 1
    model.cfg = dataclasses.replace(model.cfg, use_flash=True)
    _solve(score)  # a new key: host-driven, recorded
    assert len(ad._drivers) == 1 and len(ad._seen) == 2
    _solve(score)
    assert len(ad._drivers) == 2
    block = model.blocks[0]
    name, p = next(iter(block.named_parameters(recurse=False)))
    setattr(block, name, torch.nn.Parameter(p.detach().clone()))
    _solve(score)
    assert len(ad._drivers) == 2 and len(ad._seen) == 3


def test_stale_guard_cast_params_is_a_new_key():
    model = _small_dit()
    score = tdit.make_score_fn(model, tsde.VPSDE())
    before = score.graph_state()
    resolve_policy("bf16_full").cast_params(model)
    assert score.graph_state() != before
    model.train()
    assert tdit.make_score_fn(model, tsde.VPSDE()).graph_state()[1] is True


def test_stale_guard_keeps_the_key_across_an_in_place_adamw_step():
    model = _small_dit()
    score = tdit.make_score_fn(model, tsde.VPSDE())
    first = _solve(score, 2)
    assert len(ad._drivers) == 1
    state_before = score.graph_state()
    tree = dict(model.named_parameters())
    opt = AdamW(lr=1e-2)
    grads = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(2))
             for k, v in tree.items()}
    with torch.no_grad():
        opt.update(grads, opt.init(tree), tree)
    assert score.graph_state() == state_before  # the weights moved in place
    after = _solve(score)  # a replay: the same key, the new weights
    assert len(ad._drivers) == 1 and len(ad._seen) == 1
    assert not torch.equal(after.x, first.x)
    ad.clear_graph_cache()
    assert _same(_solve(score), after)  # the host-driven chain on the new weights


def test_score_without_graph_state_is_keyed_by_identity():
    sde = tsde.VPSDE()
    score = analytic.gaussian_score(sde, 0.3, 0.5)
    assert not hasattr(score, "graph_state")
    for _ in range(2):
        sample(sde, score, SHAPE, seed=0, device="cpu", eps_rel=0.1)
    (key,) = ad._drivers
    assert key.state == (None,) and key.mesh is None
