"""The language models under a ``("data", "model")`` mesh on the CPU:
tensor parallelism over "model", batch rows over "data", the three mesh
levers, and ``flash_decode``.

Ranks are spawned processes in a gloo process group (one spawn at world
2 for the meshes (1, 2) and (2, 1), one at world 4 for (1, 4) and
(2, 2); one thread a rank). Each case is a scaled-down registered
architecture, some widths changed to reach a branch:

* ``dense``: gemma3-12b's "L"×5 + "A" pattern, 4 query heads over 2 KV
  heads (KV heads shard at 2 ranks of "model"; at 4 they are replicated
  and the caches shard their sequence, so decode runs ``flash_decode``),
  window 4 (the ring buffer wraps within the decode);
* ``odd``: 12 query heads over 3 KV heads (never divides: the rank's
  query heads read KV heads in uneven groups), qkv biases, q/k norms, an
  odd vocab (509: embedding and head replicated) tied as the head;
* ``vlm``: llama-3.2-vision-90b's period ("X" cross-attention);
* ``mamba``: mamba2-2.7b (16 heads, one SSD group);
* ``moe``: deepseek-moe-16b (4 experts: expert-sharded; shared experts;
  the "gather" dispatch);
* ``moe_ffn``: granite-moe-3b-a800m at 3 experts (the F-sharded
  fallback; the "einsum" dispatch);
* ``codebook``: musicgen-medium (4 codebooks, vocab-sharded (K, V, E)
  embedding and (K, E, V) head).

The reference's ``init_model`` draws the weights; each rank takes its
shard of ``params_from_jax`` (``shard_params``). Held on every rank:

* prefill logits (``forward`` over the rank's rows) within 2e-4·max|logit|
  of the reference's unsharded ``forward``; ``make_prefill_step(mesh=)``'s
  greedy tokens (every row, gathered) equal to the reference's argmax;
* teacher-forced decode (``init_decode_state(mesh=)``, ``decode_step``)
  against the reference at its rtol 2e-4 / atol 5e-4
  (``tests/test_perf_levers.py``), and, for ``dense`` and ``odd``, with
  ``decode_flash_shard`` "model" and "data,model";
* ``attn_q_seq_shard`` and ``residual_seq_shard`` together within 1e-6
  (times max|logit|) of the unlevered sharded run; the reference's levers
  on an Auto-axes 1×1 ``jax.sharding.Mesh`` within 1e-6 of its own
  unlevered run (``jax.make_mesh`` builds Explicit axes under jax 0.9.0,
  which fails the reference's own test there);
* ``init_model(mesh=)`` bitwise the rank's slices of ``init_model``;
* the residual the final norm reads bitwise equal across the model ranks of
  a data row, and the MoE routing records equal on every rank and to
  the unsharded port's.

Then the reference's ``flash_decode`` itself, in a subprocess on 4 forced
host devices with an Auto-axes (1, 4) mesh: the port at world 4 matches
its output and written cache to 1e-5·(1 + max).
"""

import dataclasses
import datetime
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs as jconfigs
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.launch.sharded_selftest import put_result, spawn_ranks
from repro_torch.models import transformer as tr
from repro_torch.optim.tree import leaves
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import init_mesh
from repro_torch.parallel.sharding import batch_sharding, param_shardings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, T, CACHE = 2, 12, 8, 16
CASES = {
    "dense": ("gemma3-12b", dict(num_kv_heads=2, sliding_window=4)),
    "odd": ("qwen3-14b", dict(num_heads=12, num_kv_heads=3, head_dim=16, d_model=64,
                              vocab_size=509, tie_embeddings=True, qkv_bias=True)),
    "vlm": ("llama-3.2-vision-90b", {}),
    "mamba": ("mamba2-2.7b", {}),
    "moe": ("deepseek-moe-16b", dict(moe_dispatch="gather")),
    "moe_ffn": ("granite-moe-3b-a800m", dict(moe_experts=3)),
    "codebook": ("musicgen-medium", {}),
}
ATTENTION = ("dense", "odd")  # the flash-decode lever's cases
MESHES = {2: ((1, 2), (2, 1)), 4: ((1, 4), (2, 2))}
FLASH_AXES = ("model", "data,model")


def _cfg(configs_mod, name):
    arch, over = CASES[name]
    cfg = configs_mod.get_config(arch).scaled_down()
    over = dict(over)
    if "moe_experts" in over:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, num_experts=over.pop("moe_experts")))
    return cfg.replace(**over)


def _inputs(cfg):
    rng = np.random.default_rng(7)
    K = cfg.num_codebooks
    toks = rng.integers(0, cfg.vocab_size, (B, S, K) if K > 1 else (B, S)).astype(np.int32)
    cross = (rng.standard_normal((B, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
             if cfg.vision_dim else None)
    return toks, cross


@pytest.fixture(scope="module")
def reference():
    """Per case: the reference's weights (numpy), inputs, unsharded
    forward logits and decode logits (teacher forcing: the forward's
    first T positions; for the MoE cases the reference's decode, whose
    steps route as groups of B tokens)."""
    out = {}
    for name in CASES:
        jcfg = _cfg(jconfigs, name)
        jparams = jtr.init_model(jcfg, jax.random.PRNGKey(0))
        toks, cross = _inputs(jcfg)
        jc = None if cross is None else jnp.asarray(cross)
        logits, _ = jax.jit(functools.partial(jtr.forward, cfg=jcfg))(
            jparams, jnp.asarray(toks), cross_embeds=jc)
        if jcfg.moe is None:  # teacher forcing: decode step t is forward's position t
            dec = np.asarray(logits)[:, :T]
        else:  # a decode step routes its B tokens as one group: the reference's decode
            step = jax.jit(functools.partial(jtr.decode_step, cfg=jcfg))
            st = jtr.init_decode_state(jcfg, B, CACHE)
            dec = []
            for t in range(T):
                lg, st = step(jparams, jnp.asarray(toks[:, t:t + 1]), st, cross_embeds=jc)
                dec.append(np.asarray(lg[:, 0]))
            dec = np.stack(dec, axis=1)
        out[name] = {"tree": jax.tree.map(np.asarray, jparams), "toks": toks, "cross": cross,
                     "logits": np.asarray(logits), "decode": dec}
    return out


def _decode(params, cfg, toks, cross, mesh, rows):
    st = tr.init_decode_state(cfg, B, CACHE, device="cpu", mesh=mesh)
    got = []
    for t in range(T):
        lg, st = tr.decode_step(params, toks[rows.rows, t:t + 1], st, cfg,
                                cross_embeds=None if cross is None else cross[rows.rows],
                                mesh=mesh, rows=rows)
        got.append(lg[:, 0])
    return torch.stack(got, dim=1).numpy()


def _forward(params, cfg, toks, cross, mesh, rows, routing=None):
    """The rank's logits and the residual the final norm reads."""
    seen = []
    logits, _ = tr.forward(params, toks[rows.rows], cfg,
                           cross_embeds=None if cross is None else cross[rows.rows],
                           mesh=mesh, rows=rows, moe_routing=routing, residual=seen)
    return logits.numpy(), seen[0].numpy()


def _case(mesh, name, ref):
    cfg = _cfg(configs, name)
    full = tr.params_from_jax(ref["tree"], cfg, device="cpu")
    params = tr.shard_params(full, mesh, cfg)
    toks = torch.from_numpy(ref["toks"]).long()
    cross = None if ref["cross"] is None else torch.from_numpy(ref["cross"])
    rows = batch_sharding(mesh, B, 2)
    res = {"rows": (rows.rows.start, rows.rows.stop)}
    routing, unsharded = [], []
    res["logits"], res["residual"] = _forward(params, cfg, toks, cross, mesh, rows, routing)
    if cfg.moe is not None:
        tr.forward(full, toks, cfg, cross_embeds=cross, moe_routing=unsharded)
        res["routing"] = [{k: v.numpy() for k, v in r.items() if torch.is_tensor(v)}
                          for r in routing]
        res["routing_unsharded"] = [{k: v.numpy() for k, v in r.items() if torch.is_tensor(v)}
                                    for r in unsharded]
    batch = {"tokens": toks}
    if cross is not None:
        batch["cross_embeds"] = cross
    res["prefill_tokens"] = steps.make_prefill_step(cfg, mesh=mesh)(params, batch).numpy()
    res["decode"] = _decode(params, cfg, toks, cross, mesh, rows)
    if name in ATTENTION:
        for axes in FLASH_AXES:
            fcfg = cfg.replace(decode_flash_shard=axes)
            res[f"flash/{axes}"] = _decode(params, fcfg, toks, cross, mesh, rows)
    if "X" not in cfg.mixer_pattern:
        lcfg = cfg.replace(attn_q_seq_shard="model", residual_seq_shard="model")
        res["levers"], _ = _forward(params, lcfg, toks, cross, mesh, rows)
    seeded = tr.shard_params(tr.init_model(cfg, 3, device="cpu"), mesh, cfg)
    drawn = tr.init_model(cfg, 3, device="cpu", mesh=mesh)
    res["init_bitwise"] = all(torch.equal(a, b) for a, b in zip(leaves(drawn), leaves(seeded)))
    res["init_shapes"] = [tuple(a.shape) for a in leaves(drawn)]
    return res


def _flash_inputs():
    """The reference comparison's decode inputs: (B, 1, H, Dh) q over a
    (B, S_cache, Kv, Dh) cache with positions to 11 written and slot 12
    next (length 12)."""
    rng = np.random.default_rng(3)
    Bq, Sc, H, Kv, Dh = 2, 16, 4, 2, 8
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    pos = np.full(Sc, -1, np.int32)
    pos[:12] = np.arange(12)
    return {"q": f(Bq, 1, H, Dh), "k_new": f(Bq, 1, Kv, Dh), "v_new": f(Bq, 1, Kv, Dh),
            "cache_k": f(Bq, Sc, Kv, Dh), "cache_v": f(Bq, Sc, Kv, Dh), "pos": pos,
            "length": np.int32(12)}


def _rank(rank, world, port, out_dir, refs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out = {}
        for data, model in MESHES[world]:
            mesh = init_mesh(data, model, device="cpu")
            out[(data, model)] = {"coord": mesh.coordinate}
            for name in CASES:
                out[(data, model)][name] = _case(mesh, name, refs[name])
        if world == 4:
            mesh = init_mesh(1, 4, device="cpu")
            inp = {k: torch.from_numpy(np.array(v)) for k, v in _flash_inputs().items()}
            Sl = inp["cache_k"].shape[1] // 4
            blk = slice(rank * Sl, (rank + 1) * Sl)
            ck, cv = inp["cache_k"][:, blk].clone(), inp["cache_v"][:, blk].clone()
            pos = inp["pos"][blk].clone()
            o = coll.flash_decode(inp["q"], inp["k_new"], inp["v_new"], ck, cv, pos,
                                  inp["length"], mesh=mesh, axis="model")
            out["flash"] = {"out": o.numpy(), "k": ck.numpy(), "v": cv.numpy(),
                            "pos": pos.numpy()}
        put_result(out_dir, rank, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(reference):
    refs = {n: {k: r[k] for k in ("tree", "toks", "cross")} for n, r in reference.items()}
    return {w: spawn_ranks(_rank, w, refs) for w in (2, 4)}


def _per_rank(spawned):
    for world, ranks in spawned.items():
        for mesh in MESHES[world]:
            for r in ranks:
                yield mesh, r[mesh]


CASE_MESH = [(w, m, n) for w in (2, 4) for m in MESHES[w] for n in CASES]


def _ranks(spawned, world, mesh, name):
    return [(r[mesh]["coord"], r[mesh][name]) for r in spawned[world]]


@pytest.mark.parametrize("world,mesh,name", CASE_MESH)
def test_prefill_matches_reference(spawned, reference, world, mesh, name):
    ref = reference[name]
    scale = np.abs(ref["logits"]).max()
    want_tokens = ref["logits"][:, -1:].argmax(-1)
    for _, res in _ranks(spawned, world, mesh, name):
        a, b = res["rows"]
        np.testing.assert_allclose(res["logits"], ref["logits"][a:b], rtol=0, atol=2e-4 * scale)
        np.testing.assert_array_equal(res["prefill_tokens"], want_tokens)


@pytest.mark.parametrize("world,mesh,name", CASE_MESH)
def test_decode_matches_reference(spawned, reference, world, mesh, name):
    ref = reference[name]
    for _, res in _ranks(spawned, world, mesh, name):
        a, b = res["rows"]
        np.testing.assert_allclose(res["decode"], ref["decode"][a:b], rtol=2e-4, atol=5e-4)


@pytest.mark.parametrize("axes", FLASH_AXES)
@pytest.mark.parametrize("world,mesh,name",
                         [c for c in CASE_MESH if c[2] in ATTENTION])
def test_flash_decode_lever_matches_teacher_forcing(spawned, reference, world, mesh, name,
                                                    axes):
    ref = reference[name]
    for _, res in _ranks(spawned, world, mesh, name):
        a, b = res["rows"]
        np.testing.assert_allclose(res[f"flash/{axes}"], ref["decode"][a:b], rtol=2e-4,
                                   atol=5e-4)


@pytest.mark.parametrize("world,mesh,name",
                         [c for c in CASE_MESH if c[2] != "vlm"])
def test_seq_levers_are_noops(spawned, world, mesh, name):
    for _, res in _ranks(spawned, world, mesh, name):
        scale = max(1.0, np.abs(res["logits"]).max())
        np.testing.assert_allclose(res["levers"], res["logits"], rtol=0, atol=1e-6 * scale)


def test_reference_seq_levers_on_auto_mesh(reference):
    """The reference's levers on an Auto-axes 1×1 mesh (its own test on
    ``jax.make_mesh`` fails under jax 0.9.0): within 1e-6 of unlevered."""
    from jax.sharding import Mesh

    jcfg = _cfg(jconfigs, "dense")
    lcfg = jcfg.replace(attn_q_seq_shard="model", residual_seq_shard="model")
    ref = reference["dense"]
    params = jax.tree.map(jnp.asarray, ref["tree"])
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with mesh:
        l0, _ = jax.jit(functools.partial(jtr.forward, cfg=jcfg))(params, ref["toks"])
        l1, _ = jax.jit(functools.partial(jtr.forward, cfg=lcfg))(params, ref["toks"])
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l0), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world,mesh,name", CASE_MESH)
def test_init_model_shards_are_slices(spawned, world, mesh, name):
    for _, res in _ranks(spawned, world, mesh, name):
        assert res["init_bitwise"]


@pytest.mark.parametrize("world,mesh,name", CASE_MESH)
def test_residual_bitwise_across_model_ranks(spawned, world, mesh, name):
    """Routing and greedy tokens are decided on each rank alone: the
    residual the head reads is the same bits on every model rank of a
    data row (and the logits)."""
    by_data = {}
    for coord, res in _ranks(spawned, world, mesh, name):
        by_data.setdefault(coord[0], []).append(res)
    for group in by_data.values():
        for res in group[1:]:
            np.testing.assert_array_equal(res["residual"], group[0]["residual"])
            np.testing.assert_array_equal(res["logits"], group[0]["logits"])
            np.testing.assert_array_equal(res["decode"], group[0]["decode"])


@pytest.mark.parametrize("world,mesh,name",
                         [c for c in CASE_MESH if c[2] in ("moe", "moe_ffn")])
def test_moe_routing_identical_on_every_rank(spawned, world, mesh, name):
    ranks = _ranks(spawned, world, mesh, name)
    want = ranks[0][1]["routing_unsharded"]
    for _, res in ranks:
        assert len(res["routing"]) == len(want)
        for got, w in zip(res["routing"], want):
            for k in ("expert_idx", "pos", "keep"):
                np.testing.assert_array_equal(got[k], w[k])


_REFERENCE_FLASH = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.parallel.collectives import flash_decode

inp = dict(np.load(sys.argv[1]))
mesh = Mesh(np.array(jax.devices()).reshape(1, 4), ("data", "model"))
with mesh:
    out, ck, cv, pos = jax.jit(lambda *a: flash_decode(*a, axis="model"))(
        *(jnp.asarray(inp[k]) for k in ("q", "k_new", "v_new", "cache_k", "cache_v", "pos",
                                         "length")))
    assert len(ck.sharding.device_set) == 4
np.savez(sys.argv[2], out=np.asarray(out), k=np.asarray(ck), v=np.asarray(cv),
         pos=np.asarray(pos))
"""


def test_flash_decode_matches_reference_on_four_devices(spawned, tmp_path):
    """The reference's flash_decode on 4 forced host devices (an Auto-axes
    (1, 4) mesh) against the port's at world 4: out and the written
    cache within 1e-5·(1 + max)."""
    inp = tmp_path / "in.npz"
    np.savez(inp, **_flash_inputs())
    got_path = tmp_path / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_FLASH, str(inp), str(got_path)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = dict(np.load(got_path))
    ranks = [r["flash"] for r in spawned[4]]
    for r in ranks:
        tol = 1e-5 * (1 + np.abs(want["out"]).max())
        np.testing.assert_allclose(r["out"], want["out"], rtol=0, atol=tol)
    for key in ("k", "v"):
        got = np.concatenate([r[key] for r in ranks], axis=1)
        np.testing.assert_allclose(got, want[key], rtol=0, atol=1e-5 * (1 + np.abs(want[key]).max()))
    np.testing.assert_array_equal(np.concatenate([r["pos"] for r in ranks]), want["pos"])


def test_lm_selftest_against_unsharded_record(tmp_path):
    """``sharded_selftest``'s LM check at world 2 over gloo (mesh (1, 2),
    then the flash-decode lever, then (2, 1)) against an unsharded record
    made here by ``lm_record``: the comparison passes, every rank agrees,
    and the prefill's collectives are one embedding all-reduce, two a
    layer and the vocab pick's gather of (value, id) pairs (the head's
    logits stay cut over the vocabulary), each pick bitwise the gathered
    argmax."""
    from repro_torch.launch import sharded_selftest as st

    cfg = st.lm_config("gemma3-12b", reduced=True)
    params = tr.init_model(cfg, 0, device="cpu")
    rec = st.lm_record(cfg, params, st.lm_inputs(cfg, (2, 16), (4, 6)), 6, torch.device("cpu"))
    path = str(tmp_path / "unsharded.pt")
    torch.save(rec, path)
    run = dict(arch="gemma3-12b", reduced=True, prefill=[2, 16], decode=[4, 6], record=path)
    plan = [dict(run, mesh=[1, 2]), dict(run, mesh=[1, 2], flash_decode=True),
            dict(run, mesh=[2, 1], out=str(tmp_path / "rows.pt"))]
    res = st.run_lm(2, plan, device="cpu")
    assert res["ok"], res
    one = res["lm"][0]
    assert one["ranks_agree"] and one["compare"]["token_mismatches"] == 0
    assert one["pick_bitwise"]
    assert [r["prefill_counts"]["collectives"] for r in one["ranks"]] == [
        2 + 2 * cfg.num_layers] * 2
    rows = torch.load(str(tmp_path / "rows.pt"))
    assert torch.equal(rows["decode_tokens"], rec["decode_tokens"])


def _layout_mesh(data, model, coord=(0, 0)):
    """A mesh of sizes only (no process group): enough where a check
    raises before any collective."""
    from repro_torch.parallel.mesh import Mesh

    return Mesh(("data", "model"), (data, model), coord)


def test_refusals_under_a_mesh():
    """No silent fallback: ``start_pos`` with a sequence-sharded cache, a
    split that cuts an SSD head or group, a lever naming an axis the mesh
    lacks, or a lever off "model" for the row splits: ``ValueError``."""
    from repro_torch.models import mamba2
    from repro_torch.parallel.sharding import check_levers

    mesh = _layout_mesh(1, 2)
    cfg = _cfg(configs, "odd").replace(num_heads=4, num_kv_heads=1,
                                       decode_flash_shard="model")  # vocab 509: whole
    params = tr.shard_params(tr.init_model(cfg, 0, device="cpu"), mesh, cfg)
    state = tr.init_decode_state(cfg, 2, 8, device="cpu", mesh=mesh)
    assert state["p0"].sharding.spec[1] == "model"
    with pytest.raises(ValueError, match="start_pos"):
        tr.decode_step(params, torch.zeros(2, 1, dtype=torch.long), state, cfg,
                       start_pos=torch.zeros(2, dtype=torch.long), mesh=mesh)
    ssd = configs.get_config("mamba2-2.7b").scaled_down().replace(d_model=64)
    shard = lambda c, n: tr._layer_shardings(param_shardings(
        tr.init_model(c, device="meta"), _layout_mesh(1, n))["blocks"]["p0"])["mixer"]
    # 4 heads of 32 over 8 ranks: d_inner 128 splits, a head would be cut
    with pytest.raises(ValueError, match="cut a head"):
        mamba2._local_heads(ssd, shard(ssd, 8), _layout_mesh(1, 8))
    # 6 heads in 3 groups of 2 over 2 ranks: 3 heads a rank straddle groups
    grouped = ssd.replace(d_model=96, mamba=dataclasses.replace(ssd.mamba, n_groups=3))
    with pytest.raises(ValueError, match="groups"):
        mamba2._local_heads(grouped, shard(grouped, 2), _layout_mesh(1, 2))
    with pytest.raises(ValueError, match="lacks"):
        check_levers(cfg.replace(decode_flash_shard="pod"), mesh)
    with pytest.raises(ValueError, match="'model' only"):
        check_levers(cfg.replace(decode_flash_shard=None, residual_seq_shard="data"), mesh)
