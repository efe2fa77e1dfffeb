"""The LM head's output kept cut over the vocabulary under a mesh:
``collectives.vocab_parallel_cross_entropy`` (the train step's loss) and
``collectives.vocab_parallel_argmax`` (the prefill's and the decode
step's greedy pick), against the reference's ``repro.data.tokens.lm_loss``
and its ``jax.grad`` on the CPU.

Ranks are spawned in gloo process groups: one spawn at world 2 (mesh
(1, 2)) and one at world 4 (mesh (2, 2), each data rank its block of
rows), both at once. Each rank computes its vocab columns through
``transformer.lm_logits(vocab_local=True)`` on its block of the head
(untied ``lm_head``, the embedding tied as the head, a codebook head of
4), in fp32 and in bf16 (the bf16 logits cast to fp32 for the loss),
with targets planted on every rank and at the slices' edges (ids 0,
V/n − 1, V/n, V − 1). The ranks' columns are gathered here into numpy
logits, on which the reference's ``lm_loss`` and ``jax.grad`` of it run:

* the loss within 2e-6 relative of the reference's, and each rank's
  gradient of its columns within 2e-6·(1 + max|g|) of the slice of
  ``jax.grad``;
* the loss the same bits on every model rank of a data block, and again
  on a second call;
* ``vocab_parallel_argmax`` bitwise ``torch.argmax`` of the gathered
  logits, at every position, and on planted ties across the slice
  boundary, within a slice, across all ranks and at the last id.

In process: the counted path on meta tensors (two all-reduces for the
loss, one all-gather of (value, id) pairs for the pick) and, without a
mesh, the loss and the pick bit for bit the plain ``lm_loss`` and
``torch.argmax``.
"""

import datetime
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.data import tokens as jtokens
from repro_torch.configs import get_config
from repro_torch.data.tokens import lm_loss
from repro_torch.launch.sharded_selftest import put_result, spawn_ranks
from repro_torch.launch.steps import greedy_tokens, make_loss_fn
from repro_torch.models import transformer as tr
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import init_mesh

torch.set_num_threads(2)

LOSS_RTOL = 2e-6
GRAD_TOL = 2e-6
B, S, V, K = 4, 6, 64, 4
#: (tied head, codebooks, dtype)
HEADS = {
    "untied": (False, 1, "float32"),
    "tied": (True, 1, "float32"),
    "codebook": (True, K, "float32"),
    "untied_bf16": (False, 1, "bfloat16"),
    "tied_bf16": (True, 1, "bfloat16"),
    "codebook_bf16": (False, K, "bfloat16"),
}
#: world → (data, model)
MESHES = {2: (1, 2), 4: (2, 2)}
PARAMS = [(w, h) for w in MESHES for h in HEADS]


def _cfg(head: str):
    tie, k, dtype = HEADS[head]
    return get_config("olmo-1b").scaled_down().replace(
        vocab_size=V, tie_embeddings=tie, num_codebooks=k, dtype=dtype)


def _inputs(head: str):
    """The whole head, the head's input x and the tokens, from numpy."""
    cfg = _cfg(head)
    rng = np.random.default_rng(sorted(HEADS).index(head))
    E, k = cfg.d_model, cfg.num_codebooks
    if cfg.tie_embeddings:
        shape = (k, V, E) if k > 1 else (V, E)
    else:
        shape = (k, E, V) if k > 1 else (E, V)
    w = (rng.standard_normal(shape) * E ** -0.5).astype(np.float32)
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    toks = rng.integers(0, V, (B, S) + ((k,) if k > 1 else ())).astype(np.int32)
    vl = V // 2
    # targets at the slices' edges, of rows 0 and B − 1 (each data block's)
    for row in (0, B - 1):
        edge = toks[row, 1:5] if k == 1 else toks[row, 1:5, 0]
        edge[:] = [0, vl - 1, vl, V - 1]
    return cfg, w, x, toks


def _ties(dtype) -> torch.Tensor:
    """(B, S, V) logits with planted maxima: row 0 equal at V/2 − 1 and
    V/2 (across the boundary: V/2 − 1), row 1 equal at V/2 and V − 1
    (V/2), row 2 all equal (0), row 3 twice in rank 1's slice and once in
    rank 0's lower (the lowest), position 0 of every row at V − 1 alone."""
    g = torch.Generator().manual_seed(5)
    t = torch.randn((B, S, V), generator=g)
    vl = V // 2
    t[0, :, [vl - 1, vl]] = 9.0
    t[1, :, [vl, V - 1]] = 9.0
    t[2] = 1.5
    t[3, :, [vl + 3, V - 2, 7]] = 9.0
    t[:, 0, V - 1] = 20.0
    return t.to(dtype)


def _rank(rank, world, port, out_dir, _):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        data, model = MESHES[world]
        mesh = init_mesh(data, model, device="cpu")
        d, m = mesh.coord("data"), mesh.coord("model")
        rows = slice(d * B // data, (d + 1) * B // data)
        out = {"coord": (d, m)}
        for head in HEADS:
            cfg, w, x, toks = _inputs(head)
            dtype = getattr(torch, cfg.dtype)
            name = "embed" if cfg.tie_embeddings else "lm_head"
            shard = tr.model_shardings(cfg, mesh)[name]
            local_w = shard.local(torch.from_numpy(w).to(dtype)).clone()
            with torch.no_grad():
                logits, v0 = tr.lm_logits({name: local_w}, torch.from_numpy(x[rows]).to(dtype),
                                          cfg, shard=shard.model_part(), mesh=mesh,
                                          vocab_local=True)
            tgt = torch.from_numpy(toks[rows])
            leaf = logits.detach().float().requires_grad_(True)
            loss = coll.vocab_parallel_cross_entropy(leaf[:, :-1], tgt[:, 1:], v0, mesh)
            (grad,) = torch.autograd.grad(loss, leaf)
            with torch.no_grad():
                again = coll.vocab_parallel_cross_entropy(leaf[:, :-1], tgt[:, 1:], v0, mesh)
                pick = coll.vocab_parallel_argmax(logits, v0, mesh)
                last = greedy_tokens(logits[:, -1:], v0, mesh)
            out[head] = {"first": v0, "logits": logits.float().numpy(),
                         "loss": loss.detach().reshape(1).view(torch.int32).item(),
                         "again": again.reshape(1).view(torch.int32).item(),
                         "grad": grad.numpy(), "pick": pick.numpy(), "last": last.numpy()}
        vl = V // model
        for dtype in (torch.float32, torch.bfloat16):
            ties = _ties(dtype)[rows, :, m * vl:(m + 1) * vl]
            out[f"ties_{dtype}"] = coll.vocab_parallel_argmax(ties, m * vl, mesh).numpy()
        put_result(out_dir, rank, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned():
    """The spawns at world 2 and 4, both at once: {world: rank results}."""
    out, errors = {}, []

    def spawn(world):
        try:
            out[world] = spawn_ranks(_rank, world, None)
        except Exception as e:  # noqa: BLE001  (re-raised below, in the test's thread)
            errors.append(e)

    threads = [threading.Thread(target=spawn, args=(w,)) for w in MESHES]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not any(t.is_alive() for t in threads), "a spawn did not end"
    if errors:
        raise errors[0]
    return out


def _blocks(ranks):
    """{data coordinate: the ranks of that block in model order}."""
    out = {}
    for r in sorted(ranks, key=lambda r: r["coord"]):
        out.setdefault(r["coord"][0], []).append(r)
    return out


def _rows(world, d):
    data = MESHES[world][0]
    return slice(d * B // data, (d + 1) * B // data)


@pytest.mark.parametrize("world,head", PARAMS, ids=[f"w{w}-{h}" for w, h in PARAMS])
def test_loss_and_gradient_against_the_reference(spawned, world, head):
    _, _, _, toks = _inputs(head)
    for d, ranks in _blocks(spawned[world]).items():
        gathered = np.concatenate([r[head]["logits"] for r in ranks], axis=-1)
        assert [r[head]["first"] for r in ranks] == [m * V // len(ranks)
                                                     for m in range(len(ranks))]
        tgt = jnp.asarray(toks[_rows(world, d)])
        want, g = jax.value_and_grad(lambda lg: jtokens.lm_loss(lg, tgt))(jnp.asarray(gathered))
        g = np.asarray(g)
        bound = GRAD_TOL * (1 + np.abs(g).max())
        vl = V // len(ranks)
        for m, r in enumerate(ranks):
            got = np.array([r[head]["loss"]], np.int32).view(np.float32)[0]
            assert abs(got - float(want)) <= LOSS_RTOL * abs(float(want))
            np.testing.assert_allclose(r[head]["grad"], g[..., m * vl:(m + 1) * vl],
                                       rtol=0, atol=bound)
            assert not r[head]["grad"][:, -1].any()  # the last position predicts nothing


@pytest.mark.parametrize("world,head", PARAMS, ids=[f"w{w}-{h}" for w, h in PARAMS])
def test_loss_is_the_same_bits_on_every_model_rank_and_call(spawned, world, head):
    for ranks in _blocks(spawned[world]).values():
        bits = {r[head]["loss"] for r in ranks} | {r[head]["again"] for r in ranks}
        assert len(bits) == 1


@pytest.mark.parametrize("world,head", PARAMS, ids=[f"w{w}-{h}" for w, h in PARAMS])
def test_pick_is_the_gathered_argmax(spawned, world, head):
    for ranks in _blocks(spawned[world]).values():
        gathered = torch.from_numpy(np.concatenate([r[head]["logits"] for r in ranks], -1))
        want = torch.argmax(gathered, dim=-1).numpy()
        for r in ranks:
            np.testing.assert_array_equal(r[head]["pick"], want)
            np.testing.assert_array_equal(r[head]["last"], want[:, -1:])


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_pick_breaks_planted_ties_as_argmax(spawned, world, dtype):
    whole = _ties(dtype)
    for d, ranks in _blocks(spawned[world]).items():
        want = torch.argmax(whole[_rows(world, d)], dim=-1).numpy()
        for r in ranks:
            np.testing.assert_array_equal(r[f"ties_{dtype}"], want)
    # the planted rows pick what torch.argmax's rule says
    want = torch.argmax(whole, dim=-1)
    vl = V // 2
    assert want[0, 1] == vl - 1 and want[1, 1] == vl and want[2, 1] == 0
    assert want[3, 1] == 7 and (want[:, 0] == V - 1).all()


def test_counted_on_meta_tensors():
    """In ``counting()`` on one rank of the production mesh (16 ranks of
    "model"): the loss books two all-reduces (the row maxima, then Σexp
    and the target's logit packed), the pick one all-gather of (value,
    id) pairs, and each returns its shape."""
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh()
    n = mesh.shape["model"]
    logits = torch.empty(2, 7, 32, device="meta")
    tgt = torch.empty(2, 7, dtype=torch.int32, device="meta")
    coll.reset()
    with coll.counting():
        loss = coll.vocab_parallel_cross_entropy(logits, tgt, 32, mesh)
        books_loss = coll.op_counts()
        coll.reset()
        pick = coll.vocab_parallel_argmax(logits.to(torch.bfloat16), 32, mesh)
        books_pick = coll.op_counts()
    coll.reset()
    assert loss.shape == () and pick.shape == (2, 7) and pick.dtype == torch.int64
    assert books_loss == {"all-reduce": (2, 2 * 7 * 4 + 2 * 2 * 7 * 4)}
    assert books_pick == {"all-gather": (1, n * 2 * 7 * 2 * 4)}


@pytest.mark.parametrize("head", ["untied", "codebook"])
def test_without_a_mesh_nothing_changes(head):
    """No mesh: ``forward(vocab_local=True)`` is the whole logits with no
    offset, and the train step's loss and the pick are ``lm_loss`` and
    ``torch.argmax`` of ``forward``'s logits, bit for bit."""
    cfg = _cfg(head).replace(dtype="float32")
    params = tr.init_model(cfg, 0, device="cpu")
    _, _, _, toks = _inputs(head)
    toks = torch.from_numpy(toks)
    logits, _ = tr.forward(params, toks, cfg, use_flash=False, use_kernel_ssd=False)
    (local, v0), _ = tr.forward(params, toks, cfg, use_flash=False, use_kernel_ssd=False,
                                vocab_local=True)
    assert v0 is None and torch.equal(local, logits)
    loss, ce, _ = make_loss_fn(cfg)(params, {"tokens": toks})
    assert torch.equal(ce, lm_loss(logits, toks)) and torch.equal(loss, ce)
    assert torch.equal(greedy_tokens(local, v0), torch.argmax(logits, dim=-1))
