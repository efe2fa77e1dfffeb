"""P1, the per-row Philox normals (``repro_torch.kernels.philox``), and
``SlotStreams``, the per-slot noise streams they draw, on the CPU.

The reference draws a slot's noise with XLA's threefry, which no torch
call reproduces, so nothing here compares with it: ``ref.py`` is held to
Random123's published known answers for Philox4x32-10, to an independent
uint64 numpy implementation of the same rounds, and to the statistics of
a standard normal. The kernel is held to ``ref.py`` on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 2: the words
exactly, z within 2e-6·(1 + |z|)).

Properties the serving loop relies on: row i of a draw depends on
(seed_i, counter_i) alone (permuting the rows permutes the output bit
for bit, and a row drawn alone is its row in a batch), idle rows
(seed < 0) are 0, and a ``SlotStreams`` carry permuted mid-solve gives
the unpermuted solve's rows, permuted.
"""

import numpy as np
import pytest
import torch
from scipy import stats

from repro_torch.core import analytic as tan
from repro_torch.core.sde import VESDE, VPSDE
from repro_torch.core.solvers import adaptive as ad
from repro_torch.core.solvers.base import SlotStreams, draw_noise
from repro_torch.kernels.philox import ops, ref

torch.set_num_threads(2)

#: Random123's kat_vectors for philox4x32_10: (counter, key) -> output
KNOWN = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _np_philox(ctr, key):
    """Philox4x32-10 in numpy uint64 (products exact modulo 2^64): an
    implementation independent of ref.py's 16-bit halves."""
    c = [np.uint64(v) for v in ctr]
    k = [np.uint64(v) for v in key]
    m32 = np.uint64(0xFFFFFFFF)
    for r in range(10):
        if r:
            k = [(k[0] + np.uint64(ref.W0)) & m32, (k[1] + np.uint64(ref.W1)) & m32]
        p0 = np.uint64(ref.M0) * c[0]
        p1 = np.uint64(ref.M1) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k[0], p1 & m32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k[1], p0 & m32]
    return tuple(int(v) for v in c)


@pytest.mark.parametrize("ctr,key,want", KNOWN, ids=["zeros", "ones", "pi"])
def test_random123_known_answers(ctr, key, want):
    t = lambda v: torch.tensor([v], dtype=torch.int64)
    got = ref.philox4x32_10(*map(t, ctr), *map(t, key))
    assert tuple(int(v) for v in got) == want
    assert _np_philox(ctr, key) == want


def test_words_match_independent_uint64_rounds():
    """Rows of mixed 64-bit seeds and counters, the counter layout (j4, 0,
    counter low, counter high) and the key (seed low, seed high)."""
    g = np.random.default_rng(0)
    seeds = g.integers(0, 2**63 - 1, 5)
    counters = g.integers(0, 2**63 - 1, 5)
    w = ref.philox_words(torch.from_numpy(seeds), torch.from_numpy(counters), 10)
    for i, (s, c) in enumerate(zip(seeds.tolist(), counters.tolist())):
        want = []
        for j in range(3):
            want += _np_philox((j, 0, c & 0xFFFFFFFF, c >> 32), (s & 0xFFFFFFFF, s >> 32))
        assert w[i].tolist() == want[:10]


def test_normals_are_box_muller_of_the_words():
    seed = torch.tensor([3, 2**40 + 7])
    ctr = torch.tensor([0, 5])
    w = ref.philox_words(seed, ctr, 8).numpy().astype(np.float64)
    u = (np.floor(w / 256) + 0.5) * 2.0 ** -24
    r = np.sqrt(-2 * np.log(u[:, 0::2]))
    th = 2 * np.pi * u[:, 1::2]
    want = np.stack([r * np.cos(th), r * np.sin(th)], -1).reshape(2, 8)
    np.testing.assert_allclose(ref.philox_normal(seed, ctr, 8).numpy(), want,
                               rtol=1e-5, atol=1e-6)
    assert u.min() > 0  # the logarithm never sees 0


@pytest.mark.parametrize("D", [1, 2, 5, 736])
def test_rows_depend_only_on_seed_and_counter(D):
    g = torch.Generator().manual_seed(D)
    seed = torch.randint(0, 2**62, (16,), generator=g)
    ctr = torch.randint(0, 2**40, (16,), generator=g)
    z = ops.normal(seed, ctr, D)
    perm = torch.randperm(16, generator=g)
    assert torch.equal(ops.normal(seed[perm], ctr[perm], D), z[perm])
    assert torch.equal(ops.words(seed[perm], ctr[perm], D), ops.words(seed, ctr, D)[perm])
    for i in (0, 7, 15):
        assert torch.equal(ops.normal(seed[i:i + 1], ctr[i:i + 1], D)[0], z[i])
    # the next counter is a new draw, and a longer row extends the shorter
    assert not torch.equal(ops.normal(seed, ctr + 1, D), z)
    assert torch.equal(ops.normal(seed, ctr, D + 3)[:, :D], z)


def test_idle_rows_are_zero():
    seed = torch.tensor([-1, 4, -7])
    z = ops.normal(seed, torch.zeros(3, dtype=torch.int64), 6)
    assert torch.equal(z[0], torch.zeros(6)) and torch.equal(z[2], torch.zeros(6))
    assert torch.equal(ops.words(seed, torch.zeros(3, dtype=torch.int64), 6)[0],
                       torch.zeros(6, dtype=torch.int64))
    assert (z[1] != 0).all()


def test_moments_and_ks_at_tables_state():
    """(4096, 2), Table 1's state: one row a request, counter 1."""
    z = ops.normal(torch.arange(4096), torch.ones(4096, dtype=torch.int64), 2)
    flat = z.double().numpy().ravel()
    n = flat.size
    assert abs(flat.mean()) < 4 / np.sqrt(n)
    assert abs(flat.var() - 1) < 4 * np.sqrt(2 / n)
    assert abs(stats.skew(flat)) < 4 * np.sqrt(6 / n)
    assert stats.kstest(flat, "norm").pvalue > 1e-3
    # the two columns (cosine and sine of one pair) are uncorrelated
    assert abs(np.corrcoef(z[:, 0].numpy(), z[:, 1].numpy())[0, 1]) < 4 / np.sqrt(4096)


def test_wrapper_checks():
    s = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(TypeError):
        ops.normal(s.to(torch.int32), s, 4)
    with pytest.raises(ValueError):
        ops.normal(s, s[:2], 4)
    with pytest.raises(ValueError):
        ops.normal(s, s, 0)


# --------------------------------------------------------------------------
# SlotStreams
# --------------------------------------------------------------------------

def test_slot_streams_draw_prior_and_noise():
    """A prior is the stream's draw at counter 0 times prior_std; the
    noise draw of the carry reads the counter (plus an offset) and never
    advances it."""
    st = SlotStreams.of([5, -1, 9], 0, "cpu")
    x = VESDE(sigma_max=10.0).prior_sample((3, 4, 2), st)
    assert torch.equal(x, ops.normal(st.seed, st.counter, 8).reshape(3, 4, 2) * 10.0)
    assert torch.equal(x[1], torch.zeros(4, 2))
    z0 = draw_noise(st, None, x)
    z1 = draw_noise(st, None, x, offset=1)
    assert torch.equal(z0, x / 10.0)
    assert torch.equal(z1, draw_noise(st.advanced(torch.tensor(1)), None, x))
    assert torch.equal(st.counter, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        VPSDE().prior_sample((2, 4), st)


def _carry(sde, cfg, seeds):
    x0 = sde.prior_sample((len(seeds), 8), SlotStreams.of(seeds, 0, "cpu"))
    return ad.init_carry(sde, x0, SlotStreams.of(seeds, 1, "cpu"), config=cfg)


def _permute(carry, perm):
    idx = torch.tensor(perm)
    take = lambda v: v.index_select(0, idx)
    return ad.SolverCarry(
        x=take(carry.x), x_prev=take(carry.x_prev), t=take(carry.t), h=take(carry.h),
        nfe=take(carry.nfe), accepted=take(carry.accepted), rejected=take(carry.rejected),
        done=take(carry.done), iterations=carry.iterations,
        generator=SlotStreams(seed=take(carry.generator.seed),
                              counter=take(carry.generator.counter)))


@pytest.mark.parametrize("use_fused_kernel", [False, True], ids=["plain", "fused"])
def test_slot_streams_invariant_to_compaction(use_fused_kernel):
    """Permuting the carry's rows between chunks (what compaction does)
    permutes the finished solve's rows, bit for bit: each row's noise
    comes from its own stream, wherever the row sits."""
    sde = VPSDE()
    cfg = ad.AdaptiveConfig(eps_rel=0.05, use_fused_kernel=use_fused_kernel)
    f = tan.gaussian_noise_pred(sde, 0.3, 0.5)

    def score(x, t):
        _, std = sde.marginal(t)
        return -f(x, t).to(torch.float32) / std.reshape(-1, 1)

    seeds = [11, 12, 13, 14, 15]
    perm = [3, 0, 4, 1, 2]
    a = ad.solve_chunk(sde, score, _carry(sde, cfg, seeds), max_sync_iters=100_000, config=cfg)
    b = ad.solve_chunk(sde, score, _carry(sde, cfg, seeds), max_sync_iters=7, config=cfg)
    b = ad.solve_chunk(sde, score, _permute(b, perm), max_sync_iters=100_000, config=cfg)
    assert bool(a.done.all()) and bool(b.done.all())
    for name in ("x", "nfe", "accepted", "rejected"):
        assert torch.equal(getattr(b, name), getattr(a, name)[perm]), name
    # one draw an iteration in which some sample was active, from counter 1
    assert torch.equal(a.generator.counter, torch.full((5,), 1 + int(a.iterations)))
    # solo batch-1 solves are the same rows
    for i, s in enumerate(seeds):
        solo = ad.solve_chunk(sde, score, _carry(sde, cfg, [s]), max_sync_iters=100_000,
                              config=cfg)
        assert torch.equal(solo.x[0], a.x[i]) and int(solo.nfe[0]) == int(a.nfe[i])
