"""Port ↔ reference parity: the chunked SSD scan (``repro_torch.kernels.ssd``).

The same numpy inputs go through the reference's sequential oracle
(``ref.ssd_scan``), its chunked jnp version (``ref.ssd_chunked``) and its
Pallas kernel (``ops.ssd_scan``, interpret mode on the CPU, as
``tests/test_kernels_ssd.py`` runs it), and through the port's
``ref.ssd_scan``, ``ref.ssd_chunked`` and ``ops.ssd_scan`` on CPU
tensors (which runs the plain ``ssd_chunked``).

Bound: rtol = atol = 3e-4, the reference's own bound of its kernel and
its chunked version against the sequential oracle
(``tests/test_kernels_ssd.py``). Every version computes in fp32; they
differ in the order of the sums (a chunk's products, the cross-chunk
recurrence as a loop here and an associative scan there, and the chunk
length). bf16 operands: one bf16 ulp of the output plus 3e-4 (both
sides compute in fp32 and round once).

``ref.ssd_ranges`` is the CUDA kernel's decomposition in plain PyTorch
(C·Bᵀ once a group, the sequence split into ranges of chunks, a
state-passing pass); it is held to the same 3e-4 against the oracle, the
reference's chunked version and its Pallas kernel.
``test_3xtf32_split_keeps_the_kernels_bound`` emulates the kernel's
tensor-core products at its widths: one TF32 pass misses the kernel's
6e-4 bound against ``ssd_chunked``, the 3xTF32 split meets it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ops as jops
from repro.kernels.ssd import ref as jref
from repro_torch.kernels.ssd import ops, ref

torch.set_num_threads(2)

TOL = dict(rtol=3e-4, atol=3e-4)

#: the reference's chunked version, compiled once per shape (eager, it
#: dispatches op by op)
jchunked = jax.jit(jref.ssd_chunked, static_argnames="chunk")

CASES = [
    # B, S, H, P, G, N, chunk: the non-slow cases of tests/test_kernels_ssd.py
    (2, 128, 4, 64, 1, 64, 32),
    (1, 100, 8, 32, 2, 32, 32),
    (1, 64, 4, 32, 4, 16, 16),
    # a ragged S (not a multiple of any chunk), heads sharing one group
    (2, 77, 4, 16, 1, 16, 32),
]


def _inputs(case, seed=0):
    B, S, H, P, G, N, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0.0).astype(np.float32)  # softplus
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    C = rng.standard_normal((B, S, G, N)).astype(np.float32)
    return x, dt, A, Bm, C


def _head_major(x, dt, A, Bm, C):
    """Model layout → the kernel layout of the sequential oracle."""
    return (x.transpose(0, 2, 1, 3), dt.transpose(0, 2, 1), A,
            Bm.transpose(0, 2, 1, 3), C.transpose(0, 2, 1, 3))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _oracle(inputs):
    """The reference's sequential oracle in the model layout: (y, state)."""
    y, state = jref.ssd_scan(*(_j(a) for a in _head_major(*inputs)))
    return np.asarray(y).transpose(0, 2, 1, 3), np.asarray(state)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_sequential_oracle_matches_reference(case):
    inputs = _inputs(case)
    y, state = ref.ssd_scan(*(_t(a) for a in _head_major(*inputs)))
    want_y, want_state = jref.ssd_scan(*(_j(a) for a in _head_major(*inputs)))
    assert y.dtype == torch.float32 and state.shape == want_state.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), **TOL)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_chunked_matches_reference_chunked(case):
    inputs = _inputs(case)
    chunk = case[-1]
    y = ref.ssd_chunked(*(_t(a) for a in inputs), chunk=chunk)
    want = jchunked(*(_j(a) for a in inputs), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("chunk", [16, 32, 128])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_chunked_matches_sequential_oracle(case, chunk):
    """Any chunk length, the final state included."""
    inputs = _inputs(case, seed=1)
    y, state = ref.ssd_chunked(*(_t(a) for a in inputs), chunk=chunk, return_state=True)
    want_y, want_state = _oracle(inputs)
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    np.testing.assert_allclose(state.numpy(), want_state, **TOL)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_ops_on_cpu_matches_reference_pallas_kernel(case):
    """The port's wrapper on CPU tensors against the reference's Pallas
    kernel (interpret mode) and its oracle."""
    inputs = _inputs(case, seed=2)
    before = ops.launches
    y = ops.ssd_scan(*(_t(a) for a in inputs))
    assert ops.launches == before  # the plain version, no launch
    want = jops.ssd_scan(*(_j(a) for a in inputs), chunk=case[-1])
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(y.numpy(), _oracle(inputs)[0], **TOL)


def test_ops_bf16_matches_reference():
    case = (1, 100, 8, 32, 2, 32, 32)
    x, dt, A, Bm, C = _inputs(case, seed=3)
    bf = lambda a: _t(a).to(torch.bfloat16)
    y = ops.ssd_scan(bf(x), _t(dt), _t(A), bf(Bm), bf(C))
    jb = lambda a: _j(a).astype(jnp.bfloat16)
    want = jchunked(jb(x), _j(dt), _j(A), jb(Bm), jb(C), chunk=32)
    assert y.dtype == torch.bfloat16
    got, want = y.float().numpy(), np.asarray(want.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp + 3e-4 * (1 + np.abs(want)))


def test_ops_returns_the_final_state():
    case = CASES[1]
    inputs = _inputs(case, seed=4)
    y, state = ops.ssd_scan(*(_t(a) for a in inputs), return_state=True)
    want_y, want_state = _oracle(inputs)
    assert state.shape == (1, 8, 32, 32) and state.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    np.testing.assert_allclose(state.numpy(), want_state, **TOL)


def test_chunk_is_clamped_to_short_sequences():
    """S shorter than the chunk: one chunk of length S, as the reference's."""
    case = (1, 5, 2, 16, 1, 16, 128)
    inputs = _inputs(case, seed=5)
    y = ref.ssd_chunked(*(_t(a) for a in inputs))
    np.testing.assert_allclose(y.numpy(), _oracle(inputs)[0], **TOL)


def test_padding_is_identity_on_the_state():
    """dt = 0 rows (the padding) neither decay nor inject: the state after
    S rows equals the state after S rows plus zero-dt rows."""
    case = (1, 40, 2, 16, 1, 16, 16)
    x, dt, A, Bm, C = _inputs(case, seed=6)
    _, s1 = ref.ssd_chunked(*(_t(a) for a in (x, dt, A, Bm, C)), chunk=16, return_state=True)
    dt2 = dt.copy()
    dt2[:, 30:] = 0.0
    _, s2 = ref.ssd_chunked(*(_t(a) for a in (x[:, :30], dt[:, :30], A, Bm[:, :30],
                                               C[:, :30])), chunk=16, return_state=True)
    _, s3 = ref.ssd_chunked(*(_t(a) for a in (x, dt2, A, Bm, C)), chunk=16, return_state=True)
    np.testing.assert_allclose(s3.numpy(), s2.numpy(), **TOL)
    assert not np.allclose(s1.numpy(), s2.numpy())


@pytest.mark.parametrize("bad", ["dt_dtype", "A_shape", "groups", "bc_dtype", "x_rank"])
def test_ops_rejects_bad_operands(bad):
    x, dt, A, Bm, C = (_t(a) for a in _inputs(CASES[1]))
    if bad == "dt_dtype":
        dt = dt.double()
    elif bad == "A_shape":
        A = A[:3]
    elif bad == "groups":  # H = 8 heads over 3 groups
        Bm, C = Bm[:, :, :1].expand(-1, -1, 3, -1), C[:, :, :1].expand(-1, -1, 3, -1)
    elif bad == "bc_dtype":
        Bm = Bm.to(torch.bfloat16)
    else:
        x = x[0]
    with pytest.raises((ValueError, TypeError)):
        ops.ssd_scan(x, dt, A, Bm, C)


#: (B, S, H, P, G, N, chunk, ranges) of the kernel's decomposition: a ragged
#: S in one range and in two; several groups in five ranges; 7 chunks in 5
#: ranges (boundaries 0, 1, 2, 4, 5, 7: ranges of unequal length); 5 chunks
#: in 2 (2 and 3); S shorter than one range (one chunk, so one range)
RANGE_CASES = [
    (2, 300, 4, 16, 1, 16, 32, 1),
    (2, 300, 4, 16, 1, 16, 32, 2),
    (1, 300, 8, 32, 2, 32, 32, 5),
    (1, 224, 4, 16, 4, 16, 32, 5),
    (2, 77, 4, 16, 1, 16, 16, 2),
    (1, 40, 2, 16, 1, 16, 64, 5),
]


def _ranges(case, seed, return_state=False):
    B, S, H, P, G, N, chunk, ranges = case
    inputs = _inputs((B, S, H, P, G, N, chunk), seed=seed)
    out = ref.ssd_ranges(*(_t(a) for a in inputs), chunk=chunk, ranges=ranges,
                         return_state=return_state)
    return inputs, out


@pytest.mark.parametrize("case", RANGE_CASES, ids=str)
def test_ranges_match_sequential_oracle(case):
    """y and the final state against the exact recurrence."""
    inputs, (y, state) = _ranges(case, seed=7, return_state=True)
    want_y, want_state = _oracle(inputs)
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    np.testing.assert_allclose(state.numpy(), want_state, **TOL)


@pytest.mark.parametrize("case", RANGE_CASES, ids=str)
def test_ranges_match_chunked(case):
    """Against the port's ``ssd_chunked`` at the plain version's chunk (what
    the CPU path runs) and the reference's at the same chunk."""
    inputs, y = _ranges(case, seed=8)
    want = ref.ssd_chunked(*(_t(a) for a in inputs), chunk=ops.CHUNK)
    np.testing.assert_allclose(y.numpy(), want.numpy(), **TOL)
    want = jchunked(*(_j(a) for a in inputs), chunk=case[6])
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", RANGE_CASES, ids=str)
def test_ranges_match_reference_pallas_kernel(case):
    """Against the reference's Pallas kernel (interpret mode) at the same chunk."""
    inputs, y = _ranges(case, seed=9)
    want = jops.ssd_scan(*(_j(a) for a in inputs), chunk=case[6])
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)


def test_ranges_past_the_chunk_count_are_one_a_chunk():
    """More ranges than chunks: one range a chunk, the same result as that
    count asked for."""
    case = (1, 100, 2, 16, 1, 16, 32, 9)  # 4 chunks
    inputs, y = _ranges(case, seed=10)
    want = ref.ssd_ranges(*(_t(a) for a in inputs), chunk=32, ranges=4)
    assert torch.equal(y, want)


@pytest.mark.parametrize("bh,nc,per_sm,want", [
    (320, 32, 2, 1),     # mamba2-2.7b's prefill (4, 2048): 320 blocks fill a wave of 264
    (264, 512, 2, 1),    # exactly one wave: no split, however long the sequence
    (80, 512, 2, 13),    # prefill_32k (1, 32768): 80 blocks leave 52 SMs idle
    (80, 32, 2, 3),      # 80 blocks of 32 chunks
    (8, 79, 2, 27),      # (1, 5000) with 8 heads: ranges of 2 and 3 chunks
    (320, 1, 2, 1),      # one chunk: one range
    (10_000, 64, 2, 1),  # many waves already: no split
])
def test_choose_ranges_on_132_sms(bh, nc, per_sm, want):
    """The range count is a function of the shape and the card (132 SMs,
    two blocks an SM), within [1, nc], and 1 once B·H fills a wave."""
    assert ops.choose_ranges(bh, nc, 132, per_sm, per_sm) == want


def test_alignment_check_enforces_16_byte_bases():
    """The kernel reads x, Bm and C rows 16 (fp32) or 8 (bf16) bytes at a
    time: contiguous views that start off 16 bytes are refused. The check
    is plain Python, so it runs here on CPU tensors."""
    x, dt, A, Bm, C = (_t(a) for a in _inputs(CASES[1]))
    ops.check_alignment(x, Bm, C)
    ops.check_alignment(x.to(torch.bfloat16), Bm.to(torch.bfloat16), C.to(torch.bfloat16))
    for shift, dtype in ((1, torch.float32), (2, torch.float32), (4, torch.bfloat16)):
        flat = torch.zeros(x.numel() + 8, dtype=dtype)
        view = flat[shift:shift + x.numel()].view(x.shape)  # contiguous, base off 16 bytes
        assert view.is_contiguous()
        with pytest.raises(ValueError, match="16-byte-aligned x"):
            ops.check_alignment(view, Bm.to(dtype), C.to(dtype))
    flat = torch.zeros(C.numel() + 8)
    with pytest.raises(ValueError, match="16-byte-aligned C"):
        ops.check_alignment(x, Bm, flat[3:3 + C.numel()].view(C.shape))
    ops.check_alignment(x, flat[4:4 + Bm.numel()].view(Bm.shape), C)  # 16 bytes in: fine


def _tf32(x):
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, by bit masking: what cvt.rna.tf32.f32 does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(a, b, passes):
    """a @ b on TF32 operands with an fp32 sum: one pass (hi·hi) or the
    3xTF32 split (hi·lo + lo·hi first, then hi·hi)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh


def _emulated_kernel(x, dt, A, Bm, C, passes, Q=64):
    """The kernel's four products per (b, h) and chunk (one group, S a
    multiple of Q) on emulated tensor cores: C·Bᵀ, the masked scores times
    x, C·state and the state update."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    tri = torch.ones(Q, Q, dtype=torch.bool).tril()
    y = torch.empty(B, S, H, P)
    for b in range(B):
        for h in range(H):
            state = torch.zeros(N, P)
            for s0 in range(0, S, Q):
                xc, dc = x[b, s0:s0 + Q, h], dt[b, s0:s0 + Q, h]
                Bc, Cc = Bm[b, s0:s0 + Q, 0], C[b, s0:s0 + Q, 0]
                L = torch.cumsum(dc * A[h], 0)
                cb = _tf32_product(Cc, Bc.T, passes)
                seg = (L[:, None] - L[None, :]).masked_fill(~tri, 0.0)
                m = torch.where(tri, cb * torch.exp(seg) * dc[None, :], 0.0)
                y[b, s0:s0 + Q, h] = (_tf32_product(m, xc, passes)
                                      + _tf32_product(torch.exp(L)[:, None] * Cc, state, passes))
                w = torch.exp(L[-1] - L) * dc
                state = (torch.exp(L[-1]) * state
                         + _tf32_product((Bc * w[:, None]).T, xc, passes))
    return y


def test_3xtf32_split_keeps_the_kernels_bound():
    """At the kernel's widths (N 128, P 64, chunk 64, four chunks): with
    every product on emulated TF32 tensor cores, the 3xTF32 split stays
    within the kernel's bound against ``ssd_chunked``, 6e-4·(1 + |y|), and
    one TF32 pass misses it. Why the card's fp32 kernel splits every operand."""
    x, dt, A, Bm, C = (_t(a) for a in _inputs((1, 256, 4, 64, 1, 128, 64), seed=11))
    want = ref.ssd_chunked(x, dt, A, Bm, C)
    excess = {n: float(((_emulated_kernel(x, dt, A, Bm, C, n) - want).abs()
                        / (6e-4 * (1 + want.abs()))).max()) for n in (1, 3)}
    assert excess[3] <= 1, excess
    assert excess[1] > 1, excess
