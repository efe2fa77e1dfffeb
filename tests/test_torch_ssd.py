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
