"""The port's selective scan (`repro_torch.kernels.ssm_scan`) against the
JAX package's oracle `ssm_scan_ref` and its Pallas kernel in interpret
mode.

Inputs come from numpy with fixed seeds and the distributions of the JAX
package's own kernel sweep (tests/test_kernels.py): dt = softplus(normal)
· 0.1, Bm, Cm, x normal, A = -exp(0.5 · normal). Tolerance: atol 1e-4, the
JAX package's for this scan (tests/test_layers.py holds its chunked scan to
`ssm_scan_ref` at 1e-4); both sides run the same f32 recurrence and part
only by the order of y's state sum and by exp's last bits (observed below
2e-6).

On the CPU the wrapper runs the plain version. The tests marked `cuda`
hold the CUDA kernel against the plain version on the card, elementwise
within `ssm_scan_tolerance` (the bound f32 rounding puts on two
evaluations of the recurrence), and skip where there is no card. Here that
bound is shown to admit the JAX oracle and to refuse a scan that drops one
time step's update or loses the carried state.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.ssm_scan import ssm_scan as pallas_scan
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_scan as sc

TOL = dict(atol=1e-4, rtol=0.0)


def inputs(B, S, inner, state, *, seed=0, x_bf16=False, h0=False):
    """numpy f32 arrays (dt, Bm, Cm, x, A[, h0]); x rounded to bf16 once,
    by jax, when `x_bf16`."""
    rng = np.random.default_rng([B, S, inner, state, seed])
    z = rng.standard_normal((B, S, inner)).astype(np.float32)
    dt = (np.logaddexp(z, 0.0) * 0.1).astype(np.float32)
    Bm = rng.standard_normal((B, S, state)).astype(np.float32)
    Cm = rng.standard_normal((B, S, state)).astype(np.float32)
    x = rng.standard_normal((B, S, inner)).astype(np.float32)
    A = (-np.exp(rng.standard_normal((inner, state)) * 0.5)).astype(np.float32)
    if x_bf16:
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    out = [dt, Bm, Cm, x, A]
    if h0:
        out.append(rng.standard_normal((B, inner, state)).astype(np.float32))
    return out


def to_torch(arrays, x_bf16=False):
    t = [torch.from_numpy(a) for a in arrays]
    if x_bf16:
        t[3] = t[3].to(torch.bfloat16)
    return t


PALLAS_CASES = [  # B, S, inner, state, block_inner, chunk (tests/test_kernels.py)
    (2, 64, 128, 16, 64, 32),
    (1, 128, 64, 8, 64, 64),
    (2, 128, 256, 16, 128, 128),
    (1, 64, 64, 4, 32, 16),
]


@pytest.mark.parametrize("B,S,inner,state,block_inner,chunk", PALLAS_CASES)
def test_plain_matches_the_pallas_kernel_in_interpret_mode(B, S, inner, state, block_inner,
                                                           chunk):
    arrays = inputs(B, S, inner, state)
    want = pallas_scan(*map(jnp.asarray, arrays), block_inner=block_inner, chunk=chunk,
                       interpret=True)
    y, h = sc.ssm_scan_plain(*to_torch(arrays))
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, inner) and h.shape == (B, inner, state)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("x_bf16", [False, True])
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("B,S,inner,state", [(2, 1, 32, 16), (2, 37, 48, 16), (1, 64, 16, 8)])
def test_plain_matches_ssm_scan_ref(B, S, inner, state, h0, x_bf16):
    """y and the final state, with and without h0, at S = 1 (a decode
    step) and a ragged S; x in bf16 as the mixer passes it on the card."""
    arrays = inputs(B, S, inner, state, seed=1, x_bf16=x_bf16, h0=h0)
    jx = [jnp.asarray(a) for a in arrays]
    if x_bf16:
        jx[3] = jx[3].astype(jnp.bfloat16)
    want_y, want_h = ref.ssm_scan_ref(*jx[:5], h0=jx[5] if h0 else None)
    t = to_torch(arrays, x_bf16)
    y, h = sc.ssm_scan_plain(*t[:5], t[5] if h0 else None)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)


def test_the_state_carries_across_calls():
    """Two scans chained through the returned state equal one scan."""
    dt, Bm, Cm, x, A = to_torch(inputs(2, 40, 32, 16, seed=2))
    y, h = sc.ssm_scan_plain(dt, Bm, Cm, x, A)
    y1, h1 = sc.ssm_scan_plain(dt[:, :25], Bm[:, :25], Cm[:, :25], x[:, :25], A)
    y2, h2 = sc.ssm_scan_plain(dt[:, 25:], Bm[:, 25:], Cm[:, 25:], x[:, 25:], A, h1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y) and torch.equal(h2, h)


def over_tol(got, want, tol):
    """max |got - want| / tol over y and h; at most 1 passes."""
    return max(float(((g - w).abs() / t).max()) for g, w, t in zip(got, want, tol))


def dropped_step(dt, Bm, Cm, x, A, h0, t):
    """What a scan that skipped step t's update would return."""
    y1, h1 = sc.ssm_scan_plain(dt[:, :t], Bm[:, :t], Cm[:, :t], x[:, :t], A, h0)
    y_t = (h1 * Cm[:, t][:, None, :]).sum(-1)[:, None]
    y2, h2 = sc.ssm_scan_plain(dt[:, t + 1:], Bm[:, t + 1:], Cm[:, t + 1:], x[:, t + 1:], A, h1)
    return torch.cat([y1, y_t, y2], dim=1), h2


@pytest.mark.parametrize("B,S,inner,state", [(2, 1, 32, 16), (2, 37, 48, 16), (1, 300, 64, 16)])
def test_the_tolerance_admits_the_oracle_and_refuses_a_faulty_scan(B, S, inner, state):
    """The check `chip_smoke.py` and the card tests use: `ssm_scan_ref`
    (XLA's exp and sum order) lies within `ssm_scan_tolerance` of the
    plain version, while dropping step S // 2 or ignoring h0 breaks it
    many times over."""
    arrays = inputs(B, S, inner, state, seed=5, h0=True)
    t = to_torch(arrays)
    plain = sc.ssm_scan_plain(*t)
    tol = sc.ssm_scan_tolerance(*t)
    want = [torch.from_numpy(np.array(a)) for a in
            ref.ssm_scan_ref(*map(jnp.asarray, arrays[:5]), h0=jnp.asarray(arrays[5]))]
    assert over_tol(want, plain, tol) <= 1.0
    assert over_tol(dropped_step(*t, S // 2), plain, tol) > 100.0
    assert over_tol(sc.ssm_scan_plain(*t[:5]), plain, tol) > 100.0


def test_the_wrapper_runs_the_plain_version_on_the_cpu():
    t = to_torch(inputs(2, 9, 32, 16, seed=3, h0=True))
    before = sc.launches
    y, h = ops.ssm_scan(*t)
    want_y, want_h = sc.ssm_scan_plain(*t)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert sc.launches == before  # the plain version launches nothing


def test_the_wrapper_refuses_other_devices():
    dt = torch.empty((1, 4, 8), device="meta")
    bm = torch.empty((1, 4, 16), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        sc.ssm_scan(dt, bm, bm, dt, torch.empty((8, 16), device="meta"))


# --------------------------------------------------------------------- #
# on the card                                                            #
# --------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU path)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("x_bf16", [False, True])
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("B,S,inner,state", [(2, 1, 32, 16), (2, 37, 48, 16), (1, 64, 16, 16),
                                             (4, 48, 1024, 16), (2, 333, 1000, 16),
                                             (1, 70, 130, 16), (3, 5, 7, 16)])
def test_kernel_matches_plain_version_on_the_card(cuda, B, S, inner, state, h0, x_bf16):
    t = [a.to(cuda) for a in to_torch(inputs(B, S, inner, state, seed=4, x_bf16=x_bf16,
                                              h0=h0), x_bf16)]
    before = sc.launches
    got = sc.ssm_scan(*t)
    torch.cuda.synchronize()
    assert sc.launches == before + 1
    want = sc.ssm_scan_plain(*t)
    assert got[0].shape == (B, S, inner) and got[1].shape == (B, inner, state)
    assert over_tol(got, want, sc.ssm_scan_tolerance(*t)) <= 1.0


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    dt, Bm, Cm, x, A = [a.to(cuda) for a in to_torch(inputs(1, 8, 32, 16))]
    with pytest.raises(ValueError, match="x must be float32 or bfloat16"):
        sc.ssm_scan(dt, Bm, Cm, x.half(), A)
    with pytest.raises(ValueError, match="dt must be float32"):
        sc.ssm_scan(dt.to(torch.bfloat16), Bm, Cm, x, A)
    with pytest.raises(ValueError, match="contiguous"):
        sc.ssm_scan(dt, Bm, Cm, x, A.t().contiguous().t())
    with pytest.raises(ValueError, match="d_state"):
        narrow = torch.zeros((1, 8, 8), device=cuda)
        sc.ssm_scan(dt, narrow, narrow, x, torch.zeros((32, 8), device=cuda))
    with pytest.raises(ValueError, match="does not match"):
        sc.ssm_scan(dt, Bm, Cm, x[:, :4], A)
