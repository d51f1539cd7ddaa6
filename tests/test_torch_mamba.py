"""The port's mamba mixer (`repro_torch.models.mamba`) against the JAX
package's (`repro.models.mamba`), on the CPU, at tiny width (d_model 128,
inner 256, d_state 16, f32), with the JAX weights carried over as they are.

Tolerances: outputs and states at atol = rtol = 1e-5. Both sides compute
in f32; they part by the order of the products' sums (XLA's against
PyTorch's), by exp's last bits, and by the scan itself: the JAX mixer runs
a chunked associative scan, the port the recurrence step by step, which
`tests/test_layers.py` holds to each other at 1e-4. Observed up to ~1e-6 at
these sizes; a wrong conv tail, gate, skip term or state carry moves the
outputs by 1e-2 or more.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as ref_mamba
from repro_torch.models import mamba

D_MODEL, D_STATE = 128, 16
TOL = dict(atol=1e-5, rtol=1e-5)


def weights(seed=0):
    ref = ref_mamba.mamba_init(jax.random.PRNGKey(seed), D_MODEL, d_state=D_STATE,
                               dtype=jnp.float32)
    return ref, {k: torch.from_numpy(np.array(v)) for k, v in ref.items()}


def hidden(B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, D_MODEL)).astype(np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **(tol or TOL))


@pytest.mark.parametrize("S", [1, 13, 40])
def test_mamba_apply_with_state_matches(S):
    """Output, final ssm state and conv tail of one prefill (chunk 16 on
    the JAX side, as the tiny configs use; S = 40 spans 3 chunks)."""
    ref_p, p = weights()
    u = hidden(2, S, seed=S)
    out, st = mamba.mamba_apply(p, torch.from_numpy(u), d_state=D_STATE, return_state=True)
    want, ref_st = ref_mamba.mamba_apply(ref_p, jnp.asarray(u), d_state=D_STATE, chunk=16,
                                         return_state=True)
    assert out.shape == (2, S, D_MODEL) and out.dtype == torch.float32
    close(out, want)
    assert st["ssm"].shape == (2, 2 * D_MODEL, D_STATE) and st["conv"].shape == (2, 3, 2 * D_MODEL)
    close(st["ssm"], ref_st["ssm"])
    close(st["conv"], ref_st["conv"])
    assert torch.equal(mamba.mamba_apply(p, torch.from_numpy(u), d_state=D_STATE), out)


def test_decode_chained_after_prefill_matches():
    """A prefill of 11 tokens, then 5 decode steps, each step's output and
    state against the JAX mixer's."""
    ref_p, p = weights(seed=1)
    u = hidden(3, 16, seed=1)
    _, st = mamba.mamba_apply(p, torch.from_numpy(u[:, :11]), d_state=D_STATE, return_state=True)
    _, ref_st = ref_mamba.mamba_apply(ref_p, jnp.asarray(u[:, :11]), d_state=D_STATE, chunk=16,
                                      return_state=True)
    for t in range(11, 16):
        out, st = mamba.mamba_decode(p, torch.from_numpy(u[:, t:t + 1]), st, d_state=D_STATE)
        want, ref_st = ref_mamba.mamba_decode(ref_p, jnp.asarray(u[:, t:t + 1]), ref_st,
                                              d_state=D_STATE)
        close(out, want)
        close(st["ssm"], ref_st["ssm"])
        close(st["conv"], ref_st["conv"])


def test_prefill_then_decode_equals_one_longer_prefill():
    """The conv tail and the ssm state carry everything: a prefill of 9
    tokens followed by 4 decode steps gives the outputs and the state of
    one prefill of 13, up to the last bits of the projections (a (B, 1, d)
    product is blocked otherwise than a (B, S, d) one)."""
    _, p = weights(seed=2)
    u = torch.from_numpy(hidden(2, 13, seed=2))
    full, full_st = mamba.mamba_apply(p, u, d_state=D_STATE, return_state=True)
    outs = []
    out, st = mamba.mamba_apply(p, u[:, :9], d_state=D_STATE, return_state=True)
    outs.append(out)
    for t in range(9, 13):
        out, st = mamba.mamba_decode(p, u[:, t:t + 1], st, d_state=D_STATE)
        outs.append(out)
    close(torch.cat(outs, dim=1), full, atol=1e-6, rtol=1e-6)
    close(st["ssm"], full_st["ssm"], atol=1e-6, rtol=1e-6)
    close(st["conv"], full_st["conv"], atol=1e-6, rtol=1e-6)


def test_the_scan_core_is_the_kernels_wrapper_unless_given_another():
    """The default core is `ops.ssm_scan` (its plain version on the CPU);
    `scan_impl` replaces it, and gets f32 dt, Bm, Cm, A, contiguous."""
    _, p = weights(seed=3)
    u = torch.from_numpy(hidden(2, 7, seed=3))
    seen = []

    def core(dt, Bm, Cm, x, A, h0):
        seen.append([t.dtype for t in (dt, Bm, Cm, A)]
                    + [all(t.is_contiguous() for t in (dt, Bm, Cm, x, A))])
        return torch.zeros_like(dt), torch.zeros((2, 256, D_STATE))

    base = mamba.mamba_apply(p, u, d_state=D_STATE)
    other = mamba.mamba_apply(p, u, d_state=D_STATE, scan_impl=core)
    assert seen == [[torch.float32] * 4 + [True]]
    assert float((base - other).abs().max()) > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_init_shapes_dtypes_and_distributions(dtype):
    """Leaf names, shapes and dtypes are the JAX package's. A_log is
    log(1..d_state) correctly rounded to f32, which is within one ulp of
    XLA's (its log(7) is one ulp off); the rest are random draws, held to
    their distributions."""
    ref_p = ref_mamba.mamba_init(jax.random.PRNGKey(0), D_MODEL, d_state=D_STATE,
                                 dtype=getattr(jnp, dtype))
    gen = torch.Generator().manual_seed(0)
    mine = mamba.mamba_init(gen, D_MODEL, d_state=D_STATE, dtype=getattr(torch, dtype))
    assert sorted(mine) == sorted(ref_p)
    for name, v in ref_p.items():
        assert tuple(mine[name].shape) == v.shape, name
        assert str(mine[name].dtype).split(".")[1] == str(v.dtype), name
    exact = torch.tensor([math.log(n) for n in range(1, D_STATE + 1)], dtype=torch.float32)
    assert torch.equal(mine["A_log"], exact.repeat(2 * D_MODEL, 1))
    close(mine["A_log"], ref_p["A_log"], atol=0.0, rtol=2**-23)
    assert torch.equal(mine["D"], torch.ones(2 * D_MODEL))
    assert float(mine["conv_b"].abs().max()) == 0.0
    dt = torch.nn.functional.softplus(mine["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-3) and float(dt.max()) <= 0.1 * (1 + 1e-3)
    assert float(dt.log().std()) > 0.5  # log-uniform over two decades, not a constant
    for name, fan_in in (("in_proj", D_MODEL), ("x_proj", 2 * D_MODEL), ("conv_w", 4)):
        std = float(mine[name].to(torch.float32).std()) * math.sqrt(fan_in)
        assert abs(std - 1.0) < 0.1, name
