"""The port's int8 codec (`repro_torch.kernels.quantize`) against the JAX
package's oracle `quantize_int8_ref` and its Pallas kernel in interpret
mode.

Tolerances: against `quantize_int8_ref`, `q` and `s` are bitwise equal on
every finite row (the same IEEE division and round-half-to-even); on a
row holding a NaN both give a NaN scale, and `q` there is unspecified.
Against the Pallas kernel in interpret mode `q` is bitwise equal on the
random matrices; its `s` is the oracle's within one ulp, because XLA on
the CPU rewrites ``absmax / 127`` into a multiply by ``1/127`` (the JAX
package's own test holds it to ``rtol=1e-6``). The CUDA kernel runs only
on the card: the test marked `cuda` holds it bitwise against the plain
version there and skips elsewhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quantize import quantize_int8 as pallas_quantize_int8
from repro.kernels.ref import dequantize_int8_ref, quantize_int8_ref
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as qz


def special_rows(rng, cols):
    """A zero row, a row of exact .5 ties after scaling (absmax 254, so
    s = 2 exactly), a row whose values clip at +-127, and a random row."""
    ties = ((np.arange(cols) % 255) - 127).astype(np.float32)
    ties[0] = 254.0
    clip = rng.standard_normal(cols).astype(np.float32)
    clip[0], clip[-1] = 1e30, -1e30
    return np.stack([np.zeros(cols, np.float32), ties, clip,
                     rng.standard_normal(cols).astype(np.float32) * 7.0])


def random_matrix(rng, rows, cols):
    scale = rng.uniform(1e-3, 10.0, (rows, 1)).astype(np.float32)
    return (rng.standard_normal((rows, cols)).astype(np.float32) * scale)


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def ref(x):
    q, s = quantize_int8_ref(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)[:, 0]


def port(x):
    q, s = qz.quantize_int8(torch.from_numpy(x))
    return q.numpy(), s.numpy()


@pytest.mark.parametrize("rows,cols", [(1, 4096), (8, 4096), (33, 256), (16, 1000), (5, 1001), (256, 128)])
def test_plain_matches_the_oracle_bitwise(rows, cols):
    rng = np.random.default_rng([rows, cols])
    x = np.concatenate([random_matrix(rng, rows, cols), special_rows(rng, cols)])
    q, s = port(x)
    qr, sr = ref(x)
    assert q.dtype == np.int8 and s.dtype == np.float32
    assert np.array_equal(q, qr)
    assert np.array_equal(bits(s), bits(sr))


def test_special_rows_quantize_as_specified():
    x = special_rows(np.random.default_rng(3), 512)
    q, s = port(x)
    assert not q[0].any() and s[0] == np.float32(np.float32(1e-12) / np.float32(127.0))
    assert s[1] == 2.0
    halves = x[1] / 2.0
    ties = halves != np.trunc(halves)
    assert ties.any()
    assert np.array_equal(q[1][ties], np.round(halves[ties]).astype(np.int8))  # half to even
    assert q[2][0] == 127 and q[2][-1] == -127 and np.abs(q[2].astype(int)).max() == 127


def test_nan_row_gets_a_nan_scale():
    rng = np.random.default_rng(7)
    x = random_matrix(rng, 6, 300)
    x[2, 17] = np.nan
    x[4, 0] = np.inf
    q, s = port(x)
    qr, sr = ref(x)
    assert np.isnan(s[2]) and np.isnan(sr[2])
    assert s[4] == sr[4] == np.inf
    finite = [0, 1, 3, 5]
    assert np.array_equal(bits(s[finite]), bits(sr[finite]))
    assert np.array_equal(q[finite], qr[finite])


@pytest.mark.parametrize("rows,cols", [(256, 128), (512, 300), (64, 4096)])
def test_plain_matches_the_pallas_kernel_in_interpret_mode(rows, cols):
    rng = np.random.default_rng([rows, cols, 1])
    x = rng.standard_normal((rows, cols)).astype(np.float32) * 3.0
    qp, sp = pallas_quantize_int8(jnp.asarray(x), block_rows=min(256, rows), interpret=True)
    q, s = port(x)
    assert np.array_equal(q, np.asarray(qp))
    ulps = np.abs(bits(s).astype(np.int64) - bits(sp).astype(np.int64))
    assert ulps.max() <= 1


def test_dequantize_and_ops_entry_points():
    rng = np.random.default_rng(11)
    x = random_matrix(rng, 9, 4096)
    q, s = ops.quantize_int8(torch.from_numpy(x))
    qr, sr = quantize_int8_ref(jnp.asarray(x))
    got = ops.dequantize_int8(q, s).numpy()
    assert np.array_equal(bits(got), bits(dequantize_int8_ref(qr, sr)))
    assert (np.abs(got - x) <= s.numpy()[:, None] * 0.5).all()
    assert ops.quantize_int8 is qz.quantize_int8


def test_quantize_rejects_devices_it_has_no_kernel_for():
    with pytest.raises(ValueError, match="cpu or cuda"):
        qz.quantize_int8(torch.zeros((2, 8), device="meta"))


def test_plain_version_does_not_launch_the_kernel():
    before = qz.launches
    qz.quantize_int8(torch.ones((3, 16)))
    assert qz.launches == before


# --------------------------------------------------------------------- #
# on the card                                                           #
# --------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(4096, 4096), (1, 4096), (300, 256), (77, 1000), (5, 1001), (3, 9000)])
def test_kernel_matches_plain_version_on_the_card_bitwise(cuda, rows, cols):
    rng = np.random.default_rng([rows, cols, 2])
    x = np.concatenate([random_matrix(rng, rows, cols), special_rows(rng, cols)])
    x[-1, cols // 2] = np.nan
    xt = torch.from_numpy(x).to(cuda)
    before = qz.launches
    q, s = qz.quantize_int8(xt)
    torch.cuda.synchronize()
    assert qz.launches == before + 1
    qp, sp = qz.quantize_int8_plain(xt)
    assert torch.isnan(s[-1]) and torch.isnan(sp[-1])
    assert torch.equal(q[:-1], qp[:-1])
    assert torch.equal(s[:-1].view(torch.int32), sp[:-1].view(torch.int32))
    # and both against numpy's IEEE quotient on the host
    sh = np.maximum(np.abs(x[:-1]).max(axis=1), np.float32(1e-12)) / np.float32(127.0)
    qh = np.clip(np.round(x[:-1] / sh[:, None]), -127, 127).astype(np.int8)
    assert np.array_equal(bits(s[:-1].cpu()), bits(sh))
    assert np.array_equal(q[:-1].cpu().numpy(), qh)
