"""The port's sketch fold (`repro_torch.kernels.sketch`) against the JAX
package's (`repro.kernels.sketch`).

Tolerance: bitwise, NaN bit patterns included. The fold is singly-rounded
f32 arithmetic in the reference's operation order plus pure selection,
so there is nothing to round differently. The JAX side runs its jnp twin
(`_fold_xla`, ``backend="xla"``) on the CPU, and `sketch_reference` is the
per-vehicle numpy oracle both are held to. The CUDA kernel itself runs
only on the card: the tests marked `cuda` hold it against the plain fold
there and skip elsewhere.
"""
import numpy as np
import pytest
import torch

from repro.kernels import sketch as ref_sk
from repro_torch.kernels import sketch as sk


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def random_window(rng, W, n, scale, p_nan):
    """(W, n) f32 window around a random offset, a share of NaN, and the
    first column all NaN (a vehicle with no observation)."""
    x = rng.standard_normal((W, n)) * scale + rng.uniform(-1, 1) * scale
    x = x.astype(np.float32)
    x[rng.random((W, n)) < p_nan] = np.nan
    x[:, 0] = np.nan
    return x


def assert_rows_match_oracle(fleet, x, spec):
    """Every column's sketch equals `sketch_reference` over that column's
    observed values, bit for bit."""
    for i in range(x.shape[1]):
        want = sk.sketch_reference([v for v in x[:, i] if not np.isnan(v)], spec)
        got = fleet.row(i)
        assert got["count"] == want["count"] and got["hist"] == want["hist"]
        assert bits(got["mean"]) == bits(want["mean"])
        assert bits(got["m2"]) == bits(want["m2"])
        assert np.array_equal(bits(got["qsk"]), bits(want["qsk"]))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
@pytest.mark.parametrize("K", [1, 32])
@pytest.mark.parametrize("bins", [1, 16])
def test_plain_fold_matches_xla_fold_and_oracle_bitwise(bins, K, scale):
    rng = np.random.default_rng([bins, K, int(np.log10(scale)) + 3])
    for W, n, p_nan in [(2, 5, 0.0), (17, 33, 0.3), (64, 48, 0.9)]:
        x = random_window(rng, W, n, scale, p_nan)
        spec = sk.SketchSpec(window=W, bins=bins, lo=-scale, hi=scale, quantile_k=K)
        want = np.asarray(ref_sk.fold_window(x, ref_sk.SketchSpec(
            window=W, bins=bins, lo=-scale, hi=scale, quantile_k=K), backend="xla"))
        got = sk.fold_window(x, spec, device="cpu")
        assert got.dtype == torch.float32 and got.shape == (spec.dim, n)
        assert np.array_equal(bits(got.numpy()), bits(want))
        assert_rows_match_oracle(sk.sketches_from_device(spec, got.numpy()), x, spec)


def test_single_sample_window_matches_the_numpy_oracle():
    """W = 1: M2 is ``0 + d * (v - v)``, which IEEE rounds to +0.0 for a
    negative sample. The port and `sketch_reference` give +0.0; the JAX
    package's `_fold_xla` gives -0.0 there (XLA folds the ``0 +``), so the
    port is held to the oracle."""
    x = np.array([[-0.25, 0.5, np.nan]], np.float32)
    spec = sk.SketchSpec(window=1, bins=4, lo=-1.0, hi=1.0, quantile_k=2)
    out = sk.fold_window(x, spec, device="cpu").numpy()
    assert bits(out[2, 0]) == bits(np.float32(0.0))
    assert_rows_match_oracle(sk.sketches_from_device(spec, out), x, spec)


@pytest.mark.parametrize(
    "t,hist_len,window",
    [(0, 1, 8), (5, 6, 8), (40, 16, 8), (3, 4, 64), (200, 16, 16), (17, 16, 100)],
)
def test_sketch_ring_matches_reference_ring_fold(t, hist_len, window):
    """The window gather (floor-mod slots, NaN before the recorded
    history) and the fold over the port's signal-major ring equal the JAX
    package's over its client-major ring, bitwise."""
    rng = np.random.default_rng([t, hist_len, window])
    hist_cap, n, S = 16, 37, 3
    ring = rng.normal(6.0, 3.0, (hist_cap, n, S)).astype(np.float32)
    ring[rng.random(ring.shape) < 0.2] = np.nan
    spec = sk.SketchSpec(window=window, bins=8, lo=0.0, hi=12.0, quantile_k=4)
    ref_spec = ref_sk.SketchSpec(window=window, bins=8, lo=0.0, hi=12.0, quantile_k=4)
    port_ring = torch.from_numpy(np.ascontiguousarray(ring.transpose(0, 2, 1)))
    for col in range(S):
        want = np.asarray(ref_sk.sketch_ring(ring, t, hist_len, col, ref_spec, backend="xla"))
        got = sk.sketch_ring(port_ring, t, hist_len, col, spec)
        assert np.array_equal(bits(got.numpy()), bits(want))


def test_cpu_tensors_run_the_plain_fold_and_launch_nothing():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(random_window(rng, 12, 9, 2.0, 0.2))
    xs = torch.sort(x, dim=0).values
    spec = sk.SketchSpec(window=12, bins=5, lo=-2.0, hi=2.0, quantile_k=3)
    edges = torch.from_numpy(spec.edges())
    before = sk.launches
    out = sk.sketch_fold(x, xs, edges, spec.quantile_k)
    assert sk.launches == before
    assert torch.equal(out.view(torch.int32), sk.fold_plain(x, xs, edges, 3).view(torch.int32))


def test_sketch_fold_rejects_devices_it_has_no_kernel_for():
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        sk.sketch_fold(x, x, torch.zeros(0, device="meta"), 2)


def test_fold_window_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sk.fold_window(np.zeros((4, 3), np.float32), sk.SketchSpec(window=4))


def test_numpy_half_is_the_reference_numpy_half():
    """SketchSpec, sketch_reference and the host containers are a copy."""
    spec = sk.SketchSpec(window=9, bins=7, lo=-3.0, hi=5.0, quantile_k=5)
    ref_spec = ref_sk.SketchSpec(window=9, bins=7, lo=-3.0, hi=5.0, quantile_k=5)
    assert spec.dim == ref_spec.dim
    assert np.array_equal(bits(spec.edges()), bits(ref_spec.edges()))
    xs = [1.5, -2.0, 4.25, 0.0, 7.0]
    assert sk.sketch_reference(xs, spec) == ref_sk.sketch_reference(xs, ref_spec)
    assert sk.empty_fleet_sketches(spec, 3).row(1) == ref_sk.sketch_reference([], ref_spec)
    for bad in ({"window": 0}, {"bins": 0}, {"quantile_k": 0}):
        with pytest.raises(ValueError):
            sk.SketchSpec(**bad)


# --------------------------------------------------------------------- #
# on the card                                                           #
# --------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("W,n,bins,K", [(64, 5000, 16, 32), (256, 4097, 16, 32), (16, 300, 1, 1)])
def test_kernel_matches_plain_fold_on_the_card_bitwise(cuda, W, n, bins, K):
    rng = np.random.default_rng([W, n, bins, K])
    x = torch.from_numpy(random_window(rng, W, n, 10.0, 0.1)).to(cuda)
    xs = torch.sort(x, dim=0).values.contiguous()
    spec = sk.SketchSpec(window=W, bins=bins, lo=-10.0, hi=10.0, quantile_k=K)
    edges = torch.from_numpy(spec.edges()).to(cuda)
    before = sk.launches
    got = sk.sketch_fold(x, xs, edges, K)
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    want = sk.fold_plain(x, xs, edges, K)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((8, 4), device=cuda)
    e = torch.zeros(3, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        sk.sketch_fold(x.double(), x.double(), e, 2)
    with pytest.raises(ValueError, match="contiguous"):
        sk.sketch_fold(x.t(), x.t(), e, 2)
    with pytest.raises(ValueError, match="need x, xs"):
        sk.sketch_fold(x, x[:4], e, 2)
