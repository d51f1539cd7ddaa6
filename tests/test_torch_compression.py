"""The port's upload codecs and batched FedAvg step
(`repro_torch.fleet.compression`) against the JAX package's.

Tolerances: the int8 and null codecs are bitwise equal in both directions
(the same per-row absmax, IEEE division and round-half-to-even); top-k on
distinct magnitudes selects the same index set and decodes bitwise equal
(the order of the indices may differ); on tied magnitudes it selects
and orders the indices as `jax.lax.top_k` does, bitwise. `flatten_pytree`
gives the same flat vector, leaves in `jax.tree.flatten`'s order (a
dict's keys sorted, an `OrderedDict`'s in insertion order), and a
namedtuple comes back as its own type.
Error feedback carries its residual bitwise for three steps.
`batched_dequant_mean` is one f32 contraction over the client axis whose
summation order differs between XLA and torch: rtol 1e-6, atol 1e-7.
"""
from collections import OrderedDict, namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fleet import compression as ref_c
from repro_torch.fleet import compression as c


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def delta(rng, n, scale=0.05):
    return (rng.standard_normal(n) * scale).astype(np.float32)


@pytest.mark.parametrize("n,row", [(5000, 4096), (4096, 4096), (300, 256), (1, 128)])
def test_int8_codec_round_trip_matches_reference_bitwise(n, row):
    x = delta(np.random.default_rng([n, row]), n)
    msg = c.Int8Codec(row=row).encode(torch.from_numpy(x))
    ref_msg = ref_c.Int8Codec(row=row).encode(jnp.asarray(x))
    assert msg["kind"] == ref_msg["kind"] and msg["n"] == ref_msg["n"] == n
    assert np.array_equal(msg["q"].numpy(), np.asarray(ref_msg["q"]))
    assert np.array_equal(bits(msg["s"]), bits(ref_msg["s"]))
    got = c.Int8Codec(row=row).decode(msg)
    assert np.array_equal(bits(got), bits(ref_c.Int8Codec(row=row).decode(ref_msg)))
    assert c.Int8Codec(row=row).nbytes(msg) == ref_c.Int8Codec(row=row).nbytes(ref_msg)


def test_null_codec_is_the_identity_on_both_sides():
    x = delta(np.random.default_rng(1), 77)
    msg = c.NullCodec().encode(torch.from_numpy(x))
    assert np.array_equal(bits(c.NullCodec().decode(msg)), bits(x))
    assert c.NullCodec().nbytes(msg) == ref_c.NullCodec().nbytes(ref_c.NullCodec().encode(jnp.asarray(x)))


def test_topk_codec_selects_the_same_entries():
    rng = np.random.default_rng(2)
    x = rng.permutation(np.arange(1, 2001, dtype=np.float32)) * rng.choice([-1.0, 1.0], 2000).astype(np.float32)
    x /= np.float32(1000.0)  # distinct magnitudes, no ties
    codec, ref_codec = c.TopKCodec(fraction=0.03), ref_c.TopKCodec(fraction=0.03)
    msg, ref_msg = codec.encode(torch.from_numpy(x)), ref_codec.encode(jnp.asarray(x))
    assert set(msg["idx"].tolist()) == set(np.asarray(ref_msg["idx"]).tolist())
    assert msg["idx"].dtype == torch.int32 and len(msg["idx"]) == 60
    assert np.array_equal(bits(codec.decode(msg)), bits(ref_codec.decode(ref_msg)))
    assert codec.nbytes(msg) == ref_codec.nbytes(ref_msg)


def test_topk_codec_breaks_ties_as_lax_top_k():
    rng = np.random.default_rng(5)
    x = (rng.choice([1.0, 2.0, 3.0], 2000) * rng.choice([-1.0, 1.0], 2000) / 8).astype(np.float32)
    codec, ref_codec = c.TopKCodec(fraction=0.03), ref_c.TopKCodec(fraction=0.03)
    msg, ref_msg = codec.encode(torch.from_numpy(x)), ref_codec.encode(jnp.asarray(x))
    assert msg["idx"].tolist() == np.asarray(ref_msg["idx"]).tolist()
    assert np.array_equal(bits(msg["val"]), bits(ref_msg["val"]))
    assert np.array_equal(bits(codec.decode(msg)), bits(ref_codec.decode(ref_msg)))


@pytest.mark.parametrize("n,fraction", [(2000, 0.03), (4097, 0.1), (10, 1.0)])
def test_topk_codec_orders_entries_above_and_at_the_cut_as_lax_top_k(n, fraction):
    # a few entries above the k-th magnitude, many tied at it, the rest below
    rng = np.random.default_rng(n)
    mags = rng.choice([1.0, 2.0, 3.0, 4.0, 5.0], n, p=[0.5, 0.3, 0.15, 0.04, 0.01])
    x = (mags * rng.choice([-1.0, 1.0], n) / 8).astype(np.float32)
    codec, ref_codec = c.TopKCodec(fraction=fraction), ref_c.TopKCodec(fraction=fraction)
    msg, ref_msg = codec.encode(torch.from_numpy(x)), ref_codec.encode(jnp.asarray(x))
    assert msg["idx"].tolist() == np.asarray(ref_msg["idx"]).tolist()
    assert np.array_equal(bits(msg["val"]), bits(ref_msg["val"]))


def test_make_codec_builds_the_same_codecs():
    assert c.make_codec("int8", row=64) == c.Int8Codec(row=64)
    assert isinstance(c.make_codec("topk"), c.TopKCodec)
    assert isinstance(c.make_codec("none"), c.NullCodec)
    with pytest.raises(KeyError):
        c.make_codec("zip")


def nested(rng, lib):
    """A parameter tree with unsorted dict keys, a list, a tuple, a None
    and mixed shapes; `lib` makes the leaves (torch or jnp)."""
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    d = rng.standard_normal((2, 2, 2)).astype(np.float32)
    e = np.asarray(rng.standard_normal(), np.float32)  # a 0-d leaf
    return {"zeta": lib(a), "alpha": [lib(b), {"y": lib(d), "x": lib(e)}],
            "mid": (lib(b * 2),), "none": None}


def test_flatten_pytree_orders_leaves_as_jax_does():
    rng = np.random.default_rng(3)
    tree = nested(rng, torch.from_numpy)
    ref_tree = nested(np.random.default_rng(3), jnp.asarray)
    flat, td, shapes = c.flatten_pytree(tree)
    ref_flat, _, ref_shapes = ref_c.flatten_pytree(ref_tree)
    assert np.array_equal(bits(flat), bits(ref_flat))
    assert [s for s, _ in shapes] == [tuple(s) for s, _ in ref_shapes]
    back = c.unflatten_pytree(flat, td, shapes)
    assert list(back) == sorted(tree) and back["none"] is None
    assert isinstance(back["alpha"], list) and isinstance(back["mid"], tuple)
    for x, y in zip(c.tree_leaves(back), c.tree_leaves(tree)):
        assert x.shape == y.shape and torch.equal(x, y)


Pair = namedtuple("Pair", ["w", "b"])


def test_flatten_pytree_keeps_an_ordered_dicts_insertion_order():
    def tree(lib):
        return OrderedDict([("b", [lib(np.float32([1, 2]))]), ("a", lib(np.float32([3])))])

    flat, td, shapes = c.flatten_pytree(tree(torch.tensor))
    ref_flat, _, _ = ref_c.flatten_pytree(tree(jnp.asarray))
    assert np.array_equal(bits(flat), bits(ref_flat))
    assert flat.tolist() == [1.0, 2.0, 3.0]
    back = c.unflatten_pytree(flat, td, shapes)
    assert type(back) is OrderedDict and list(back) == ["b", "a"]


def test_unflatten_pytree_rebuilds_a_namedtuple_as_its_type():
    def tree(lib):
        return {"layer": Pair(lib(np.float32([[1, 2]])), lib(np.float32([5]))),
                "rest": (lib(np.float32([7])),)}

    flat, td, shapes = c.flatten_pytree(tree(torch.tensor))
    ref_flat, ref_td, ref_shapes = ref_c.flatten_pytree(tree(jnp.asarray))
    assert np.array_equal(bits(flat), bits(ref_flat))
    back = c.unflatten_pytree(flat, td, shapes)
    ref_back = ref_c.unflatten_pytree(ref_flat, ref_td, ref_shapes)
    assert type(back["layer"]) is Pair is type(ref_back["layer"])
    assert type(back["rest"]) is tuple is type(ref_back["rest"])
    assert jax.tree.structure(ref_back) == jax.tree.structure(
        c.tree_map(lambda t: t.numpy(), back))


def test_error_feedback_carries_the_residual_as_the_reference():
    rng = np.random.default_rng(4)
    steps = [delta(rng, 700, scale=s) for s in (0.1, 0.02, 0.3)]
    ef, ref_ef = c.ErrorFeedback(c.Int8Codec(row=256)), ref_c.ErrorFeedback(ref_c.Int8Codec(row=256))
    for x in steps:
        msg, ref_msg = ef.compress(torch.from_numpy(x)), ref_ef.compress(jnp.asarray(x))
        assert np.array_equal(msg["q"].numpy(), np.asarray(ref_msg["q"]))
        assert np.array_equal(bits(msg["s"]), bits(ref_msg["s"]))
        assert np.array_equal(bits(ef._residual), bits(ref_ef._residual))
    assert (ef.bytes_sent, ef.bytes_raw) == (ref_ef.bytes_sent, ref_ef.bytes_raw)
    assert ef.compression_ratio == ref_ef.compression_ratio


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("N,R,row", [(1, 1, 256), (37, 3, 256), (200, 2, 4096)])
def test_batched_dequant_mean_matches_reference(N, R, row, weighted):
    rng = np.random.default_rng([N, R, row, weighted])
    q = rng.integers(-127, 128, (N, R, row), dtype=np.int8)
    s = rng.uniform(1e-4, 1e-2, (N, R)).astype(np.float32)
    w = rng.integers(1, 64, N).astype(np.float32) if weighted else None
    got = c.batched_dequant_mean(q, s, w, device="cpu")
    want = ref_c.batched_dequant_mean(q, s, w)
    assert got.shape == want.shape == (R, row) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
