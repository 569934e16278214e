"""The port's threefry PRNG (`lmrl_gym_torch/core/threefry.py`) against
`jax.random` on the CPU, bit for bit: keys, `split` (the host's
Python-int path and the tensor path) and `fold_in`; raw
bits; `uniform` (minval 0 and tiny, and an odd span); `randint` over the
ranges the Wordle gate draws and the full int32 range; `gumbel` (every one
of the 2^23 values its uniform takes, through XLA's CPU logarithm) and
`categorical` over −inf-masked logits; hypothesis-drawn seeds and odd
shapes. `normal` and `truncated_normal` within 1e-6 (XLA's erf⁻¹
polynomial over an f64 log1p), and the same across torch's thread counts.
Also flax's per-parameter init keys (`flax_param_key`) against flax's own
`LazyRng` fold.

The layout this jax uses is the partitionable one: the test asserts the
flag, so a jax with another default fails here first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lmrl_gym_torch.core import threefry as tf

SEEDS = (0, 5, 1000, 2001, -3, 2 ** 31 - 1, -2 ** 31)
TINY = float(np.finfo(np.float32).tiny)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the draws' many elementwise passes run faster
    alone than split across a shared machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


def _keys(seed):
    return jax.random.PRNGKey(seed), tf.PRNGKey(seed)


def test_jax_uses_the_partitionable_threefry_layout():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable is True
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in(seed):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(_np(tk), np.asarray(jax.random.key_data(jk)))
    for n in (2, 3, 4, 6, 10):
        np.testing.assert_array_equal(_np(tf.split(tk, n)), np.asarray(jax.random.split(jk, n)), err_msg=f"split {n}")
    for data in (0, 7, 12345, 2 ** 32 - 1):
        np.testing.assert_array_equal(_np(tf.fold_in(tk, data)), np.asarray(jax.random.fold_in(jk, data)))
    # a batch of keys splits as each key does, on the host's Python-int path
    # (up to 64 keys) and on the tensor path (more, or on a device)
    batch = tf.split(tk, 3)
    np.testing.assert_array_equal(_np(tf.split(batch, 4)[1]), np.asarray(jax.random.split(jax.random.split(jk, 3)[1], 4)))
    many = tf.split(tk, 100)
    np.testing.assert_array_equal(_np(tf.split(many, 6)), np.asarray(jax.vmap(lambda k: jax.random.split(k, 6))(
        jax.random.split(jk, 100))))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_randint(seed):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(_np(tf.random_bits(tk, (3, 7))), np.asarray(jax.random.bits(jk, (3, 7))))
    for lo, hi in ((0.0, 1.0), (TINY, 1.0), (-1.3, 2.7)):
        np.testing.assert_array_equal(_np(tf.uniform(tk, (5, 11), lo, hi)),
                                      np.asarray(jax.random.uniform(jk, (5, 11), minval=lo, maxval=hi)), err_msg=(lo, hi))
    for lo, hi in ((0, 431), (0, 1), (0, 7), (0, 2), (0, 70_000), (-2 ** 31, 2 ** 31 - 1), (5, 3)):
        np.testing.assert_array_equal(_np(tf.randint(tk, (64,), lo, hi)), np.asarray(jax.random.randint(jk, (64,), lo, hi)),
                                      err_msg=(lo, hi))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_and_categorical(seed):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(_np(tf.gumbel(tk, (64, 431))), np.asarray(jax.random.gumbel(jk, (64, 431))))
    logits = np.random.RandomState(seed % 1000).randn(48, 320).astype(np.float32)
    logits[:, 259:] = -np.inf  # the padded vocab
    logits[np.random.RandomState(1).rand(48, 320) < 0.7] = -np.inf  # a consistent-word mask
    logits[0, :] = -np.inf  # every logit masked: the first index, as jnp.argmax
    logits[1, :] = 0.0
    np.testing.assert_array_equal(_np(tf.categorical(tk, torch.from_numpy(logits))),
                                  np.asarray(jax.random.categorical(jk, logits)))


def test_every_gumbel_value():
    """The Gumbel noise is a function of the top 23 bits: all 2^23 values
    against XLA's −log(−log(U)) on the same uniforms."""
    k = np.arange(1 << 23, dtype=np.uint32)
    f = (jax.lax.bitcast_convert_type(jnp.asarray(k) | jnp.uint32(0x3F800000), jnp.float32) - 1.0)
    u = jnp.maximum(f * (1.0 - TINY) + TINY, TINY)
    want = np.asarray(jax.jit(lambda u: -jnp.log(-jnp.log(u)))(u))
    np.testing.assert_array_equal(_np(tf._gumbel_table("cpu")), want)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(-2 ** 31, 2 ** 31 - 1), shape=st.lists(st.integers(1, 9), min_size=1, max_size=3),
       data=st.integers(0, 2 ** 32 - 1), n=st.integers(1, 9), hi=st.integers(1, 2 ** 31 - 1))
def test_random_seeds_and_odd_shapes(seed, shape, data, n, hi):
    jk, tk = _keys(seed)
    shape = tuple(shape)
    np.testing.assert_array_equal(_np(tf.split(tk, n)), np.asarray(jax.random.split(jk, n)))
    np.testing.assert_array_equal(_np(tf.fold_in(tk, data)), np.asarray(jax.random.fold_in(jk, data)))
    np.testing.assert_array_equal(_np(tf.random_bits(tk, shape)), np.asarray(jax.random.bits(jk, shape)))
    np.testing.assert_array_equal(_np(tf.uniform(tk, shape)), np.asarray(jax.random.uniform(jk, shape)))
    np.testing.assert_array_equal(_np(tf.randint(tk, shape, 0, hi)), np.asarray(jax.random.randint(jk, shape, 0, hi)))
    np.testing.assert_array_equal(_np(tf.gumbel(tk, shape)), np.asarray(jax.random.gumbel(jk, shape)))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_and_truncated_normal(seed):
    jk, tk = _keys(seed)
    np.testing.assert_allclose(_np(tf.normal(tk, (96, 97))), np.asarray(jax.random.normal(jk, (96, 97))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(tf.truncated_normal(tk, -2.0, 2.0, (96, 97))),
                               np.asarray(jax.random.truncated_normal(jk, -2.0, 2.0, (96, 97))), rtol=0, atol=1e-6)


def test_normal_does_not_hang_on_thread_count():
    """Torch's f32 log1p differs in the last bit between its vectorized and
    scalar loops, which thread chunks choose; the f64 log1p does not."""
    key = tf.PRNGKey(5)
    one = tf.normal(key, (320, 256))
    torch.set_num_threads(4)
    try:
        many = tf.normal(key, (320, 256))
    finally:
        torch.set_num_threads(1)
    assert torch.equal(one, many)


@pytest.mark.parametrize("path", [("wte",), ("h_0", "attn", "qkv"), ("h_3", "mlp", "proj"), ("dense1",)])
def test_flax_param_key(path):
    from flax.core.scope import LazyRng

    root = jax.random.PRNGKey(5)
    want = LazyRng.create(root, *path, 1).as_jax_rng()
    np.testing.assert_array_equal(_np(tf.flax_param_key(tf.PRNGKey(5), path)), np.asarray(want))
