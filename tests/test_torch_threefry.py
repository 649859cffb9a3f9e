"""Port vs jax: ``ops/threefry.py`` against ``jax.random`` (threefry2x32,
``jax_threefry_partitionable=True``), bitwise, over a few hundred seeded
keys — the draws the device envs and Anakin's acting make."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_deep_q_tpu_torch.ops import threefry

N_KEYS = 300


@pytest.fixture(scope="module")
def keys():
    seeds = np.random.default_rng(0).integers(-2**31, 2**31, N_KEYS)
    ref = np.stack([np.asarray(jax.random.PRNGKey(int(s))) for s in seeds])
    # half of them derived keys, so both words are busy
    ref[N_KEYS // 2:] = np.asarray(jax.vmap(
        lambda k: jax.random.fold_in(k, 12345))(ref[N_KEYS // 2:]))
    return ref, torch.from_numpy(ref.astype(np.int64))


def test_prng_key_matches_jax():
    seeds = np.random.default_rng(1).integers(-2**31, 2**31, N_KEYS)
    for s in list(seeds) + [0, 1, -1, 2**31 - 1, -2**31]:
        ref = np.asarray(jax.random.PRNGKey(int(s))).astype(np.int64)
        np.testing.assert_array_equal(ref, threefry.prng_key(int(s)).numpy())
    with pytest.raises(ValueError, match="int32"):
        threefry.prng_key(2**31)


@pytest.mark.parametrize("n", [2, 3, 5])
def test_split_matches_jax(keys, n):
    ref, tk = keys
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, n))(ref))
    np.testing.assert_array_equal(want.astype(np.int64),
                                  threefry.split(tk, n).numpy())


def test_fold_in_matches_jax(keys):
    ref, tk = keys
    data = np.random.default_rng(2).integers(0, 2**31, N_KEYS, dtype=np.int64)
    want = np.asarray(jax.vmap(jax.random.fold_in)(ref, data.astype(np.int32)))
    np.testing.assert_array_equal(want.astype(np.int64),
                                  threefry.fold_in(tk, torch.from_numpy(data))
                                  .numpy())
    # a scalar folded into every key, as the runner's 1000·(g+1) is per env
    want = np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, 7777))(ref))
    np.testing.assert_array_equal(want.astype(np.int64),
                                  threefry.fold_in(tk, 7777).numpy())


def test_uniform_matches_jax_bitwise(keys):
    ref, tk = keys
    want = np.asarray(jax.vmap(jax.random.uniform)(ref))
    got = threefry.uniform(tk)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(want.view(np.int32),
                                  got.numpy().view(np.int32))
    assert (got >= 0).all() and (got < 1).all()


@pytest.mark.parametrize("lo, hi", [
    (0, 4), (0, 18), (0, 84), (3, 17), (-5, 7), (0, 1), (5, 5), (9, 2),
    (0, 2**31 - 1), (-2**31, 2**31 - 1)])
def test_randint_matches_jax(keys, lo, hi):
    ref, tk = keys
    want = np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (), lo, hi, jnp.int32))(ref))
    got = threefry.randint(tk, lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())


def test_batched_shapes_follow_vmap(keys):
    """A ``[a, b, 2]`` batch of keys gives what the flat batch gives."""
    _, tk = keys
    k = tk[:12].view(3, 4, 2)
    assert threefry.split(k, 3).shape == (3, 4, 3, 2)
    np.testing.assert_array_equal(threefry.uniform(k).reshape(-1).numpy(),
                                  threefry.uniform(tk[:12]).numpy())
    np.testing.assert_array_equal(
        threefry.randint(k, 0, 6).reshape(-1).numpy(),
        threefry.randint(tk[:12], 0, 6).numpy())


@pytest.mark.parametrize("n", [1, 7, 64, 512])
def test_shaped_uniform_matches_jax_bitwise(keys, n):
    """``uniforms(key, n)`` is ``jax.random.uniform(key, (n,))``: the fused
    samplers' draws (n = 1 and an odd n included)."""
    ref, tk = keys
    ref, tk = ref[::10], tk[::10]     # 30 keys, both kinds
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(ref))
    got = threefry.uniforms(tk, n)
    assert got.shape == (len(ref), n) and got.dtype == torch.float32
    np.testing.assert_array_equal(want.view(np.int32),
                                  got.numpy().view(np.int32))
    # a [a, b, 2] batch of keys gives what the flat batch gives
    np.testing.assert_array_equal(
        threefry.uniforms(tk[:6].view(2, 3, 2), n).reshape(6, n).numpy(),
        got[:6].numpy())
    # and numpy on the host draws the same bits from the uint32 words
    host = threefry.uniforms_host(ref.astype(np.uint32), n)
    assert host.dtype == np.float32
    np.testing.assert_array_equal(host.view(np.int32), want.view(np.int32))


def test_fused_sampler_uniforms_are_the_references():
    """``uniforms_for_keys`` (numpy on the host) over a ``[D, chain, 2]``
    key schedule draws what the reference's samplers draw,
    ``jax.random.uniform(keys[s, i], (B/D,))``, bitwise; so does the
    torch hash on the same keys (the draw on the card)."""
    from distributed_deep_q_tpu_torch.replay.device_per import (
        uniforms_for_keys)
    from distributed_deep_q_tpu_torch.solver import sample_key_schedule

    keys = sample_key_schedule(seed=5, start_step=40, num_shards=2, chain=3)
    got = uniforms_for_keys(keys, 33, torch.device("cpu"))
    on_torch = threefry.uniforms(torch.from_numpy(keys.astype(np.int64)), 33)
    assert got.shape == on_torch.shape == (2, 3, 33)
    for s in range(2):
        for i in range(3):
            want = np.asarray(jax.random.uniform(jnp.asarray(keys[s, i]),
                                                 (33,))).view(np.int32)
            np.testing.assert_array_equal(got[s, i].numpy().view(np.int32),
                                          want)
            np.testing.assert_array_equal(
                on_torch[s, i].numpy().view(np.int32), want)
