"""Port vs reference: ``ops/device_envs.py`` against ``ops/jax_envs.py``.

Each env id is reset and stepped 100 ticks in both packages from the same
keys (eight envs, their keys folded from one base as Anakin folds them)
and the same random actions: the state (tick, target or velocity and
position, key), the frames, the rewards and the dones are equal bit for
bit — the RNG is ``ops/threefry.py``, jax's own."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_deep_q_tpu import config as ref_config
from distributed_deep_q_tpu.ops import jax_envs

from distributed_deep_q_tpu_torch import config as port_config
from distributed_deep_q_tpu_torch.ops import device_envs

N, TICKS = 8, 100


def _env_cfg(mod, env_id, kind="signal_atari", frame=(12, 10)):
    return mod.EnvConfig(id=env_id, kind=kind, frame_shape=frame, stack=2)


def _assert_state(ref_state, port_state):
    assert set(ref_state) == set(port_state)
    for k, v in ref_state.items():
        np.testing.assert_array_equal(np.asarray(v).astype(np.int64),
                                      port_state[k].long().numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("env_id", ["signal", "signal-h", "signal-vel",
                                    "signal-vel-ep"])
def test_env_matches_reference_for_100_ticks(env_id):
    r_reset, r_step = jax_envs.make_jax_env(_env_cfg(ref_config, env_id))
    p_reset, p_step = device_envs.make_device_env(
        _env_cfg(port_config, env_id))
    base = jax.random.PRNGKey(5)
    keys = jax.vmap(lambda g: jax.random.fold_in(base, 1000 * (g + 1)))(
        jnp.arange(N))
    rs, rf = jax.vmap(r_reset)(keys)
    ps, pf = p_reset(torch.from_numpy(np.asarray(keys).astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(rf), pf.numpy())
    _assert_state(rs, ps)
    step = jax.jit(jax.vmap(r_step))
    rng = np.random.default_rng(0)
    dones = 0
    for _ in range(TICKS):
        a = rng.integers(0, 4, N).astype(np.int32)
        rs, rf, rr, rd = step(rs, jnp.asarray(a))
        ps, pf, pr, pd = p_step(ps, torch.from_numpy(a))
        assert pf.dtype == torch.uint8 and pf.shape == (N, 12, 10)
        np.testing.assert_array_equal(np.asarray(rf), pf.numpy())
        np.testing.assert_array_equal(np.asarray(rr), pr.numpy())
        np.testing.assert_array_equal(np.asarray(rd), pd.numpy())
        _assert_state(rs, ps)
        dones += int(pd.sum())
    assert dones == N * (TICKS // 32)   # 32-step episodes auto-reset
    assert set(np.unique(pf.numpy())) <= {20, 220}


def test_other_env_kinds_are_refused():
    for kind in ("fake_atari", "cartpole", "atari"):
        with pytest.raises(ValueError, match="no JAX port for env kind"):
            device_envs.make_device_env(
                _env_cfg(port_config, "x", kind=kind))
