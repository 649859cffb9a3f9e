"""Port vs reference: ``BatchedPolicy`` (``models/policy.py``) on the CPU.

The reference's policy (Flax, JAX on the CPU) and the port's are built
from the same config; the reference's θ goes into the port through
``set_weights(reference.get_weights())`` (the θ wire). Inputs come from
numpy seeds. Pins and their reasons:

- ``bucket_for`` and the bucket bound: any sweep of batch sizes, the
  oversized chunks included, runs only the declared bucket shapes;
- ``r2d2`` is refused by name; a CUDA device without a card raises;
- padding rows never leak: a row's Q within one bucket is bitwise the
  same whatever the other rows hold (the zero padding, or random rows);
- the port's actions equal the reference's at every bucket, on the MLP
  and on the Nature CNN in float32 and bf16, in every row whose top two
  Q-values differ by more than twice the row's largest Q difference
  (there no argmax can flip; in a near-tie the port's action must be
  one of the tied, and near-ties are at most 5% of the rows); Q within
  1e-5 absolute and relative in float32 (the same sums in other orders,
  XLA against oneDNN; rows also depend on the batch they ride in, by
  ~1e-7) and within 1e-2 absolute in bf16 (each layer rounds its inputs
  to 8 significant bits, at other points on each side);
- ``get_weights`` round trip bitwise;
- a tenant generation from ``unflatten`` leaves the installed θ's
  replies bitwise unchanged, and serves its own θ.
"""

import signal

import numpy as np
import pytest
import torch

from distributed_deep_q_tpu.config import NetConfig as RefNetConfig
from distributed_deep_q_tpu.models.policy import BatchedPolicy as RefPolicy

from distributed_deep_q_tpu_torch.config import NetConfig
from distributed_deep_q_tpu_torch.models.policy import BatchedPolicy

TIMEOUT_S = 60
OBS_DIM = 6
BUCKETS = (8, 32, 128, 256)
NETS = {
    "mlp": (dict(kind="mlp", num_actions=5, hidden=(32, 32)), 1e-5),
    "mlp_dueling": (dict(kind="mlp", num_actions=3, hidden=(24,),
                         dueling=True), 1e-5),
    "nature_f32": (dict(kind="nature_cnn", num_actions=4,
                        frame_shape=(36, 36), compute_dtype="float32"),
                   1e-5),
    "nature_bf16": (dict(kind="nature_cnn", num_actions=4,
                         frame_shape=(36, 36), compute_dtype="bfloat16"),
                    1e-2),
}


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {TIMEOUT_S} s deadline")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, TIMEOUT_S)
    torch.set_num_threads(2)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prev)


def _port(name="mlp", seed=0, buckets=BUCKETS):
    return BatchedPolicy(NetConfig(**NETS[name][0]), seed=seed,
                         obs_dim=OBS_DIM, buckets=buckets, device="cpu")


def _obs(name, n, seed=0):
    rng = np.random.default_rng(seed)
    kw = NETS[name][0]
    if kw["kind"] == "mlp":
        return rng.standard_normal((n, OBS_DIM)).astype(np.float32)
    return rng.integers(0, 256, (n,) + kw["frame_shape"] + (4,),
                        dtype=np.uint8)


def test_bucket_for_and_bucket_bound():
    p = BatchedPolicy(NetConfig(**NETS["mlp"][0]), obs_dim=OBS_DIM,
                      buckets=(16, 4), device="cpu")
    assert p.buckets == (4, 16)
    assert [p.bucket_for(n) for n in (1, 4, 5, 16, 999)] == [4, 4, 16, 16,
                                                             16]
    for n in (1, 3, 4, 9, 16, 33, 50):
        a, q = p.forward(_obs("mlp", n, seed=n))
        assert a.shape == (n,) and a.dtype == np.int64
        assert q.shape == (n, 5) and q.dtype == np.float32
    # the sweep, the 33- and 50-row chunks included, ran only the buckets
    assert p.compiled_buckets() == [4, 16]
    assert p.rows == 1 + 3 + 4 + 9 + 16 + 33 + 50
    assert p.forwards == 1 + 1 + 1 + 1 + 1 + 3 + 4
    with pytest.raises(ValueError, match="positive"):
        BatchedPolicy(NetConfig(**NETS["mlp"][0]), buckets=(0, 8),
                      device="cpu")


def test_refuses_r2d2_and_a_card_it_does_not_have(monkeypatch):
    with pytest.raises(ValueError, match="r2d2|recurrent"):
        BatchedPolicy(NetConfig(kind="r2d2"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a card"):
        BatchedPolicy(NetConfig(**NETS["mlp"][0]), device="cuda")


@pytest.mark.parametrize("name", list(NETS))
def test_padding_rows_never_leak(name):
    """Within one bucket, a real row's Q is bitwise the same beside zero
    padding and beside random rows; across buckets its action is the
    same and its Q within the tolerance."""
    p = _port(name, seed=1)
    tol = NETS[name][1]
    real = _obs(name, 5, seed=2)
    noise = _obs(name, 8 - 5, seed=3)
    a_pad, q_pad = p.forward(real)                         # bucket 8
    a_full, q_full = p.forward(np.concatenate([real, noise]))
    np.testing.assert_array_equal(q_full[:5], q_pad)
    np.testing.assert_array_equal(a_full[:5], a_pad)
    a_big, q_big = p.forward(np.concatenate([real, _obs(name, 30, 4)]))
    np.testing.assert_allclose(q_big[:5], q_pad, rtol=tol, atol=tol)
    assert p.compiled_buckets() == [8, 128]


def _ref_pair(name, seed=3):
    kw = NETS[name][0]
    ref = RefPolicy(RefNetConfig(**kw), seed=seed, obs_dim=OBS_DIM,
                    buckets=BUCKETS)
    port = _port(name)
    port.set_weights(ref.get_weights())
    return ref, port


@pytest.mark.parametrize("name", list(NETS))
def test_actions_and_q_match_the_reference_at_every_bucket(name):
    ref, port = _ref_pair(name)
    tol = NETS[name][1]
    clear = 0
    for n in (3, 8, 20, 32, 100, 256, 300):
        obs = _obs(name, n, seed=n)
        ra, rq = ref.forward(obs)
        pa, pq = port.forward(obs)
        np.testing.assert_allclose(pq, rq, rtol=tol, atol=tol)
        # where a row's top two differ by more than twice its largest Q
        # difference, no argmax can flip: the actions must be equal; in
        # a near-tie the port's pick is one of the reference's tied top
        top2 = np.sort(rq, axis=-1)[:, -2:]
        slack = 2 * np.abs(pq - rq).max(axis=-1)
        sure = top2[:, 1] - top2[:, 0] > slack
        np.testing.assert_array_equal(pa[sure], ra[sure])
        near = np.flatnonzero(~sure)
        assert np.all(rq[near, pa[near]] >= top2[near, 1] - slack[near])
        clear += int(sure.sum())
    assert clear >= 0.95 * (3 + 8 + 20 + 32 + 100 + 256 + 300)
    assert port.compiled_buckets() == ref.compiled_buckets() == list(BUCKETS)


@pytest.mark.parametrize("name", list(NETS))
def test_get_weights_round_trip_is_bitwise(name):
    ref, port = _ref_pair(name)
    want = ref.get_weights()
    got = port.get_weights()
    assert [w.shape for w in got] == [np.shape(w) for w in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    other = _port(name, seed=9)
    other.set_weights(got)
    for a, b in zip(other.get_weights(), want):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="weights"):
        port.set_weights(got[:-1])


@pytest.mark.parametrize("name", ["mlp", "nature_bf16"])
def test_tenant_generation_leaves_the_installed_replies_unchanged(name):
    p = _port(name, seed=5)
    obs = _obs(name, 7, seed=6)
    a0, q0 = p.forward(obs)
    installed = p.params
    tenant_leaves = _port(name, seed=8).get_weights()
    gen = p.unflatten(tenant_leaves)
    ta, tq = p.forward(obs, params=gen)
    a1, q1 = p.forward(obs)
    assert p.params is installed
    np.testing.assert_array_equal(q1, q0)
    np.testing.assert_array_equal(a1, a0)
    # the tenant's replies are its own θ's: a policy with it installed
    solo = _port(name, seed=11)
    solo.set_weights(tenant_leaves)
    np.testing.assert_array_equal(solo.forward(obs)[1], tq)
    assert not np.array_equal(tq, q0)
