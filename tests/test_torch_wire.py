"""Port vs reference: the v4 wire, its checksum, the chaos shim and the
durability plane's generation store.

Tolerance: none — everything here is bitwise. The same numpy-seeded inputs
go through both packages:

- ``crc32c`` (the native core's and the numpy version) on random bytes
  of every length from 0 to 4,096, large, and as a streamed continuation;
- ``encode`` gives the same bytes for every value kind and dtype the
  reference round-trips, at every shape (0-d to 3-d);
- each package ``decode``s / ``recv_msg``s the other's frames;
- a flipped payload bit raises ``ChecksumError`` in both;
- the same ``ChaosPlan`` spec and seed fire the same fault schedule, and
  ``atomic_write``'s torn-write hook damages a file the same way;
- a snapshot generation committed by either package verifies in the other.

Tests with sockets bind 127.0.0.1 and carry a deadline of their own.
"""

import os
import signal
import socket
import threading

import numpy as np
import pytest

from distributed_deep_q_tpu.rpc import faultinject as ref_fi
from distributed_deep_q_tpu.rpc import protocol as ref_proto
from distributed_deep_q_tpu.utils import durability as ref_dur

from distributed_deep_q_tpu_torch import native
from distributed_deep_q_tpu_torch.rpc import faultinject as fi
from distributed_deep_q_tpu_torch.rpc import protocol as proto
from distributed_deep_q_tpu_torch.utils import durability as dur

TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _deadline():
    """A hung socket fails its test after TIMEOUT_S instead of holding
    the worker."""
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {TIMEOUT_S} s deadline")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, TIMEOUT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prev)


@pytest.fixture(autouse=True)
def _no_chaos():
    for m in (fi, ref_fi):
        m.uninstall()
    yield
    for m in (fi, ref_fi):
        m.uninstall()


# -- CRC-32C -------------------------------------------------------------------


@pytest.mark.parametrize("crc", ["native", "numpy"])
def test_crc32c_bitwise_every_length_to_4096(crc):
    """The native core's loop and the numpy version (the plain one, when
    the core does not build) against the reference's."""
    fn = dur.crc32c if crc == "native" else dur.crc32c_numpy
    if crc == "native" and native.load() is None:
        pytest.skip("no C++ compiler: the native core did not build")
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    got = [fn(data[:n]) for n in range(4097)]
    want = [ref_dur.crc32c(data[:n]) for n in range(4097)]
    assert got == want
    # the standard check value of CRC-32C, and a continued checksum
    assert fn(b"123456789") == 0xE3069283
    assert fn(b"56789", fn(b"1234")) == 0xE3069283


@pytest.mark.parametrize("n", [1 << 16, (1 << 20) + 13])
def test_crc32c_large_and_streamed(n):
    """Large buffers, whole and as a continuation of a prefix, native and
    numpy against the reference."""
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    whole = dur.crc32c(data)
    assert whole == ref_dur.crc32c(data) == dur.crc32c_numpy(data)
    cut = n // 3
    assert dur.crc32c(data[cut:], dur.crc32c(data[:cut])) == whole
    assert dur.crc32c(np.zeros(0, np.uint8), whole) == whole


# -- encode / decode -----------------------------------------------------------


def _messages():
    rng = np.random.default_rng(1)
    arrays = {
        "u8": np.arange(24, dtype=np.uint8).reshape(2, 3, 4),
        "f32": np.linspace(0, 1, 7, dtype=np.float32),
        "bool": np.array([True, False, True]),
        "f64_0d": np.asarray(3.5, np.float64).reshape(()),
        "i32": rng.integers(-5, 5, (3, 2)).astype(np.int32),
        "i64": rng.integers(-2**40, 2**40, 5),
        "i16": rng.integers(-300, 300, 4).astype(np.int16),
        "u32": rng.integers(0, 2**32 - 1, 4, dtype=np.uint32),
        "f16": rng.standard_normal(6).astype(np.float16),
        "empty": np.zeros((0, 4), np.float32),
    }
    scalars = {"an_int": -42, "a_float": 3.25, "a_str": "hello ε-greedy",
               "a_bool": True, "nothing": None,
               "np_int": np.int64(7), "np_float": np.float32(0.5)}
    yield pytest.param({**arrays, **scalars}, id="every_kind")
    for k, v in arrays.items():
        yield pytest.param({k: v}, id=k)
    yield pytest.param({}, id="empty_message")
    frames = rng.integers(0, 256, (64, 84, 84), dtype=np.uint8)
    yield pytest.param({
        "method": "add_transitions", "actor_id": 3, "flush_seq": 9,
        "frame": frames, "action": rng.integers(0, 4, 64).astype(np.int32),
        "reward": rng.random(64).astype(np.float32),
        "done": np.zeros(64, bool), "boundary": np.zeros(64, bool)},
        id="pixel_flush")


@pytest.mark.parametrize("msg", list(_messages()))
def test_encode_is_byte_equal_and_decodes_across(msg):
    frame = proto.encode(msg)
    assert frame == ref_proto.encode(msg)
    payload = frame[proto.HEADER_SIZE:-proto.TRAILER_SIZE]
    for dec in (proto.decode, ref_proto.decode):
        out = dec(payload)
        assert list(out) == list(msg)
        for k, v in msg.items():
            if isinstance(v, np.ndarray):
                assert out[k].dtype == v.dtype and out[k].shape == v.shape
                np.testing.assert_array_equal(out[k], v)
            else:
                assert out[k] == v
    assert proto.reframe(frame) == frame == ref_proto.reframe(frame)


@pytest.mark.parametrize("sender,receiver", [(proto, ref_proto),
                                             (ref_proto, proto)],
                         ids=["port_to_reference", "reference_to_port"])
def test_each_side_receives_the_others_frames(sender, receiver):
    a, b = socket.socketpair()
    msg = {"x": np.random.default_rng(0).standard_normal((100, 100)),
           "tag": "θ", "n": 3}
    t = threading.Thread(target=sender.send_msg, args=(a, msg))
    try:
        t.start()
        out, nbytes = receiver.recv_msg_sized(b)
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        a.close()
        b.close()
    np.testing.assert_array_equal(out["x"], msg["x"])
    assert (out["tag"], out["n"]) == ("θ", 3)
    assert nbytes == len(proto.encode(msg)) - proto.HEADER_SIZE \
        - proto.TRAILER_SIZE


@pytest.mark.parametrize("mod", [proto, ref_proto],
                         ids=["port", "reference"])
def test_flipped_payload_bit_raises_checksum_error(mod):
    frame = bytearray(proto.encode({"x": np.arange(64, dtype=np.float32)}))
    frame[proto.HEADER_SIZE + 40] ^= 0x10   # inside the array data
    a, b = socket.socketpair()
    try:
        a.sendall(bytes(frame))
        with pytest.raises(mod.ChecksumError):
            mod.recv_msg(b)
    finally:
        a.close()
        b.close()
    assert issubclass(mod.ChecksumError, mod.ProtocolError)
    with pytest.raises(mod.ChecksumError):
        mod.reframe(bytes(frame))


# -- the chaos shim ------------------------------------------------------------


class _FakeSock:
    """Records what reaches the wire; ``recv_into`` fills zeros."""

    def __init__(self):
        self.sent: list[bytes] = []
        self.closed = 0

    def sendall(self, data):
        self.sent.append(bytes(data))

    def recv_into(self, buf, nbytes=0, flags=0):
        n = nbytes or len(buf)
        buf[:n] = bytes(n)
        return n

    def close(self):
        self.closed += 1


def _schedule(mod, spec: str, ops: int = 400) -> tuple[list, dict]:
    plan = mod.ChaosPlan.from_spec(spec)
    sock = mod.ChaosSocket(_FakeSock(), plan, "client")
    out = []
    rng = np.random.default_rng(5)
    for i in range(ops):
        data = rng.integers(0, 256, int(rng.integers(1, 64)),
                            dtype=np.uint8).tobytes()
        try:
            if i % 3 == 2:
                sock.recv_into(bytearray(16), 16)
                out.append(("recv", None))
            else:
                sock.sendall(data)
                out.append(("send", sock._sock.sent[-1]))
        except ConnectionError as e:
            out.append(("error", str(e)))
    return out, dict(plan.counters)


@pytest.mark.parametrize("spec", [
    "drop=0.05,seed=1",
    "drop=0.02,truncate=0.05,corrupt=0.1,delay=0.1:0,stall=0.1:0,seed=7",
    "corrupt=0.5,seed=123"])
def test_chaos_plan_fires_the_same_schedule(spec):
    got, got_counts = _schedule(fi, spec)
    want, want_counts = _schedule(ref_fi, spec)
    assert got == want
    assert got_counts == want_counts and sum(got_counts.values()) > 0
    assert fi.ChaosPlan.from_spec(spec).__dict__.keys() == \
        ref_fi.ChaosPlan.from_spec(spec).__dict__.keys()


def test_chaos_env_var_and_wrap_passthrough(monkeypatch):
    raw = _FakeSock()
    assert fi.wrap(raw) is raw           # no plan: the socket passes through
    monkeypatch.setenv(fi.ENV_VAR, "drop=1.0,seed=3")
    fi.uninstall()
    wrapped = fi.wrap(raw)
    assert isinstance(wrapped, fi.ChaosSocket)
    with pytest.raises(ConnectionError):
        wrapped.sendall(b"x")
    assert fi.active().counters == {"client/drop_send": 1}


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_torn_write_hook_damages_the_same_way(tmp_path, seed):
    data = np.random.default_rng(seed).integers(
        0, 256, 5000, dtype=np.uint8).tobytes()
    out = {}
    for name, mod, dmod in (("port", fi, dur), ("ref", ref_fi, ref_dur)):
        mod.install(f"torn=1.0,seed={seed}")
        path = str(tmp_path / f"{name}.bin")
        dmod.atomic_write(path, data)
        with open(path, "rb") as f:
            out[name] = f.read()
        assert mod.active().counters == {"file/torn": 1}
        mod.uninstall()
    assert out["port"] == out["ref"] != data


def test_atomic_write_streams_a_callable(tmp_path):
    """The port's ``atomic_write`` also takes a writer callable (a replay
    npz streams to disk): the same bytes as the bytes form."""
    path = str(tmp_path / "f.bin")
    dur.atomic_write(path, lambda f: f.write(b"abc" * 1000))
    with open(path, "rb") as f:
        assert f.read() == b"abc" * 1000
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


# -- GenerationStore -----------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [(dur, ref_dur), (ref_dur, dur)],
                         ids=["port_commits", "reference_commits"])
def test_generations_verify_across_packages(tmp_path, writer, reader):
    root = str(tmp_path / "snap")
    files = {"server.npz": writer.savez_bytes(a=np.arange(10)),
             "replay.npz": os.urandom(3000)}
    w = writer.GenerationStore(root, keep=2)
    for i in range(3):
        assert w.commit(files, meta={"params_version": i}) == i
    assert w.generations() == [1, 2]           # keep 2
    r = reader.GenerationStore(root, keep=2)
    gen, paths, meta = r.latest_valid()
    assert gen == 2 and meta["params_version"] == 2
    with open(paths["replay.npz"], "rb") as f:
        assert f.read() == files["replay.npz"]
    # a damaged newest generation is quarantined; the walk falls back
    with open(paths["replay.npz"], "r+b") as f:
        f.truncate(100)
    gen, _, meta = reader.GenerationStore(root, keep=2).latest_valid()
    assert gen == 1 and meta["params_version"] == 1
    assert writer.GenerationStore(root).generations() == [1]
