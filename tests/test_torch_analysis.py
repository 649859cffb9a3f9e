"""The port's static-analysis gate (``distributed_deep_q_tpu_torch.analysis``)
held to the reference's (``distributed_deep_q_tpu.analysis``).

Every pass but purity: the same synthetic module goes through the
reference's ``check_sources`` and the port's, and both give the same
``(rule, line)`` findings (paths under the reference package mapped to
the port's), and the port's result meets the reference test's own
expectation. Purity: each reference fixture's torch translation (``jit``
→ ``torch.compile``, the Pallas kernel → a ``torch.compile`` of it) gives
the same rules on the same lines as the reference fixture does through
the reference's pass, plus the port's own roots (``DEVICE_ROOTS``, CUDA
graph capture) and rules. Then the self-hosting gate on the port tree,
the command line, the chaos preflight, and the port's registries held
to the port's source.

The synthetic sources are string constants, as the reference's are: the
reference's protocol pass scans ``tests/`` for literal ``.call("verb")``
emits, and its gate stays at zero findings with this file in the tree.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from distributed_deep_q_tpu import analysis as ref
from distributed_deep_q_tpu.analysis import (
    atomic_writes as ref_atomic, blocking as ref_blocking,
    config_keys as ref_config, locks as ref_locks,
    metric_keys as ref_metric, protocol_drift as ref_protocol,
    purity as ref_purity, threads as ref_threads)
from distributed_deep_q_tpu.analysis.core import Source as RefSource
from distributed_deep_q_tpu_torch import analysis as port
from distributed_deep_q_tpu_torch.analysis import (
    atomic_writes, blocking, config_keys, locks, metric_keys,
    protocol_drift, purity, threads)
from distributed_deep_q_tpu_torch.analysis.core import (
    PACKAGE, Source, call_name, load_sources, package_files, pkg)

REPO = port.repo_root()
REF_PACKAGE = "distributed_deep_q_tpu"


def src(text: str, path: str = "synthetic.py") -> Source:
    return Source.parse(textwrap.dedent(text), path)


def ref_src(text: str, path: str = "synthetic.py") -> RefSource:
    return RefSource.parse(textwrap.dedent(text), path)


def rules(findings) -> set[str]:
    return {f.rule for f in findings}


def _mapped(path: str) -> str:
    if path.startswith(REF_PACKAGE + "/"):
        return PACKAGE + path[len(REF_PACKAGE):]
    return path


def pairs(findings) -> list[tuple[str, str, int]]:
    """(rule, path with the reference package mapped to the port's,
    line), sorted."""
    return sorted((f.rule, _mapped(f.path), f.line) for f in findings)


def twin(ref_check, port_check, text: str, path: str = "synthetic.py",
         ref_path: str | None = None):
    """Run one synthetic module through both packages' pass; assert the
    same findings; return the port's."""
    got = port_check([src(text, path)])
    want = ref_check([ref_src(text, ref_path or path)])
    assert pairs(got) == pairs(want), (pairs(got), pairs(want))
    return got


# ---------------------------------------------------------------------------
# lock discipline
# ---------------------------------------------------------------------------

LOCK_REG = locks.LockRegistry(
    attrs={"count": locks.Guard("lock", "Server", ("self", "server"))},
    globals={"mod.py": {"g_state": "g_lock"}},
)
REF_LOCK_REG = ref_locks.LockRegistry(
    attrs={"count": ref_locks.Guard("lock", "Server", ("self", "server"))},
    globals={"mod.py": {"g_state": "g_lock"}},
)


def lock_twin(text: str, path: str = "synthetic.py", reg=None, ref_reg=None):
    return twin(lambda s: ref_locks.check_sources(s, ref_reg or REF_LOCK_REG),
                lambda s: locks.check_sources(s, reg or LOCK_REG), text, path)


def test_locks_unguarded_access_caught():
    findings = lock_twin("""
        class Server:
            def bump(self):
                self.count += 1
    """)
    assert rules(findings) == {locks.RULE_UNGUARDED}
    assert findings[0].line == 4


def test_locks_guarded_access_clean():
    assert lock_twin("""
        class Server:
            def bump(self):
                with self.lock:
                    self.count += 1
    """) == []


def test_locks_lambda_inside_with_counts_as_held():
    assert lock_twin("""
        class Server:
            def drain(self):
                with self.lock:
                    wait(lambda: self.count == 0)
    """) == []


def test_locks_init_exempt_but_other_methods_not():
    findings = lock_twin("""
        class Server:
            def __init__(self):
                self.count = 0
            def peek(self):
                return self.count
    """)
    assert [f.line for f in findings] == [6]


def test_locks_foreign_receiver_checked_unrelated_skipped():
    findings = lock_twin("""
        def loop(server, cfg):
            x = server.count          # guarded receiver: finding
            y = cfg.count             # unrelated object: skipped
            with server.lock:
                z = server.count      # held: clean
    """)
    assert [f.line for f in findings] == [3]


def test_locks_module_global_guard():
    findings = lock_twin("""
        import threading
        g_lock = threading.Lock()
        g_state = None

        def bad():
            global g_state
            g_state = 1

        def good():
            global g_state
            with g_lock:
                g_state = 2
    """, path="mod.py")
    assert rules(findings) == {locks.RULE_UNGUARDED}
    assert all(f.line in (7, 8) for f in findings)


ORDER_ONE_TWO = """
    class A:
        def one(self):
            with self.lock:
                with self.other:
                    pass
        def two(self):
            with self.{first}:
                with self.{second}:
                    pass
"""


@pytest.mark.parametrize("first,second,cycle", [
    ("other", "lock", True),    # one: lock→other, two: other→lock
    ("lock", "other", False),   # the same order twice
], ids=["order-cycle-detected", "consistent-order-no-cycle"])
def test_locks_order_cycle(first, second, cycle):
    reg = locks.LockRegistry(attrs={
        "x": locks.Guard("lock", "A"), "y": locks.Guard("other", "A")})
    ref_reg = ref_locks.LockRegistry(attrs={
        "x": ref_locks.Guard("lock", "A"), "y": ref_locks.Guard("other", "A")})
    findings = lock_twin(ORDER_ONE_TWO.format(first=first, second=second),
                         reg=reg, ref_reg=ref_reg)
    assert rules(findings) == ({locks.RULE_CYCLE} if cycle else set())


# ---------------------------------------------------------------------------
# purity: each reference fixture and its torch translation
# ---------------------------------------------------------------------------


def purity_twin(ref_text: str, port_text: str, path: str = "synthetic.py"):
    """The reference fixture through the reference's pass, its torch
    translation through the port's: the same (rule, line) findings."""
    want = ref_purity.check_sources([ref_src(ref_text, path)])
    got = purity.check_sources([src(port_text, path)], device_roots=())
    assert sorted((f.rule, f.line) for f in got) == \
        sorted((f.rule, f.line) for f in want), (got, want)
    return got


def test_purity_impure_jit_body_caught():
    body = """
        import {mod}, time, numpy as np

        stats = {{}}

        def step(state, batch):
            print("tracing")
            t = time.time()
            host = np.asarray(batch)
            stats["calls"] = t          # captured-module-state mutation
            return state

        train = {wrap}(step)
    """
    findings = purity_twin(body.format(mod="jax", wrap="jax.jit"),
                           body.format(mod="torch", wrap="torch.compile"))
    assert rules(findings) == {"purity.print", "purity.time",
                               "purity.host-sync", "purity.captured-write"}


def test_purity_non_jitted_function_not_flagged():
    text = """
        import numpy as np

        def feed(batch):
            print("host side")
            return np.asarray(batch)
    """
    assert purity_twin(text, text) == []


def test_purity_callee_expansion_and_partial_wrapper():
    body = """
        import functools, {mod}
        import numpy as np

        def helper(x):
            return x.item()

        def kernel(ref, o_ref):
            o_ref[0] = helper(ref[0])

        {wrap}(
            functools.partial(kernel, 3))
    """
    findings = purity_twin(
        body.format(mod="jax", wrap="jax.experimental.pallas.pallas_call"),
        body.format(mod="torch", wrap="torch.compile"))
    assert rules(findings) == {"purity.host-sync"}


def test_purity_local_alias_resolves_to_kernel():
    body = """
        import functools, random

        def build({arg}):
            def kernel(ref):
                ref[0] = random.random()
            k = functools.partial(kernel, 1)
            return {wrap}(k)
    """
    findings = purity_twin(body.format(arg="pl", wrap="pl.pallas_call"),
                           body.format(arg="torch", wrap="torch.compile"))
    assert "purity.host-rng" in rules(findings)


def test_purity_gated_alias_lints_both_branches():
    """``train_fn = plane_fn if gate else tree_fn`` must make BOTH
    candidate bodies roots."""
    body = """
        import {mod}, time
        import numpy as np

        def build(use_plane):
            def plane_fn(x):
                return np.asarray(x)
            def tree_fn(x):
                return x + time.time()
            train_fn = plane_fn if use_plane else tree_fn
            return {wrap}(train_fn)
    """
    findings = purity_twin(body.format(mod="jax", wrap="jax.jit"),
                           body.format(mod="torch", wrap="torch.compile"))
    assert rules(findings) == {"purity.host-sync", "purity.time"}


def test_purity_rng_and_item_decorated():
    body = """
        import {mod}, numpy as np

        @{wrap}
        def step(x):
            noise = np.random.normal()
            return (x + noise).item()
    """
    findings = purity_twin(body.format(mod="jax", wrap="jax.jit"),
                           body.format(mod="torch", wrap="torch.compile"))
    assert rules(findings) == {"purity.host-rng", "purity.host-sync"}


def test_purity_local_writes_allowed():
    body = """
        import {mod}

        @{wrap}
        def step(batch):
            batch = dict(batch)
            batch["x"] = 1
            acc = {{}}
            acc["y"] = 2
            return batch, acc
    """
    assert purity_twin(body.format(mod="jax", wrap="jax.jit"),
                       body.format(mod="torch", wrap="torch.compile")) == []


# -- the port's own roots and rules ------------------------------------------


def test_purity_device_roots_entry_is_a_root():
    """A ``DEVICE_ROOTS`` entry is linted with no wrapper in sight, its
    bare-name and own-class ``self.`` callees with it; a method of the same
    name on another class is not (the host wrapper stays unlinted)."""
    text = """
        import time
        import numpy as np

        def helper(x):
            return x.cpu()

        class Learner:
            def _step_core(self, state, batch):
                self.steps = state          # captured write
                self._reduce(batch)
                return helper(batch)

            def _reduce(self, batch):
                return batch.tolist()

        class Host:
            def _reduce(self, batch):
                return np.asarray(batch)    # another class: not reached
    """
    root = purity.DeviceRoot("mod.py", "Learner._step_core", "test")
    findings = purity.check_sources([src(text, pkg("mod.py"))],
                                    device_roots=(root,))
    assert sorted((f.rule, f.line) for f in findings) == [
        ("purity.captured-write", 10), ("purity.host-sync", 6),
        ("purity.host-sync", 15)]
    # the same module with no declared root: nothing is a root
    assert purity.check_sources([src(text, pkg("mod.py"))],
                                device_roots=()) == []


def test_purity_stale_device_root_raises():
    root = purity.DeviceRoot("mod.py", "Learner._gone", "test")
    with pytest.raises(LookupError, match="Learner._gone"):
        purity.check_sources([src("class Learner:\n    pass\n",
                                  pkg("mod.py"))], device_roots=(root,))


CAPTURE_SRC = """
    import torch

    def step(x):
        return x.item()

    def run(g, static_x, out):
        {open}
            y = step(static_x)
            out[0] = y                  # a tensor the function was given
            torch.manual_seed(0)
        {close}
        return out
"""


@pytest.mark.parametrize("open_,close,seed_line", [
    ("with torch.cuda.graph(g):", "", 11),
    ("g.capture_begin()\n        if True:", "g.capture_end()", 12),
], ids=["torch.cuda.graph", "CUDAGraph.capture_begin"])
def test_purity_cuda_graph_capture_is_a_root(open_, close, seed_line):
    """The captured statements are linted inline with the enclosing
    function's locals (``out[0] = y`` writes a tensor it was given), and
    the functions they call are roots."""
    text = CAPTURE_SRC.format(open=open_, close=close)
    findings = purity.check_sources([src(text)], device_roots=())
    assert sorted((f.rule, f.line) for f in findings) == [
        ("purity.host-rng", seed_line), ("purity.host-sync", 5)]
    # outside the capture the same statements are host code
    plain = CAPTURE_SRC.format(open="if True:", close="")
    assert purity.check_sources([src(plain)], device_roots=()) == []


def test_purity_make_graphed_callables_and_self_method():
    text = """
        import random
        import torch

        class Actor:
            def act(self, x):
                return x + random.random()

            def graphed(self, x):
                return torch.cuda.make_graphed_callables(
                    (self.act, lambda y: y.cpu()), ((x,), (x,)))
    """
    findings = purity.check_sources([src(text)], device_roots=())
    assert sorted((f.rule, f.line) for f in findings) == [
        ("purity.host-rng", 7), ("purity.host-sync", 11)]


def test_purity_torch_host_reads_and_rng():
    text = """
        import torch

        @torch.compile
        def step(x, g):
            a = x.tolist()
            b = x.numpy()
            torch.cuda.synchronize()
            gen = torch.Generator()
            x.add_(1)                   # in place on its input: device work
            re = __import__("re").compile("x")  # not torch.compile
            return a, b, gen
    """
    findings = purity.check_sources([src(text)], device_roots=())
    assert sorted((f.rule, f.line) for f in findings) == [
        ("purity.host-rng", 9), ("purity.host-sync", 6),
        ("purity.host-sync", 7), ("purity.host-sync", 8)]


@pytest.mark.parametrize("pragma,want", [
    ("", [("purity.time", 6), ("purity.time", 8)]),
    ("  # ddq: allow(purity.time) — a host span", []),
], ids=["flagged", "allowed"])
def test_purity_tracer_span_in_a_root_reads_the_clock(pragma, want):
    """A tracer span inside a device root is a clock read (a graph would
    stamp it once, at capture); the pragma on its line takes it, and the
    same span in host code is no finding."""
    text = f"""
        import torch
        from pkg import tracing

        def step(x):
            with tracing.span("step_forward"):{pragma}
                y = x * 2
            with tracing.span("step_backward"):{pragma}
                return y + 1

        def host(x):
            with tracing.span("dispatch_inputs"):
                return step(x)

        train = torch.compile(step)
    """
    findings = purity.check_sources([src(text)], device_roots=())
    assert sorted((f.rule, f.line) for f in findings) == want


def _reference_roots() -> set[str]:
    """The reference's jit roots, as ``file:line name`` under its
    package, found by its own pass."""
    paths = []
    for d in ref_purity.SCAN_DIRS:
        full = os.path.join(REPO, d)
        paths.extend(os.path.join(dp, f) for dp, _, fs in os.walk(full)
                     for f in fs if f.endswith(".py"))
    out = set()
    for s in load_sources(REPO, sorted(paths)):
        for fn in ref_purity._collect_roots(ref_purity._ModuleIndex(s)):
            rel = s.path.replace(os.sep, "/")[len(REF_PACKAGE) + 1:]
            out.add(f"{rel}:{fn.lineno} {getattr(fn, 'name', '<lambda>')}")
    return out


def test_device_roots_cover_every_reference_root():
    """Each of the reference's jit roots has a ``DEVICE_ROOTS`` entry or
    a stated reason in ``NO_COUNTERPART``; every entry names a real one."""
    want = _reference_roots()
    assert len(want) == 21, sorted(want)
    named = {r.reference for r in purity.DEVICE_ROOTS}
    assert named <= want, sorted(named - want)
    assert set(purity.NO_COUNTERPART) <= want
    assert not named & set(purity.NO_COUNTERPART)
    assert named | set(purity.NO_COUNTERPART) == want, \
        sorted(want - named - set(purity.NO_COUNTERPART))
    assert all(purity.NO_COUNTERPART.values())


def test_device_roots_resolve_in_the_port():
    for r in purity.DEVICE_ROOTS:
        s = Source.load(os.path.join(REPO, pkg(r.file)), pkg(r.file))
        assert purity._find_qualname(s.tree, r.qualname) is not None, r


# ---------------------------------------------------------------------------
# protocol drift
# ---------------------------------------------------------------------------

SERVER_SRC = """
    class ReplayFeedServer:
        def _dispatch(self, req):
            method = req.get("method")
            if method == "ping":
                return {"ok": True}
            if method == "orphaned":
                return {"ok": True}
"""

PROTO_SRC = """
    _KIND_A, _KIND_B = range(2)

    def encode(msg):
        return [_KIND_A, _KIND_B]

    def _decode(payload):
        return [_KIND_A]
"""

PROTO_OK = """
    _KIND_A = 0

    def encode(m):
        return _KIND_A

    def _decode(p):
        return _KIND_A
"""

CLIENT_PING_ORPHANED = """
    def go(c):
        c.call("ping")
        c.call_once("orphaned")
"""


def protocol_twin(proto: str, client: str, verb_classes=None,
                  ref_verb_classes=None):
    def run(mod, make):
        return mod.check_sources(
            make(SERVER_SRC, "server.py"), make(proto, "proto.py"),
            [make(client, "client.py")],
            verb_classes=(verb_classes if mod is protocol_drift
                          else ref_verb_classes))
    got, want = run(protocol_drift, src), run(ref_protocol, ref_src)
    assert pairs(got) == pairs(want), (pairs(got), pairs(want))
    return got


def test_protocol_orphan_and_unhandled_and_wire_skew():
    findings = protocol_twin(PROTO_SRC, """
        def go(client):
            client.call("ping")
            client.call("renamed_method")
    """)
    by_rule = {f.rule: f for f in findings}
    assert by_rule["protocol.unhandled-method"].path == "client.py"
    assert "renamed_method" in by_rule["protocol.unhandled-method"].message
    assert "orphaned" in by_rule["protocol.orphan-handler"].message
    assert "_KIND_B" in by_rule["protocol.wire-skew"].message


def test_protocol_clean_when_paired():
    assert protocol_twin(PROTO_OK, CLIENT_PING_ORPHANED) == []


def test_protocol_unclassified_and_stale_verb_caught():
    findings = protocol_twin(
        PROTO_OK, CLIENT_PING_ORPHANED,
        {"ping": protocol_drift.IDEMPOTENT, "gone": protocol_drift.DEDUP_KEYED},
        {"ping": ref_protocol.IDEMPOTENT, "gone": ref_protocol.DEDUP_KEYED})
    by_rule = {f.rule: f for f in findings}
    assert set(by_rule) == {"protocol.unclassified-verb",
                            "protocol.stale-verb-class"}
    assert "orphaned" in by_rule["protocol.unclassified-verb"].message
    assert "gone" in by_rule["protocol.stale-verb-class"].message


def test_protocol_unsafe_verb_on_retry_path_caught():
    """.call() retries on failure — an unsafe verb must not ride it;
    call_once (single attempt) is the sanctioned escape hatch."""
    findings = protocol_twin(
        PROTO_OK, CLIENT_PING_ORPHANED,
        {"ping": protocol_drift.UNSAFE, "orphaned": protocol_drift.UNSAFE},
        {"ping": ref_protocol.UNSAFE, "orphaned": ref_protocol.UNSAFE})
    assert rules(findings) == {"protocol.unsafe-resend"}
    [f] = findings
    assert "'ping'" in f.message and f.path == "client.py"


def test_protocol_every_real_verb_is_classified():
    """The port's live VERB_CLASSES names only known classes, and the
    same verbs with the same classes as the reference's."""
    valid = {protocol_drift.IDEMPOTENT, protocol_drift.DEDUP_KEYED,
             protocol_drift.UNSAFE}
    assert protocol_drift.VERB_CLASSES
    assert set(protocol_drift.VERB_CLASSES.values()) <= valid
    assert protocol_drift.VERB_CLASSES == ref_protocol.VERB_CLASSES


# ---------------------------------------------------------------------------
# config keys
# ---------------------------------------------------------------------------

SCHEMA = {"train": {"lr", "total_steps"}, "net": {"kind"}}


def config_twin(text: str):
    return twin(lambda s: ref_config.check_sources(SCHEMA, s),
                lambda s: config_keys.check_sources(SCHEMA, s), text)


def test_config_unknown_key_caught():
    findings = config_twin("""
        def run(cfg):
            cfg.train.lr = 1e-3
            return cfg.train.total_stepz
    """)
    assert rules(findings) == {config_keys.RULE}
    assert "train.total_stepz" in findings[0].message


def test_config_non_config_roots_skipped():
    assert config_twin("""
        def run(solver, cfg):
            solver.train.whatever()   # root not a config expr
            cfg.optimizer.zero_grad() # unknown section: skipped
            return cfg.net.kind
    """) == []


def test_config_schema_parsed_from_real_config():
    """The port's config.py parses to the reference's sections, and each
    section holds at least the reference's fields."""
    def schema(mod, path):
        return mod.config_schema(Source.load(os.path.join(REPO, path), path))

    got = schema(config_keys, config_keys.CONFIG_FILE)
    want = schema(ref_config, ref_config.CONFIG_FILE)
    assert set(got) == set(want) == {
        "net", "replay", "train", "env", "actors", "mesh", "trace",
        "inference", "health", "autoscale"}
    for section, fields in want.items():
        assert fields <= got[section], (section, fields - got[section])
    assert "num_actions" in got["net"]
    assert "server_snapshot_path" in got["train"]
    assert "cutoff_us" in got["inference"]
    assert "fast_window_s" in got["health"]
    assert "recover_ticks" in got["autoscale"]


# ---------------------------------------------------------------------------
# atomic-write discipline
# ---------------------------------------------------------------------------


def atomic_twin(text: str, path: str = "synthetic.py",
                ref_path: str | None = None):
    return twin(ref_atomic.check_sources, atomic_writes.check_sources, text,
                path, ref_path)


def test_atomic_writes_raw_binary_sinks_caught():
    findings = atomic_twin("""
        import pickle
        import numpy as np

        def dump(path, arr, state):
            with open(path, "wb") as f:          # raw binary write
                f.write(arr.tobytes())
            np.savez(path, **state)              # savez to a real path
            arr.tofile(path)                     # unbuffered raw write
            with open(path, "wb") as f:
                pickle.dump(state, f)            # banned on persisted paths
    """)
    assert rules(findings) == {atomic_writes.RULE}
    assert len(findings) == 5  # two opens, savez, tofile, pickle.dump


def test_atomic_writes_reads_text_and_memory_sinks_clean():
    assert atomic_twin("""
        import io
        import numpy as np

        def fine(path, state, log_line):
            with open(path, "rb") as f:          # binary READ
                blob = f.read()
            with open(path + ".jsonl", "a") as f:  # text append (metrics)
                f.write(log_line)
            np.savez(io.BytesIO(), **state)      # in-memory serialize
            buf = io.BytesIO()
            np.savez(buf, **state)               # named memory sink
            return blob
    """) == []


def test_atomic_writes_nonliteral_mode_skipped_pragma_works():
    assert atomic_twin("""
        def edge(path, mode, blob):
            with open(path, mode) as f:          # non-literal mode: skipped
                f.write(blob)
            with open(path, "wb") as f:  # ddq: allow(durability.raw-write)
                f.write(blob)
    """) == []


BAD_PRIMITIVE = """
    def primitive(path, blob):
        with open(path, "wb") as f:
            f.write(blob)
"""


@pytest.mark.parametrize("exempt", [True, False],
                         ids=["durability-module", "other-module"])
def test_atomic_writes_durability_module_is_exempt(exempt):
    path, ref_path = ((atomic_writes.EXEMPT_FILES[0],
                       ref_atomic.EXEMPT_FILES[0]) if exempt
                      else (pkg("other.py"), f"{REF_PACKAGE}/other.py"))
    findings = atomic_twin(BAD_PRIMITIVE, path, ref_path)
    assert len(findings) == (0 if exempt else 1)


STREAMED = """
    import numpy as np
    import torch

    def save(path, state, snap):
        atomic_write(path, lambda f: np.savez(f, **state))
        atomic_write(path, lambda f: torch.save(snap, f))
        np.savez(state["f"], **state)
        torch.save(snap, path)
"""


def test_atomic_writes_tmp_file_callback_only_the_port_needs():
    """A writer streaming into ``atomic_write``'s tmp file through a
    lambda is atomic: the port's pass knows it, the reference's flags the
    ``np.savez``, and only the port's tree writes that way (its replay
    file and checkpoint) — on each package's own persistence module the
    reference's pass is clean only for the reference's."""
    port_f = atomic_writes.check_sources([src(STREAMED)])
    ref_f = ref_atomic.check_sources([ref_src(STREAMED)])
    assert sorted(f.line for f in port_f) == [8, 9]   # raw savez, torch.save
    assert sorted(f.line for f in ref_f) == [6, 8]    # callback savez, raw
    for rel, ref_clean in ((f"{REF_PACKAGE}/replay/persistence.py", True),
                           (pkg("replay", "persistence.py"), False)):
        s = load_sources(REPO, [os.path.join(REPO, rel)])
        assert atomic_writes.check_sources(s) == []
        assert (ref_atomic.check_sources(s) == []) is ref_clean, rel


# ---------------------------------------------------------------------------
# suppression pragma
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pragma", [
    "# ddq: allow(locks)", "# ddq: allow(*)"], ids=["pass-prefix", "star"])
def test_pragma_pass_prefix_and_star(pragma):
    assert lock_twin(f"""
        class Server:
            def peek(self):
                return self.count  {pragma}
    """) == []


def test_pragma_suppresses_exact_rule():
    assert lock_twin("""
        class Server:
            def peek(self):
                return self.count  # ddq: allow(locks.unguarded)
    """) == []


def test_unsuppressed_finding_still_fails():
    """The pragma is line- and rule-scoped: a wrong rule name or a
    different line must NOT silence the finding."""
    findings = lock_twin("""
        class Server:  # ddq: allow(locks.unguarded)
            def peek(self):
                return self.count  # ddq: allow(purity.print)
    """)
    assert rules(findings) == {locks.RULE_UNGUARDED}


# ---------------------------------------------------------------------------
# metric keys
# ---------------------------------------------------------------------------


def metric_twin(text: str):
    port_tr = Source.load(os.path.join(REPO, pkg("tracing.py")))
    ref_tr = RefSource.load(os.path.join(REPO, REF_PACKAGE, "tracing.py"))
    return twin(lambda s: ref_metric.check_sources(s, ref_tr),
                lambda s: metric_keys.check_sources(s, port_tr), text)


def test_metric_keys_typo_caught():
    findings = metric_twin("""
        metrics.gauge("queue/replay_sise", 1)
        self.metrics.count("grad_stepz")
    """)
    assert [f.rule for f in findings] == [metric_keys.RULE_METRIC] * 2


def test_metric_keys_known_and_dynamic_names_clean():
    assert metric_twin("""
        metrics.gauge("queue/replay_size", 1)
        metrics.count("grad_steps")
        out[f"rpc/{m}_calls"] = 1            # dynamic: out of static reach
        h.summary(prefix="trace/ingest_lag_ms")
    """) == []


def test_metric_keys_span_names_checked_against_tracer_tables():
    findings = metric_twin("""
        from distributed_deep_q_tpu_torch import tracing
        with tracing.span("env_step"):
            tracing.instant("shed")
        with tracing.span("env_stepp"):
            tracing.instant("shedd")
    """)
    assert [f.rule for f in findings] == [metric_keys.RULE_SPAN] * 2
    assert all("tracing." in f.message for f in findings)


def test_metric_keys_pragma_suppresses():
    assert metric_twin("""
        metrics.gauge("queue/oops", 1)  # ddq: allow(metric_keys.unknown-metric)
    """) == []


def test_metric_keys_gate_fails_on_seeded_typo():
    """Un-declaring a really-emitted name makes the port tree fail."""
    culled = frozenset(metric_keys.REGISTRY - {"queue/replay_size"})
    findings = metric_keys.check(REPO, registry=culled)
    assert any(f.rule == metric_keys.RULE_METRIC
               and "queue/replay_size" in f.message for f in findings)
    assert all(f.path.startswith(PACKAGE + "/") for f in findings)


def test_metric_keys_registry_holds_the_references():
    assert metric_keys.REGISTRY >= ref_metric.REGISTRY
    assert metric_keys.NAMESPACES == ref_metric.NAMESPACES


# ---------------------------------------------------------------------------
# self-hosting gate
# ---------------------------------------------------------------------------


def test_self_hosting_zero_findings():
    """The port tree passes every pass of its gate."""
    findings = port.run_all()
    assert findings == [], "\n".join(str(f) for f in findings)


def test_reference_gate_still_zero_with_the_port_tests():
    """The reference's gate (which scans ``tests/`` for wire-verb emits)
    stays at zero findings on the whole repo, this file included."""
    findings = ref.run_all()
    assert findings == [], "\n".join(str(f) for f in findings)


def test_known_rules_are_the_references():
    assert port.KNOWN_RULES == ref.KNOWN_RULES
    assert len(port.KNOWN_RULES) == 26


def gate(*args: str, cwd: str = REPO) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "distributed_deep_q_tpu_torch.analysis",
         *args], capture_output=True, text=True, timeout=120, cwd=cwd)


def test_gate_cli_exits_zero():
    proc = gate()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stdout


def broken_copy(tmp_path, with_chip_smoke: bool = False):
    """A copy of the port package (and ``chip_smoke.py``) whose replay
    server handles a renamed verb: protocol findings."""
    shutil.copytree(os.path.join(REPO, PACKAGE), tmp_path / PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    if with_chip_smoke:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    target = tmp_path / PACKAGE / "rpc" / "replay_server.py"
    text = target.read_text()
    assert 'if method == "reset_stream":' in text
    target.write_text(text.replace('if method == "reset_stream":',
                                   'if method == "reset_streamz":'))
    return tmp_path


def test_gate_cli_fails_on_broken_invariant(tmp_path):
    """Breaking a protocol invariant in a COPY of the port makes the gate
    exit 1 with file:line findings; ``--json --rule protocol`` gives one
    object per finding on stdout and the verdict on stderr."""
    root = str(broken_copy(tmp_path))
    proc = gate("--root", root)
    assert proc.returncode == 1
    assert "protocol." in proc.stdout
    assert any(line.split(":")[1].isdigit()
               for line in proc.stdout.splitlines() if ":" in line)
    proc = gate("--root", root, "--json", "--rule", "protocol")
    assert proc.returncode == 1
    objs = [json.loads(line) for line in proc.stdout.splitlines()]
    assert objs and all(
        set(o) == {"rule", "path", "line", "message"} for o in objs)
    assert all(o["rule"].startswith("protocol.") for o in objs)
    assert all(o["path"].startswith(PACKAGE + "/") for o in objs)
    assert "FAILED" in proc.stderr


def test_gate_cli_rule_filter_json_and_list_rules():
    proc = gate("--rule", "locks", "--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == ""
    assert "clean" in proc.stderr

    proc = gate("--list-rules")
    assert proc.returncode == 0
    assert tuple(proc.stdout.split()) == port.KNOWN_RULES


def test_gate_cli_unknown_rule_prefix_exits_2():
    proc = gate("--rule", "nonsense")
    assert proc.returncode == 2
    assert "unknown rule prefix" in proc.stderr


def test_chaos_smoke_preflight_passes_on_clean_tree():
    from distributed_deep_q_tpu_torch import chaos_smoke

    chaos_smoke._require_clean_gate()  # must not SystemExit


@pytest.mark.parametrize("argv", [
    ["-m", f"{PACKAGE}.chaos_smoke", "learn"],
    ["chip_smoke.py", "--phase17"],
], ids=["chaos_smoke-main", "chip_smoke-phase17"])
def test_preflight_refuses_a_broken_tree(tmp_path, argv):
    """On a tree the gate rejects, the chaos tool's ``main`` and
    ``chip_smoke.py``'s phase 17 print the findings to stderr and exit 2
    before running anything (phase 17's preflight comes before it looks
    for a card, so this holds here too)."""
    root = broken_copy(tmp_path, with_chip_smoke=True)
    proc = subprocess.run([sys.executable, *argv], capture_output=True,
                          text=True, timeout=240, cwd=root)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "REFUSING" in proc.stderr and "protocol." in proc.stderr
    assert "reset_streamz" in proc.stderr
    assert proc.stdout.strip() == ""


def test_chip_smoke_gate_phase_alone():
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--phase1b"],
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("[1b] analysis gate: "))
    got = json.loads(line.split(": ", 1)[1])
    assert got["findings"] == 0 and got["rules"] == 26
    assert got["files_scanned"] == len(package_files(REPO))


# ---------------------------------------------------------------------------
# thread-lifecycle registry
# ---------------------------------------------------------------------------


def thread_regs(stop, joined_in="close", name="worker", owner="W",
                why_no_join=""):
    return tuple(
        mod.ThreadRegistry(specs={("mod.py", "_run"): mod.ThreadSpec(
            name=name, owner=owner, stop=stop, joined_in=joined_in,
            why_no_join=why_no_join)}, files=("mod.py",))
        for mod in (ref_threads, threads))


def thread_twin(text: str, regs):
    ref_reg, port_reg = regs
    return twin(lambda s: ref_threads.check_sources(s, ref_reg),
                lambda s: threads.check_sources(s, port_reg), text, "mod.py")


THREAD_REGS = thread_regs(("event", "_stop"))

GOOD_THREAD_SRC = """
    import threading

    class W:
        def __init__(self):
            self._stop = threading.Event()
            self._t = threading.Thread(
                target=self._run, name="worker", daemon=True)
            self._t.start()

        def _run(self):
            while not self._stop.wait(0.1):
                pass

        def close(self):
            self._stop.set()
            self._t.join()
"""


def test_threads_registered_lifecycle_clean():
    assert thread_twin(GOOD_THREAD_SRC, THREAD_REGS) == []


def test_threads_unregistered_spawn_caught():
    findings = thread_twin("""
        import threading

        class W:
            def go(self):
                threading.Thread(target=self._other, daemon=True).start()
    """, THREAD_REGS)
    assert rules(findings) == {threads.RULE_UNREGISTERED}
    assert "_other" in findings[0].message


def test_threads_name_mismatch_and_missing_join_caught():
    findings = thread_twin("""
        import threading

        class W:
            def __init__(self):
                self._stop = threading.Event()
                self._t = threading.Thread(
                    target=self._run, name="wrong-name", daemon=True)

            def _run(self):
                pass

            def close(self):
                self._stop.set()  # no join on self._t
    """, THREAD_REGS)
    assert rules(findings) == {threads.RULE_MISMATCH, threads.RULE_NO_JOIN}


def test_threads_unset_stop_event_caught():
    """A stop event nobody ever .set()s is an unstoppable thread."""
    findings = thread_twin("""
        import threading

        class W:
            def __init__(self):
                self._stop = threading.Event()
                self._t = threading.Thread(
                    target=self._run, name="worker", daemon=True)

            def _run(self):
                while not self._stop.wait(0.1):
                    pass

            def close(self):
                self._t.join()
    """, THREAD_REGS)
    assert rules(findings) == {threads.RULE_NO_STOP}


FLAG_REGS = thread_regs(("flag", "_closed", "_cv"), name="drain", owner="D")

FLAG_SRC = """
    import threading

    class D:
        def __init__(self):
            self._cv = threading.Condition()
            self._closed = False
            self._t = threading.Thread(
                target=self._run, name="drain", daemon=True)

        def _run(self):
            with self._cv:
                while not self._closed:
                    self._cv.wait()

        def close(self):
            {shutdown}
            self._t.join()
"""


def test_threads_stop_flag_write_outside_guard_caught():
    findings = thread_twin(FLAG_SRC.format(shutdown="self._closed = True"),
                           FLAG_REGS)
    assert rules(findings) == {threads.RULE_STOP_UNGUARDED}
    # the __init__ seed write is exempt (single-threaded construction)
    assert len(findings) == 1


def test_threads_stop_flag_write_under_guard_clean():
    shutdown = ("with self._cv:\n"
                "                self._closed = True\n"
                "                self._cv.notify_all()")
    assert thread_twin(FLAG_SRC.format(shutdown=shutdown), FLAG_REGS) == []


def test_threads_daemon_without_join_needs_reason():
    findings = thread_twin("""
        import threading

        class W:
            def go(self):
                self._t = threading.Thread(
                    target=self._run, name="w", daemon=True)

            def _run(self):
                pass

            def close(self):
                self._stop.set()
    """, thread_regs(("event", "_stop"), joined_in=None, name="w"))
    assert rules(findings) == {threads.RULE_NO_JOIN}
    assert "why_no_join" in findings[0].message


def test_threads_bounded_writer_joined_by_wait():
    """The port's ``("bounded", why)`` stop (the checkpoint writer): only
    the registration and the join are checked."""
    text = """
        import threading

        class C:
            def save(self):
                self._writer = threading.Thread(
                    target=self._run, name="w", daemon=True)

            def _run(self):
                pass

            def {joiner}(self):
                self._writer.join()
    """
    _, reg = thread_regs(("bounded", "one write"), joined_in="wait",
                         name="w", owner="C")
    assert threads.check_sources([src(text.format(joiner="wait"),
                                      "mod.py")], reg) == []
    findings = threads.check_sources([src(text.format(joiner="close"),
                                          "mod.py")], reg)
    assert rules(findings) == {threads.RULE_NO_JOIN}


# ---------------------------------------------------------------------------
# blocking-while-locked
# ---------------------------------------------------------------------------

BLOCK_LOCKS = {"replay_lock", "_cv"}


def blocking_findings(text: str, path: str = "mod.py"):
    def run(mod):
        return lambda s: mod.check_sources(s, lock_names=BLOCK_LOCKS,
                                           unlocked=frozenset({"__init__"}))
    return twin(run(ref_blocking), run(blocking), text, path)


def test_blocking_sleep_under_lock_caught():
    findings = blocking_findings("""
        import time

        class S:
            def flush(self):
                with self.replay_lock:
                    time.sleep(0.1)
    """)
    assert rules(findings) == {blocking.RULE}
    assert "time.sleep()" in findings[0].message


def test_blocking_off_lock_clean():
    assert blocking_findings("""
        import time

        class S:
            def flush(self):
                with self.replay_lock:
                    rows = self.pop()
                time.sleep(0.1)
    """) == []


def test_blocking_interprocedural_callee_expansion():
    """The fsync lives two calls away from the lock: the finding lands
    on the blocking line, with the lock-entry site in the message."""
    findings = blocking_findings("""
        import os

        class S:
            def snapshot(self):
                with self.replay_lock:
                    self._persist()

            def _persist(self):
                self._sync()

            def _sync(self):
                os.fsync(self.fd)
    """)
    assert rules(findings) == {blocking.RULE}
    [f] = findings
    assert "os.fsync()" in f.message and "entered from mod.py:" in f.message


def test_blocking_cv_wait_on_held_lock_exempt_foreign_wait_caught():
    findings = blocking_findings("""
        class S:
            def take(self):
                with self._cv:
                    while not self.ready:
                        self._cv.wait()

            def bad(self):
                with self._cv:
                    self.other_event.wait()
    """)
    assert [f.rule for f in findings] == [blocking.RULE]
    assert "foreign event" in findings[0].message


def test_blocking_pragma_suppresses():
    assert blocking_findings("""
        class C:
            def call(self):
                with self.replay_lock:
                    return recv_msg(self.sock)  # ddq: allow(blocking.under-lock)
    """) == []


def test_blocking_init_is_not_a_lock_root():
    assert blocking_findings("""
        import time

        class S:
            def __init__(self):
                with self.replay_lock:
                    time.sleep(0.1)
    """) == []


def test_blocking_card_wait_under_lock_caught():
    """The port's torch waits: a stream/event/device synchronize under a
    lock blocks like the reference's ``block_until_ready``."""
    findings = blocking.check_sources([src("""
        import torch

        class S:
            def flush(self):
                with self.replay_lock:
                    torch.cuda.synchronize()
                    self.done.synchronize()
    """, "mod.py")], lock_names=BLOCK_LOCKS, unlocked=frozenset())
    assert [f.line for f in findings] == [7, 8]


# ---------------------------------------------------------------------------
# condition-variable discipline
# ---------------------------------------------------------------------------


def cv_twin(text: str):
    return lock_twin(
        text, reg=locks.LockRegistry(conditions=frozenset({"_cv"})),
        ref_reg=ref_locks.LockRegistry(conditions=frozenset({"_cv"})))


def test_cv_wait_without_while_caught():
    findings = cv_twin("""
        class S:
            def take(self):
                with self._cv:
                    if not self.ready:
                        self._cv.wait()
    """)
    assert rules(findings) == {locks.RULE_CV_WAIT}


def test_cv_wait_in_while_and_wait_for_clean():
    assert cv_twin("""
        class S:
            def take(self):
                with self._cv:
                    while not self.ready:
                        self._cv.wait()

            def take2(self):
                with self._cv:
                    self._cv.wait_for(lambda: self.ready)
    """) == []


def test_cv_notify_without_lock_caught():
    findings = cv_twin("""
        class S:
            def put(self, row):
                self.rows.append(row)
                self._cv.notify_all()
    """)
    assert rules(findings) == {locks.RULE_CV_NOTIFY}


def test_cv_notify_under_lock_clean():
    assert cv_twin("""
        class S:
            def put(self, row):
                with self._cv:
                    self.rows.append(row)
                    self._cv.notify_all()
    """) == []


# ---------------------------------------------------------------------------
# the port's registries against the port's source
# ---------------------------------------------------------------------------


def test_threads_and_blocking_self_host_zero():
    assert threads.check(REPO) == []
    assert blocking.check(REPO) == []


def _non_tool_modules() -> list[Source]:
    paths = [p for p in package_files(REPO, tools=False)
             if os.sep + "analysis" + os.sep not in p]
    return load_sources(REPO, paths)


_LOCK_TYPES = {"Lock", "RLock", "Condition"}


def _branches(value: ast.AST):
    """``value``, and the branches of an ``a if c else b`` / ``a or b``."""
    yield value
    if isinstance(value, ast.IfExp):
        yield from _branches(value.body)
        yield from _branches(value.orelse)
    elif isinstance(value, ast.BoolOp):
        for v in value.values:
            yield from _branches(v)


def _lock_sites(s: Source):
    """(line, name it is stored under or None) of every lock the module
    builds: ``x = threading.Lock()``, also through ``a if c else
    Lock()`` / ``a or Lock()``; a lock built as a call argument has the
    callee's parameter name (None here)."""
    stored: dict[int, str] = {}
    for node in s.nodes(ast.Assign, ast.AnnAssign):
        target = node.targets[0] if isinstance(node, ast.Assign) \
            else node.target
        name = target.attr if isinstance(target, ast.Attribute) else \
            target.id if isinstance(target, ast.Name) else None
        for sub in _branches(node.value) if node.value and name else ():
            stored[id(sub)] = name
    for node in s.nodes(ast.Call):
        if (call_name(node) or "").rsplit(".", 1)[-1] in _LOCK_TYPES \
                and (call_name(node) or "").startswith("threading."):
            yield node.lineno, stored.get(id(node))


def test_lock_registry_names_every_lock_of_the_port():
    """Every lock the port's non-tool modules build lies in a file the
    lock pass walks, under a name the registry knows (a guard's lock, a
    condition, a module-global table, a ``bare`` entry or a serialization
    token)."""
    reg = locks.DEFAULT_REGISTRY
    names = reg.lock_names() | {lock for _, _, lock in reg.tokens}
    seen = 0
    for s in _non_tool_modules():
        for line, name in _lock_sites(s):
            seen += 1
            assert s.path in reg.files, f"{s.path}:{line} is not walked"
            if name is not None:
                assert name in names, f"{s.path}:{line} {name} unregistered"
    assert seen >= 25
    for (path, owner, lock), why in {**reg.bare, **reg.tokens}.items():
        assert path in reg.files and owner and lock in names and why
    assert not {lock for _, _, lock in reg.tokens} & reg.lock_names()
    # the port's own locks, by name
    assert reg.attrs["forwards"] == locks.Guard("_lock", "BatchedPolicy")
    assert reg.attrs["_replay"] == locks.Guard("_lock", "FusedStepStream")


def test_thread_registry_walks_every_spawn_of_the_port():
    """Every ``threading.Thread(`` of the port's non-tool modules lies in
    a file the thread pass walks (which then holds it registered), the
    checkpoint writer among them."""
    files = set(threads.DEFAULT_THREADS.files)
    spawns = [(s.path, node.lineno) for s in _non_tool_modules()
              for node in s.nodes(ast.Call)
              if (call_name(node) or "").endswith("threading.Thread")]
    assert spawns and all(path in files for path, _ in spawns), spawns
    assert any(path == pkg("utils", "checkpoint.py") for path, _ in spawns)
    assert (pkg("utils", "checkpoint.py"), "_write") in \
        threads.DEFAULT_THREADS.specs


def test_registries_keep_every_reference_spec_the_port_has():
    """Each reference guard, condition and thread spec whose class the
    port has is in the port's registry, unchanged but for the path."""
    for attr, guard in ref_locks.DEFAULT_REGISTRY.attrs.items():
        assert locks.DEFAULT_REGISTRY.attrs[attr] == locks.Guard(
            guard.lock, guard.owner, guard.receivers), attr
    assert ref_locks.DEFAULT_REGISTRY.conditions <= \
        locks.DEFAULT_REGISTRY.conditions
    for (path, target), spec in ref_threads.DEFAULT_THREADS.specs.items():
        mine = threads.DEFAULT_THREADS.specs[(_mapped(path), target)]
        assert (mine.name, mine.owner, mine.stop, mine.joined_in,
                mine.daemon) == (spec.name, spec.owner, spec.stop,
                                 spec.joined_in, spec.daemon)
    assert {_mapped(f) for f in ref_locks.DEFAULT_REGISTRY.files} <= \
        set(locks.DEFAULT_REGISTRY.files)
    assert {_mapped(f) for f in ref_threads.DEFAULT_THREADS.files} <= \
        set(threads.DEFAULT_THREADS.files)


PLANTED = """
import numpy as np
import threading


def dump(path, state, client):
    np.savez(path, **state)
    client.call("no_such_verb")
    threading.Thread(target=dump, daemon=True).start()
    return "queue/no_such_metric"
"""


def test_port_passes_scan_the_port_package_only(tmp_path):
    """No pass of the port's gate reads ``tests/``, ``scripts/`` or
    another package: a module that breaks three passes, planted in each of
    them beside a copy of the port, is not seen; planted in the port, it
    is. The tool modules are scanned by the passes that scan the
    reference's ``scripts/`` only."""
    shutil.copytree(os.path.join(REPO, PACKAGE), tmp_path / PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    for d in ("tests", "scripts", REF_PACKAGE):
        (tmp_path / d).mkdir()
        (tmp_path / d / "planted.py").write_text(PLANTED)
    assert port.run_all(str(tmp_path)) == []
    (tmp_path / PACKAGE / "planted.py").write_text(PLANTED)
    assert rules(port.run_all(str(tmp_path))) == {
        "durability.raw-write", "protocol.unhandled-method",
        "metric_keys.unknown-metric"}
    (tmp_path / PACKAGE / "planted.py").unlink()
    tool = tmp_path / PACKAGE / "chaos_smoke.py"
    tool.write_text(tool.read_text() + PLANTED)
    assert rules(port.run_all(str(tmp_path))) == {
        "protocol.unhandled-method", "metric_keys.unknown-metric"}
