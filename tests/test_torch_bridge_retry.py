"""Twins of ``tests/bridge/test_retry.py`` and ``tests/bridge/test_health.py``
on the port's bridge: the client's retries across a durable server's kill
and restart, the idempotence window (in memory and persisted), admission's
``{busy, RetryAfterMs}``, per-call timeouts, the bounded idem log, and the
``{health}`` verb over the port's convergence monitor — each against a
``BridgeServer(device="cpu")``."""

import json
import socket
import time

import pytest
import torch

from lasp_tpu_torch import telemetry
from lasp_tpu_torch.bridge import BridgeClient
from lasp_tpu_torch.bridge import BridgeServer as _Server
from lasp_tpu_torch.bridge.etf import Atom

torch.set_num_threads(1)


def BridgeServer(*args, **kwargs):
    """The port's server, on the CPU."""
    kwargs.setdefault("device", "cpu")
    return _Server(*args, **kwargs)


def _restart_on(port: int, **kwargs) -> BridgeServer:
    """Bind a fresh server to a just-freed port (SO_REUSEADDR races on
    loaded hosts: retry briefly instead of flaking)."""
    for _ in range(50):
        try:
            server = BridgeServer(port=port, **kwargs)
            server.start()
            return server
        except OSError:
            time.sleep(0.05)
    raise RuntimeError(f"could not rebind port {port}")


def test_idempotent_verbs_survive_server_restart(tmp_path):
    """Kill and restart a DURABLE BridgeServer mid-session: the client's
    reads retry through the outage, reconnect, replay {start, Name}, and
    see the persisted state."""
    data = str(tmp_path / "bridge_data")
    server = BridgeServer(port=0, data_dir=data)
    port = server.start()
    try:
        c = BridgeClient("127.0.0.1", port, timeout=5.0, retries=4,
                         backoff=0.05)
        assert c.start("soak")[0] == Atom("ok")
        c.declare(b"v", "lasp_gset", n_elems=8)
        c.update(b"v", (Atom("add"), b"x"), b"w")
        assert c.get(b"v")[0] == Atom("ok")

        server.stop()
        server = _restart_on(port, data_dir=data)

        # idempotent read: retried + reconnected + session replayed; the
        # durable store's state survived the restart
        resp = c.get(b"v")
        assert resp[0] == Atom("ok")
        # metrics/health work across the same reconnect machinery
        ok, payload = c.metrics()
        assert ok == Atom("ok") and b"bridge_requests_total" in payload
        c.close()
    finally:
        server.stop()


def test_unwrapped_non_idempotent_verbs_fail_fast():
    server = BridgeServer(port=0)
    port = server.start()
    c = BridgeClient("127.0.0.1", port, timeout=5.0, retries=3,
                     backoff=0.01, idem_writes=False)
    assert c.start("s")[0] == Atom("ok")
    c.declare(b"v", "riak_dt_gcounter")
    # connect BEFORE the kill: constructing a client against a stopped
    # server fails in the constructor, not in the verb under test
    c2 = BridgeClient("127.0.0.1", port, timeout=5.0, retries=3,
                      backoff=0.01)
    assert c2.start("s2")[0] == Atom("ok")
    server.stop()
    with pytest.raises(ConnectionError, match="never retried"):
        # with idem_writes off there is no request id: a lost
        # increment's outcome is unknown and blind replay could
        # double-count — the client must fail fast, not retry
        c.update(b"v", (Atom("increment"),), b"w")
    # merge_batch carries no id either way and stays fail-fast
    with pytest.raises(ConnectionError):
        c2.merge_batch([(b"v", [])])
    c.close()
    c2.close()


def test_idem_update_retries_through_kill_restart(tmp_path):
    """The satellite contract: a mid-update server kill/restart. The
    client's update carries a request id, retries through the outage on
    the same backoff path as reads, replays {start, Name}, and applies
    EXACTLY ONCE on the restarted durable store."""
    data = str(tmp_path / "bridge_data")
    server = BridgeServer(port=0, data_dir=data)
    port = server.start()
    try:
        c = BridgeClient("127.0.0.1", port, timeout=5.0, retries=4,
                         backoff=0.05)
        assert c.start("soak")[0] == Atom("ok")
        c.declare(b"v", "riak_dt_gcounter")
        server.stop()  # the server dies mid-session...
        server = _restart_on(port, data_dir=data)
        # ...and the non-idempotent write still lands, once
        ok, value = c.update(b"v", (Atom("increment"),), b"w")
        assert ok == Atom("ok")
        assert value == 1
        c.close()
    finally:
        server.stop()


def test_idem_dedup_suppresses_replay_of_applied_write(tmp_path):
    """The ambiguous-outcome case the dedup window exists for: the op
    APPLIED but the reply was lost. Replaying the identical idem frame
    (what the retry path sends) must return the first response without
    re-executing — including across a durable server restart, where the
    persisted window is the only memory of the first execution."""
    import os

    data = str(tmp_path / "bridge_data")
    server = BridgeServer(port=0, data_dir=data)
    port = server.start()
    try:
        c = BridgeClient("127.0.0.1", port, timeout=5.0, retries=4,
                         backoff=0.05)
        assert c.start("soak")[0] == Atom("ok")
        c.declare(b"v", "riak_dt_gcounter")
        reqid = os.urandom(16)
        frame = (Atom("idem"), reqid, (Atom("update"), b"v",
                                       (Atom("increment"),), b"w"))
        first = c.call(frame, idempotent=True)
        assert first == (Atom("ok"), 1)
        # same-process replay: served from the window, not re-applied
        assert c.call(frame, idempotent=True) == first
        server.stop()
        server = _restart_on(port, data_dir=data)
        # post-restart replay: the window was persisted with the store
        assert c.call(frame, idempotent=True) == first
        assert c.read(b"v") == (Atom("ok"), 1)  # applied exactly once
        c.close()
    finally:
        server.stop()


def test_idem_scope_is_per_connection_for_in_memory_stores():
    """In-memory stores die with their connection: a second connection
    re-using a request id must NOT be answered from another store's
    window (the write never happened on ITS store)."""
    import os

    server = BridgeServer(port=0)
    port = server.start()
    reqid = os.urandom(16)
    frame = (Atom("idem"), reqid, (Atom("update"), b"v",
                                   (Atom("increment"),), b"w"))
    c1 = BridgeClient("127.0.0.1", port)
    assert c1.start("s")[0] == Atom("ok")
    c1.declare(b"v", "riak_dt_gcounter")
    assert c1.call(frame) == (Atom("ok"), 1)
    assert c1.call(frame) == (Atom("ok"), 1)  # deduped
    c2 = BridgeClient("127.0.0.1", port)
    assert c2.start("s")[0] == Atom("ok")
    c2.declare(b"v", "riak_dt_gcounter")
    # fresh store, fresh window: the id executes here
    assert c2.call(frame) == (Atom("ok"), 1)
    c1.close()
    c2.close()


def test_idempotent_retry_exhaustion_raises():
    server = BridgeServer(port=0)
    port = server.start()
    c = BridgeClient("127.0.0.1", port, timeout=0.5, retries=2,
                     backoff=0.01)
    assert c.start("s")[0] == Atom("ok")
    server.stop()  # nothing ever comes back
    with pytest.raises(ConnectionError, match="after 3 attempts"):
        c.metrics()
    c.close()


def test_explicit_idempotent_override_retries_update(tmp_path):
    """A caller that KNOWS its op is an idempotent CRDT write (a set
    add) can opt into replay across a restart."""
    data = str(tmp_path / "bridge_data")
    server = BridgeServer(port=0, data_dir=data)
    port = server.start()
    try:
        c = BridgeClient("127.0.0.1", port, timeout=5.0, retries=4,
                         backoff=0.05)
        assert c.start("s2")[0] == Atom("ok")
        c.declare(b"v", "lasp_gset", n_elems=8)
        server.stop()
        server = _restart_on(port, data_dir=data)
        resp = c.call(
            (Atom("update"), b"v", (Atom("add"), b"x"), b"w"),
            idempotent=True,
        )
        assert resp[0] == Atom("ok")
        c.close()
    finally:
        server.stop()


class _ShedFirst:
    """Admission probe shedding the first ``n`` requests with a
    retry-after hint, then admitting everything."""

    def __init__(self, n, retry_ms=25):
        self.n = n
        self.retry_ms = retry_ms
        self.seen = 0

    def __call__(self, kind):
        self.seen += 1
        return self.retry_ms if self.seen <= self.n else None


def test_busy_reply_backs_off_and_retries_idempotent_reads():
    """The server's {busy, RetryAfterMs} on an overloaded read: the
    client honors the hint (capped jittered backoff), retries on the
    SAME healthy connection, and succeeds once admission clears."""
    shed = _ShedFirst(0)
    server = BridgeServer(port=0, admission=shed)
    port = server.start()
    try:
        c = BridgeClient("127.0.0.1", port, timeout=5.0, retries=4,
                         backoff=0.01)
        assert c.start("s")[0] == Atom("ok")
        c.declare(b"v", "lasp_gset", n_elems=8)
        shed.n, shed.seen = 2, 0  # now shed the next two requests
        t0 = time.time()
        resp = c.get(b"v")
        assert resp[0] == Atom("ok")
        assert shed.seen == 3  # 2 sheds + the admitted retry
        assert time.time() - t0 >= 0.02  # it actually backed off
        c.close()
    finally:
        server.stop()


def test_idem_wrapped_write_retries_through_busy_exactly_once():
    """update/bind ride the idempotent path via {idem, ReqId, _}: a
    busy reply backs off and retries, and the dedup window keeps the
    eventually-admitted write at-most-once."""
    shed = _ShedFirst(0)
    server = BridgeServer(port=0, admission=shed)
    port = server.start()
    try:
        c = BridgeClient("127.0.0.1", port, timeout=5.0, retries=4,
                         backoff=0.01)
        assert c.start("s")[0] == Atom("ok")
        c.declare(b"v", "riak_dt_gcounter")
        shed.n, shed.seen = 1, 0  # shed the next write once
        ok, value = c.update(b"v", (Atom("increment"),), b"w")
        assert ok == Atom("ok") and value == 1
        assert c.read(b"v") == (Atom("ok"), 1)  # applied exactly once
        c.close()
    finally:
        server.stop()


def test_non_idempotent_busy_surfaces_typed_overload_error():
    """With idem_writes off there is no safe replay: a shed write must
    surface a typed OverloadError carrying the retry-after hint, never
    blind-retry and never silently drop."""
    from lasp_tpu_torch.serve import OverloadError

    server = BridgeServer(port=0, admission=lambda kind: 150)
    port = server.start()
    try:
        c = BridgeClient("127.0.0.1", port, timeout=5.0, retries=3,
                         backoff=0.01, idem_writes=False)
        assert c.start("s")[0] == Atom("ok")  # control verbs always pass
        with pytest.raises(OverloadError) as exc:
            c.update(b"v", (Atom("increment"),), b"w")
        assert exc.value.retry_after_ms == 150
        # merge_batch is fail-fast too (its replay is the caller's call)
        with pytest.raises(OverloadError):
            c.merge_batch([(b"v", [])])
        # an idempotent read that stays shed through every attempt also
        # ends in the typed error, not a silent give-up
        with pytest.raises(OverloadError):
            c.call((Atom("keys"),))
        c.close()
    finally:
        server.stop()


def test_metrics_and_health_bypass_admission():
    server = BridgeServer(port=0, admission=lambda kind: 500)
    port = server.start()
    try:
        c = BridgeClient("127.0.0.1", port, timeout=5.0, retries=0)
        ok, payload = c.metrics()
        assert ok == Atom("ok")
        ok, _health = c.health()
        assert ok == Atom("ok")
        c.close()
    finally:
        server.stop()


def test_concurrent_callers_share_one_socket_without_corruption():
    """The satellite bugfix: two threads sharing one BridgeClient used
    to interleave their frames mid-verb and corrupt the wire stream.
    The per-connection lock serializes exchanges; every caller gets
    its own well-formed answer."""
    import threading

    server = BridgeServer(port=0)
    port = server.start()
    try:
        c = BridgeClient("127.0.0.1", port, timeout=10.0)
        assert c.start("s")[0] == Atom("ok")
        c.declare(b"v", "riak_dt_gcounter", n_actors=32)
        errors: list = []

        def worker(w):
            try:
                for i in range(40):
                    ok, _val = c.update(
                        b"v", (Atom("increment"),), f"w{w}".encode()
                    )
                    assert ok == Atom("ok")
                    ok, total = c.read(b"v")
                    assert ok == Atom("ok")
                    assert isinstance(total, int) and total >= i + 1
            except Exception as exc:  # surfaced after join
                errors.append(f"{type(exc).__name__}: {exc}")

        threads = [
            threading.Thread(target=worker, args=(w,)) for w in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        assert c.read(b"v") == (Atom("ok"), 160)
        c.close()
    finally:
        server.stop()


def test_per_call_timeout_applies():
    """The per-call timeout reaches the socket: a server that accepts
    but never answers trips the deadline instead of hanging."""
    sink = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sink.bind(("127.0.0.1", 0))
    sink.listen(1)
    port = sink.getsockname()[1]
    try:
        c = BridgeClient("127.0.0.1", port, timeout=30.0, retries=0)
        t0 = time.monotonic()
        with pytest.raises(ConnectionError):
            c.call((Atom("metrics"),), timeout=0.3)
        assert time.monotonic() - t0 < 5.0
        c.close()
    finally:
        sink.close()


def test_idem_log_bounded_across_restart_heavy_sessions(tmp_path):
    """The durable idem-record satellite: sessions that each stay under
    the in-session compaction threshold used to grow the host log
    WITHOUT BOUND across restarts (superseded varmeta/leaf records plus
    evicted idem:<reqid> tombstones pile up while the live key set
    stays constant). The open-time waste-cue compaction folds them: the
    file plateaus, the reloaded dedup window stays <= the 256-entry
    bound, and the on-disk idem record count matches it."""
    import os

    data = str(tmp_path / "bridge_data")
    path = os.path.join(data, "soak")
    sizes = []
    for session in range(6):
        server = BridgeServer(port=0, data_dir=data)
        port = server.start()
        c = BridgeClient("127.0.0.1", port, timeout=5.0, retries=2,
                         backoff=0.02)
        assert c.start("soak")[0] == Atom("ok")
        if session == 0:
            c.declare(b"v", "riak_dt_gcounter")
        for _ in range(100):  # < _COMPACT_EVERY: never compacts in-run
            c.update(b"v", (Atom("increment"),), b"w")
        c.close()
        server.stop()
        sizes.append(os.path.getsize(path))
    # bounded: the tail has PLATEAUED — the file oscillates with the
    # compaction phase, so compare same-phase samples (without the
    # open-time compaction it grew ~60KB per session, strictly
    # monotone: [57k, 113k, 172k, 235k, 297k, 360k])
    assert sizes[-1] <= sizes[-3] + 16384, sizes
    assert sizes[-1] < 4 * sizes[0], sizes
    # the reloaded window and the on-disk record census both hold the
    # <= 256 bound after 600 idem-wrapped writes
    from lasp_tpu_torch.store.host_store import HostStore

    hs = HostStore(path)
    try:
        idem_keys = [k for k in hs.keys() if k.startswith("idem:")]
        assert len(idem_keys) <= 256
    finally:
        hs.close()
    server = BridgeServer(port=0, data_dir=data)
    port = server.start()
    try:
        c = BridgeClient("127.0.0.1", port, timeout=5.0)
        assert c.start("soak")[0] == Atom("ok")
        window = server._idem_windows.get("soak")
        assert window is not None and len(window) <= 256
        ok, value = c.get(b"v")  # portable form: (type, [(actor, n)])
        assert ok == Atom("ok") and value[1] == [(b"w", 600)]  # no loss
        c.close()
    finally:
        server.stop()


def test_health_verb_before_start():
    telemetry.reset()
    with BridgeServer(port=0) as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            resp = c.health()  # deliberately BEFORE start
    assert isinstance(resp, tuple) and len(resp) == 2
    assert str(resp[0]) == "ok"
    health = json.loads(resp[1].decode())
    for key in ("round", "residual_by_var", "staleness", "top_divergent",
                "quiescence_eta", "alerts", "thresholds"):
        assert key in health, key
    assert isinstance(health["alerts"], list)


def test_health_reflects_mesh_activity():
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import ReplicatedRuntime, ring
    from lasp_tpu_torch.store import Store

    telemetry.reset()
    store = Store(n_actors=8, device="cpu")
    v = store.declare(id="seen", type="lasp_gset", n_elems=8)
    rt = ReplicatedRuntime(store, Graph(store), 8, ring(8, 2), device="cpu")
    rt.update_at(0, v, ("add", "x"), "w")
    rounds = rt.run_to_convergence(max_rounds=16)
    with BridgeServer(port=0) as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            resp = c.health()
    health = json.loads(resp[1].decode())
    assert health["round"] == rounds
    assert health["residual_by_var"]["seen"] == 0
    assert health["n_replicas"] == 8
    # the health verb is metered like every other verb
    with BridgeServer(port=0) as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            c.health()
            resp = c.call((Atom("metrics"),))
    text = resp[1].decode()
    assert 'bridge_requests_total{verb="health"}' in text
