"""Twins of ``tests/bridge/test_bridge.py`` on the port's bridge
(``lasp_tpu_torch.bridge``): the same loopback conformance tests against a
``BridgeServer(device="cpu")``. Every exchange of an in-memory session is
recorded, and when the client closes the same request frames are replayed
through the JAX package's ``_Conn.handle``: its responses must equal the
port's byte for byte (``metrics`` / ``health`` aside: they read each
package's own telemetry registry). Durable sessions are held against JAX
by ``tests/test_torch_bridge_cross.py``."""

import pytest
import torch

from lasp_tpu.bridge import etf as jetf
from lasp_tpu.bridge.server import _Conn as JConn
from lasp_tpu_torch.bridge import Atom
from lasp_tpu_torch.bridge import BridgeClient as _Client
from lasp_tpu_torch.bridge import BridgeServer as _Server
from lasp_tpu_torch.bridge import etf as tetf

torch.set_num_threads(1)

#: live servers by port, so a client can tell an in-memory, unrestarted
#: server (its transcript replays through JAX) from the rest
_SERVERS: dict = {}
_UNREPLAYED = ("metrics", "health")


class BridgeServer(_Server):
    """The port's server, on the CPU."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("device", "cpu")
        super().__init__(*args, **kwargs)

    def start(self) -> int:
        port = super().start()
        _SERVERS[port] = self
        return port


class BridgeClient(_Client):
    """The port's client, recording ``(request bytes, response bytes)``
    per exchange; :meth:`close` replays them through a fresh JAX
    ``_Conn`` when the session was in memory and never reconnected."""

    def __init__(self, host, port, *args, **kwargs):
        super().__init__(host, port, *args, **kwargs)
        self._server = _SERVERS.get(port)
        self._transcript = []
        self._reconnected = False

    def _reconnect(self):
        self._reconnected = True
        super()._reconnect()

    def call(self, term, **kwargs):
        resp = super().call(term, **kwargs)
        verb = str(term[0]) if isinstance(term, tuple) and term else "?"
        if verb not in _UNREPLAYED:
            self._transcript.append((tetf.encode(term), tetf.encode(resp)))
        return resp

    def close(self):
        super().close()
        server = self._server
        if (server is None or server.data_dir is not None
                or server.admission is not None or self._reconnected
                or _SERVERS.get(server.port) is not server):
            return
        conn = JConn(server.n_actors, None, {}, {})
        for i, (req, resp) in enumerate(self._transcript):
            got = jetf.encode(conn.handle(jetf.decode(req)))
            assert got == resp, (i, jetf.decode(req), jetf.decode(got),
                                 tetf.decode(resp))


def test_transcripts_replay_through_jax():
    """The replay itself: a session's frames through JAX's ``_Conn`` give
    the port's bytes (and a divergent byte would fail the close)."""
    with BridgeServer() as server:
        c = BridgeClient("127.0.0.1", server.port)
        c.start("v")
        c.declare(b"s", "riak_dt_orswot", n_elems=4, n_actors=2)
        c.update(b"s", (Atom("add"), b"x"), b"a1")
        c.get(b"s")
        assert len(c._transcript) == 4
        c.close()


@pytest.fixture()
def client():
    with BridgeServer() as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            assert c.start("vnode_0") == (Atom("ok"), Atom("vnode_0"))
            yield c


def test_requires_start_first():
    with BridgeServer() as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            resp = c.get(b"x")
            assert resp[0] == Atom("error") and resp[1] == Atom("not_started")


def test_declare_update_read_round_trip(client):
    assert client.declare(b"s", "lasp_orset", n_elems=8) == (Atom("ok"), b"s")
    ok, val = client.update(b"s", (Atom("add"), b"x"), b"actor1")
    assert ok == Atom("ok") and val == [b"x"]
    ok, val = client.update(b"s", (Atom("add_all"), [b"y", b"z"]), b"actor1")
    assert ok == Atom("ok") and set(val) == {b"x", b"y", b"z"}
    ok, val = client.update(b"s", (Atom("remove"), b"y"), b"actor1")
    assert set(val) == {b"x", b"z"}
    assert client.read(b"s") == (Atom("ok"), [b"x", b"z"])


def test_get_put_backend_contract(client):
    """start/put/get — the literal lasp_backend behaviour round trip."""
    client.declare(b"c", "riak_dt_gcounter", n_actors=4)
    client.update(b"c", (Atom("increment"), 3), b"a1")
    client.update(b"c", (Atom("increment"),), b"a2")
    ok, (type_atom, portable) = client.get(b"c")
    assert ok == Atom("ok") and type_atom == Atom("riak_dt_gcounter")
    assert sorted(portable) == [(b"a1", 3), (b"a2", 1)]
    # blind put of an externally-merged state (the ets:insert role)
    assert client.put(
        b"c2", "riak_dt_gcounter", [(b"a1", 7), (b"a3", 2)], n_actors=4
    ) == Atom("ok")
    assert client.read(b"c2") == (Atom("ok"), 9)
    assert client.get(b"missing") == (Atom("error"), Atom("not_found"))


def test_bind_merges_through_inflation_gate(client):
    client.declare(b"s", "lasp_orset", n_elems=8, n_actors=2,
                   tokens_per_actor=4)
    client.update(b"s", (Atom("add"), b"x"), b"w1")
    # a remote replica's state: x tombstoned under token 0, plus new elem y
    remote = [(b"x", [(0, True)]), (b"y", [(4, False)])]
    ok, val = client.bind(b"s", remote)
    assert ok == Atom("ok")
    assert val == [b"y"]  # x's only token tombstoned; y joined in
    # binding an OLD state is a non-inflation no-op (bind rule)
    ok, val = client.bind(b"s", [(b"x", [(0, False)])])
    assert val == [b"y"]


def test_merge_batch_anti_entropy(client):
    client.declare(b"a", "lasp_orset", n_elems=8)
    client.declare(b"b", "lasp_gset", n_elems=8)
    client.update(b"a", (Atom("add"), b"local"), b"w")
    resp = client.merge_batch([
        (b"a", [(b"remote", [(0, False)])]),
        (b"b", [b"g1", b"g2"]),
    ])
    assert resp == (Atom("ok"), 2)
    assert client.read(b"a") == (Atom("ok"), [b"local", b"remote"])
    assert client.read(b"b") == (Atom("ok"), [b"g1", b"g2"])


def test_ivar_bridge(client):
    client.declare(b"v", "lasp_ivar")
    client.update(b"v", (Atom("set"), b"payload"), b"w")
    ok, (type_atom, portable) = client.get(b"v")
    assert portable == (Atom("value"), b"payload")


def test_errors_are_terms_not_disconnects(client):
    client.declare(b"s", "lasp_orset", n_elems=4)
    resp = client.update(b"s", (Atom("remove"), b"ghost"), b"w")
    assert resp[0] == Atom("error") and resp[1] == Atom("PreconditionError")
    # the connection is still serviceable after an error
    assert client.read(b"s") == (Atom("ok"), [])
    resp = client.call((Atom("bogus_verb"), 1))
    assert resp[0] == Atom("error")


def test_connections_are_isolated_stores():
    with BridgeServer() as server:
        with BridgeClient("127.0.0.1", server.port) as c1, BridgeClient(
            "127.0.0.1", server.port
        ) as c2:
            c1.start("vnode_1")
            c2.start("vnode_2")
            c1.declare(b"s", "lasp_gset", n_elems=4)
            c1.update(b"s", (Atom("add"), b"only-1"), b"w")
            c2.declare(b"s", "lasp_gset", n_elems=4)
            assert c2.read(b"s") == (Atom("ok"), [])
            assert c1.read(b"s") == (Atom("ok"), [b"only-1"])


def test_malformed_frames_get_error_terms_not_disconnects():
    """Truncated/garbage ETF must come back as an error term on a live
    connection, never kill the server thread."""
    from lasp_tpu_torch.bridge.server import _recv_frame, _send_frame

    with BridgeServer() as server:
        import socket

        with socket.create_connection(("127.0.0.1", server.port), 5) as s:
            for bad in (b"\x83\x62\x00",          # truncated INT_EXT
                        b"\x83\x77\x02\xff\xfe",  # invalid-UTF8 atom
                        b"junk"):                  # no version byte
                _send_frame(s, bad)
                resp = _recv_frame(s)
                assert resp is not None
                from lasp_tpu_torch.bridge import etf
                term = etf.decode(resp)
                assert term[0] == Atom("error") and term[1] == Atom("etf_decode")
            # connection still serviceable
            _send_frame(s, etf.encode((Atom("start"), Atom("v"))))
            assert etf.decode(_recv_frame(s)) == (Atom("ok"), Atom("v"))


def test_list_and_tuple_ids_are_distinct_and_round_trip():
    with BridgeServer() as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            c.start("v")
            assert c.declare([1, 2], "lasp_gset", n_elems=4) == (
                Atom("ok"), [1, 2]
            )
            assert c.declare((1, 2), "riak_dt_gcounter", n_actors=2) == (
                Atom("ok"), (1, 2)
            )
            c.update([1, 2], (Atom("add"), b"e"), b"w")
            c.update((1, 2), (Atom("increment"), 5), b"w")
            assert c.read([1, 2]) == (Atom("ok"), [b"e"])
            assert c.read((1, 2)) == (Atom("ok"), 5)
            ok, keys = c.call((Atom("keys"),))
            assert ok == Atom("ok")
            assert [1, 2] in keys and (1, 2) in keys
            # container-valued ELEMENTS round-trip shape-faithfully too
            c.declare(b"s", "lasp_gset", n_elems=4)
            c.update(b"s", (Atom("add"), [b"x", 1]), b"w")
            c.update(b"s", (Atom("add"), (b"x", 1)), b"w")
            ok, val = c.read(b"s")
            assert [b"x", 1] in val and (b"x", 1) in val and len(val) == 2


def test_stop_disconnects_live_clients():
    server = BridgeServer()
    server.start()
    c = BridgeClient("127.0.0.1", server.port)
    c.start("v")
    server.stop()
    import pytest as _pytest

    with _pytest.raises((ConnectionError, OSError)):
        for _ in range(3):  # first call may see the buffered close late
            c.call((Atom("keys"),))
    c.close()


def test_cli_bridge_verb_serves():
    """`cli bridge` starts a servable endpoint (run in-process via the
    server class path the verb uses; the verb itself just wraps it)."""
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    proc = subprocess.Popen(
        [sys.executable, "-m", "lasp_tpu_torch.cli", "bridge", "--port", "0",
         "--device", "cpu"],
        stdout=subprocess.PIPE,
        text=True,
        env=env,
    )
    try:
        import json as _json

        line = proc.stdout.readline()
        port = int(_json.loads(line)["listening"].rsplit(":", 1)[1])
        with BridgeClient("127.0.0.1", port) as c:
            c.start("v")
            c.declare(b"s", "lasp_gset", n_elems=2)
            c.update(b"s", (Atom("add"), b"e"), b"w")
            assert c.read(b"s") == (Atom("ok"), [b"e"])
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_durable_store_survives_reconnect(tmp_path):
    """data_dir makes {start, Name} a durable per-name store (the
    eleveldb per-partition role, src/lasp_eleveldb_backend.erl:38-53):
    state written through one connection is there for the next one."""
    d = str(tmp_path / "stores")
    with BridgeServer(data_dir=d) as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            assert c.start("vnode_1") == (Atom("ok"), Atom("vnode_1"))
            c.declare(b"s", "lasp_orset", n_elems=8)
            c.update(b"s", (Atom("add_all"), [b"a", b"b"]), b"w")
            c.update(b"s", (Atom("remove"), b"a"), b"w")
        with BridgeClient("127.0.0.1", server.port) as c2:
            import time

            for _ in range(100):  # lock release lags the socket teardown
                resp = c2.start("vnode_1")
                if resp[0] == Atom("ok"):
                    break
                time.sleep(0.02)
            assert resp == (Atom("ok"), Atom("vnode_1"))
            ok, val = c2.read(b"s")
            assert ok == Atom("ok") and val == [b"b"]
    # durability spans server restarts too (fresh process over same dir)
    with BridgeServer(data_dir=d) as server2:
        with BridgeClient("127.0.0.1", server2.port) as c3:
            c3.start("vnode_1")
            ok, val = c3.read(b"s")
            assert ok == Atom("ok") and val == [b"b"]
            # a different name is a different store
            c3.start("vnode_2")
            resp = c3.read(b"s")
            assert resp[0] == Atom("error")


def test_durable_store_name_locked_while_open(tmp_path):
    d = str(tmp_path / "stores")
    with BridgeServer(data_dir=d) as server:
        with BridgeClient("127.0.0.1", server.port) as c1:
            assert c1.start("p0") == (Atom("ok"), Atom("p0"))
            with BridgeClient("127.0.0.1", server.port) as c2:
                resp = c2.start("p0")
                assert resp[0] == Atom("error") and resp[1] == Atom("locked")
                # a different partition is fine concurrently
                assert c2.start("p1") == (Atom("ok"), Atom("p1"))
        # c1 disconnected -> lock released; retry succeeds (poll: the
        # server releases on its side of the socket teardown)
        import time

        with BridgeClient("127.0.0.1", server.port) as c3:
            for _ in range(100):
                resp = c3.start("p0")
                if resp[0] == Atom("ok"):
                    break
                time.sleep(0.02)
            assert resp == (Atom("ok"), Atom("p0"))


def test_durable_store_rejects_path_names(tmp_path):
    d = str(tmp_path / "stores")
    with BridgeServer(data_dir=d) as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            resp = c.start("../escape")
            assert resp[0] == Atom("error") and resp[1] == Atom("badarg")


def test_durable_store_accepts_binary_names(tmp_path):
    """BEAM nodes send names as binaries ({start, <<"vnode_1">>})."""
    d = str(tmp_path / "stores")
    with BridgeServer(data_dir=d) as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            resp = c.start(b"vnode_bin")
            assert resp == (Atom("ok"), Atom("vnode_bin")), resp


def test_failed_durable_start_orphans_nothing(tmp_path):
    """A name REJECTED by validation leaves the previous durable store
    open (no teardown happened); a start that fails mid-open (corrupt
    log) must leave the connection with NO store rather than silently
    writing to the previous one non-durably."""
    import os

    d = str(tmp_path / "stores")
    os.makedirs(d)
    with open(os.path.join(d, "corrupt"), "wb") as f:
        f.write(b"\x00garbage not a log\xff" * 8)
    with BridgeServer(data_dir=d) as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            assert c.start("good")[0] == Atom("ok")
            c.declare(b"s", "lasp_gset", n_elems=4)
            # early rejection: old store stays open and durable
            assert c.start("../bad")[0] == Atom("error")
            ok, _ = c.update(b"s", (Atom("add"), b"x"), b"w")
            assert ok == Atom("ok")
            # mid-open failure: the connection must end up storeless
            assert c.start(b"corrupt")[0] == Atom("error")
            resp = c.update(b"s", (Atom("add"), b"y"), b"w")
            assert resp[0] == Atom("error") and resp[1] == Atom("not_started")
        # and the pre-failure write to "good" really persisted
        with BridgeClient("127.0.0.1", server.port) as c2:
            c2.start("good")
            assert c2.read(b"s") == (Atom("ok"), [b"x"])


def test_durable_merge_batch_midfail_persists_applied_prefix(tmp_path):
    """If merge_batch fails mid-batch, the applied prefix is visible on
    this connection AND in the durable log (no silent divergence)."""
    d = str(tmp_path / "stores")
    with BridgeServer(data_dir=d) as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            c.start("p")
            c.declare(b"a", "lasp_gset", n_elems=4)
            c.update(b"a", (Atom("add"), b"x"), b"w")
            live = c.get(b"a")[1]
            resp = c.call((Atom("merge_batch"),
                           [(b"a", live[1]), (b"undeclared", live[1])]))
            assert resp[0] == Atom("error")
            assert c.read(b"a") == (Atom("ok"), [b"x"])
        with BridgeClient("127.0.0.1", server.port) as c2:
            import time

            for _ in range(100):  # lock release lags the socket teardown
                if c2.start("p")[0] == Atom("ok"):
                    break
                time.sleep(0.02)
            assert c2.read(b"a") == (Atom("ok"), [b"x"])


def test_durable_store_survives_atom_and_container_terms(tmp_path):
    """Atom ids/elems/actors and container ids are BEAM-idiomatic; the
    durable log must reload them (the key encoding is plain data — a
    bridge class in an interner would be refused by the restricted
    manifest unpickler and brick the store)."""
    import time

    d = str(tmp_path / "stores")
    with BridgeServer(data_dir=d) as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            c.start("p")
            assert c.declare(Atom("myvar"), "lasp_orset", n_elems=8) == (
                Atom("ok"), Atom("myvar")
            )
            c.update(Atom("myvar"), (Atom("add"), Atom("elem_a")), Atom("w"))
            c.update(Atom("myvar"), (Atom("add"), [b"x", 1]), b"w")
            c.declare([1, 2], "lasp_gset", n_elems=4)
            c.update([1, 2], (Atom("add"), (b"t", 9)), b"w")
        with BridgeClient("127.0.0.1", server.port) as c2:
            for _ in range(100):
                if c2.start("p")[0] == Atom("ok"):
                    break
                time.sleep(0.02)
            ok, val = c2.read(Atom("myvar"))
            assert ok == Atom("ok")
            assert Atom("elem_a") in val and [b"x", 1] in val
            assert c2.read([1, 2]) == (Atom("ok"), [(b"t", 9)])


def test_orswot_bridge_round_trip_and_merge():
    """riak_dt_orswot over the wire: {VClock, Entries} portable form,
    get/put round-trip, and the no-tombstone remove-wins merge (a dot the
    peer's clock has seen but no longer carries stays removed)."""
    with BridgeServer() as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            c.start("v")
            c.declare(b"s", "riak_dt_orswot", n_elems=8, n_actors=4)
            c.update(b"s", (Atom("add"), b"x"), b"a1")
            c.update(b"s", (Atom("add"), b"y"), b"a2")
            ok, (type_atom, portable) = c.get(b"s")
            assert ok == Atom("ok") and type_atom == Atom("riak_dt_orswot")
            clock, entries = portable
            assert (b"a1", 1) in clock and (b"a2", 1) in clock
            assert dict(entries)[b"x"] == [(b"a1", 1)]
            # blind put into a twin, value preserved
            assert c.put(b"s2", "riak_dt_orswot", portable,
                         n_elems=8, n_actors=4) == Atom("ok")
            ok, val = c.read(b"s2")
            assert set(val) == {b"x", b"y"}
            # peer state whose clock saw a1@1 but carries no dot for x:
            # binding it must NOT resurrect x... and y removed by peer
            peer = ([(b"a1", 1), (b"a2", 1)], [])
            ok, val = c.bind(b"s2", peer)
            assert ok == Atom("ok") and val == []
            # invalid dot (beyond own clock) is refused loudly
            bad = ([(b"a9", 1)], [(b"z", [(b"a9", 2)])])
            resp = c.put(b"s3", "riak_dt_orswot", bad, n_elems=4, n_actors=4)
            assert resp[0] == Atom("error")


def test_orswot_bridge_durable(tmp_path):
    import time

    d = str(tmp_path / "stores")
    with BridgeServer(data_dir=d) as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            c.start("p")
            c.declare(b"s", "riak_dt_orswot", n_elems=8, n_actors=4)
            c.update(b"s", (Atom("add"), b"x"), b"a1")
            c.update(b"s", (Atom("remove"), b"x"), b"a1")
            c.update(b"s", (Atom("add"), b"y"), b"a2")
        with BridgeClient("127.0.0.1", server.port) as c2:
            for _ in range(100):
                if c2.start("p")[0] == Atom("ok"):
                    break
                time.sleep(0.02)
            assert c2.read(b"s") == (Atom("ok"), [b"y"])


def test_rejected_state_consumes_no_interner_capacity():
    """A rejected bind/put must leave the live variable untouched — no
    ghost elems/actors interned (4 bad binds must not exhaust a 4-actor
    universe)."""
    with BridgeServer() as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            c.start("v")
            c.declare(b"s", "riak_dt_orswot", n_elems=4, n_actors=4)
            for i in range(6):  # > n_actors rejected states
                bad = ([(f"bad{i}".encode(), 1)],
                       [(b"z", [(f"bad{i}".encode(), 2)])])
                resp = c.bind(b"s", bad)
                assert resp[0] == Atom("error")
            # legitimate actors still fit
            for i in range(4):
                ok, _ = c.update(b"s", (Atom("add"), b"x"), f"a{i}".encode())
                assert ok == Atom("ok")
            # orset: bad token index must not intern the element
            c.declare(b"o", "lasp_orset", n_elems=2, n_actors=1,
                      tokens_per_actor=1)
            for i in range(4):
                resp = c.bind(b"o", [(f"g{i}".encode(), [(99, False)])])
                assert resp[0] == Atom("error")
            ok, _ = c.update(b"o", (Atom("add"), b"real"), b"w")
            assert ok == Atom("ok")
            assert c.read(b"o") == (Atom("ok"), [b"real"])


def test_map_bridge_declare_update_read_roundtrip():
    """riak_dt_map over the wire: fields schema in caps, {update, Key,
    InnerOp} ops, proplist value (riak_dt_map:value shape), get/put
    round-trip, remove field."""
    with BridgeServer() as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            c.start("v")
            fields = [
                (b"tags", Atom("lasp_gset"), {Atom("n_elems"): 4}),
                (b"hits", Atom("riak_dt_gcounter"), {}),
            ]
            resp = c.call((Atom("declare"), b"m", Atom("riak_dt_map"),
                           {Atom("fields"): fields, Atom("n_actors"): 4}))
            assert resp == (Atom("ok"), b"m")
            ok, val = c.update(b"m", (Atom("update"), b"tags",
                                      (Atom("add"), b"t1")), b"w0")
            assert ok == Atom("ok")
            ok, val = c.update(b"m", (Atom("update"), b"hits",
                                      (Atom("increment"), 3)), b"w1")
            assert ok == Atom("ok")
            assert val == [(b"hits", 3), (b"tags", [b"t1"])]
            # get/put round-trip into a twin
            ok, (type_atom, portable) = c.get(b"m")
            assert type_atom == Atom("riak_dt_map")
            resp = c.call((Atom("put"), b"m2",
                           (Atom("riak_dt_map"), portable,
                            {Atom("fields"): fields, Atom("n_actors"): 4})))
            assert resp == Atom("ok")
            assert c.read(b"m2") == (Atom("ok"),
                                     [(b"hits", 3), (b"tags", [b"t1"])])
            # remove a field: presence dropped, counter keeps counting
            ok, val = c.update(b"m", (Atom("remove"), b"tags"), b"w0")
            assert val == [(b"hits", 3)]
            # unknown field in a put is rejected, and consumes nothing
            bad = ([(b"w9", 1)], [(b"nope", [(b"w9", 1)], [])])
            resp = c.call((Atom("put"), b"m3",
                           (Atom("riak_dt_map"), bad,
                            {Atom("fields"): fields, Atom("n_actors"): 4})))
            assert resp[0] == Atom("error")


def test_server_survives_malformed_frame_fuzz():
    """Socket-level robustness: random garbage frames each get an error
    TERM back (never a dropped connection, never a hang), and the
    connection keeps serving real ops afterwards — the bridge faces an
    untrusted network."""
    import random
    import socket
    import struct

    rng = random.Random(42)
    with BridgeServer() as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            c.start("fuzz")
            c.declare(b"c", "riak_dt_gcounter", n_actors=4)
            from lasp_tpu_torch.bridge import etf
            from lasp_tpu_torch.bridge.server import _recv_frame

            sock = c._sock
            for i in range(200):
                n = rng.randrange(0, 64)
                payload = bytes(rng.randrange(256) for _ in range(n))
                if rng.random() < 0.3:  # valid version byte, garbage body
                    payload = b"\x83" + payload
                sock.sendall(struct.pack(">I", len(payload)) + payload)
                body = _recv_frame(sock)  # the REAL framing reader
                assert body is not None, f"server closed on fuzz frame {i}"
                resp = etf.decode(body)
                assert isinstance(resp, tuple) and resp[0] == Atom("error"), (
                    i, resp,
                )
            # the connection still serves real traffic
            ok, total = c.update(b"c", (Atom("increment"), 7), b"w")
            assert ok == Atom("ok") and total == 7


def test_map_bridge_reset_mode_epochs_roundtrip():
    """reset_on_readd maps over the wire: caps flag parsed, remove-then-
    re-add resets contents, and the portable state carries the epoch
    component — whose presence must match the target's mode."""
    with BridgeServer() as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            c.start("v")
            fields = [(b"tags", Atom("lasp_gset"), {Atom("n_elems"): 4}),
                      (b"hits", Atom("riak_dt_gcounter"), {})]
            caps = {Atom("fields"): fields, Atom("n_actors"): 4,
                    Atom("reset_on_readd"): Atom("true")}
            resp = c.call((Atom("declare"), b"m", Atom("riak_dt_map"), caps))
            assert resp == (Atom("ok"), b"m")
            c.update(b"m", (Atom("update"), b"tags", (Atom("add"), b"t1")), b"w")
            c.update(b"m", (Atom("update"), b"hits",
                            (Atom("increment"), 5)), b"w")
            c.update(b"m", (Atom("remove"), b"tags"), b"w")
            c.update(b"m", (Atom("remove"), b"hits"), b"w")
            ok, val = c.update(b"m", (Atom("update"), b"tags",
                                      (Atom("add"), b"t2")), b"w")
            ok, val = c.update(b"m", (Atom("update"), b"hits",
                                      (Atom("increment"), 2)), b"w")
            assert ok == Atom("ok")
            # t1 reset away (epoch gate); the counter counts 2 past its
            # observed-floor of 5
            assert val == [(b"hits", 2), (b"tags", [b"t2"])]
            ok, (type_atom, portable) = c.get(b"m")
            assert len(portable) == 4  # (clock, fields, epochs, tombs)
            assert sorted(portable[2]) == [(b"hits", 1), (b"tags", 1)]
            # the counter's reset-remove floor rides the wire (gset
            # resets are epoch-gated and carry no baseline): the
            # receiver must never resurrect the 5 observed increments
            assert portable[3] == [(b"hits", [(b"w", 5)])]
            # round-trip into a twin of the same mode
            resp = c.call((Atom("put"), b"m2",
                           (Atom("riak_dt_map"), portable, caps)))
            assert resp == Atom("ok")
            assert c.read(b"m2") == (Atom("ok"),
                                     [(b"hits", 2), (b"tags", [b"t2"])])
            # a floor-LESS epoch-bearing state (pre-round-5 wire shape)
            # is rejected outright: importing it could resurrect resets
            resp = c.call((Atom("put"), b"m2b",
                           (Atom("riak_dt_map"),
                            (portable[0], portable[1], portable[2]), caps)))
            assert resp[0] == Atom("error")
            # a NON-reset twin must refuse the epoch-bearing state
            caps_plain = {Atom("fields"): fields, Atom("n_actors"): 4}
            resp = c.call((Atom("put"), b"m3",
                           (Atom("riak_dt_map"), portable, caps_plain)))
            assert resp[0] == Atom("error")
            # ... and a reset twin must refuse an epoch-LESS state (it can
            # only come from a plain-mode source)
            resp = c.call((Atom("put"), b"m4",
                           (Atom("riak_dt_map"),
                            (portable[0], portable[1]), caps)))
            assert resp[0] == Atom("error")
            # a malformed flag value is rejected at declare, not coerced
            bad_caps = {Atom("fields"): fields, Atom("n_actors"): 4,
                        Atom("reset_on_readd"): 1}
            resp = c.call((Atom("declare"), b"m5", Atom("riak_dt_map"),
                           bad_caps))
            assert resp[0] == Atom("error")


def test_map_bridge_durable(tmp_path):
    import time

    d = str(tmp_path / "stores")
    fields = [(b"tags", Atom("lasp_gset"), {Atom("n_elems"): 4}),
              (b"hits", Atom("riak_dt_gcounter"), {})]
    with BridgeServer(data_dir=d) as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            c.start("p")
            c.call((Atom("declare"), b"m", Atom("riak_dt_map"),
                    {Atom("fields"): fields, Atom("n_actors"): 4}))
            c.update(b"m", (Atom("update"), b"tags", (Atom("add"), b"t")), b"w")
            c.update(b"m", (Atom("update"), b"hits", (Atom("increment"),)), b"w")
        with BridgeClient("127.0.0.1", server.port) as c2:
            for _ in range(100):
                if c2.start("p")[0] == Atom("ok"):
                    break
                time.sleep(0.02)
            assert c2.read(b"m") == (Atom("ok"),
                                     [(b"hits", 1), (b"tags", [b"t"])])


def test_map_bridge_batched_op_and_bare_atom_inner():
    """The reference's batched map op {update, [SubOps]} and bare-atom
    inner ops ({update, Key, increment}) work over the wire."""
    with BridgeServer() as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            c.start("v")
            fields = [(b"tags", Atom("lasp_gset"), {Atom("n_elems"): 4}),
                      (b"hits", Atom("riak_dt_gcounter"), {})]
            c.call((Atom("declare"), b"m", Atom("riak_dt_map"),
                    {Atom("fields"): fields, Atom("n_actors"): 4}))
            ok, val = c.update(
                b"m",
                (Atom("update"), [
                    (Atom("update"), b"tags", (Atom("add"), b"t1")),
                    (Atom("update"), b"hits", Atom("increment")),
                ]),
                b"w0",
            )
            assert ok == Atom("ok"), val
            assert val == [(b"hits", 1), (b"tags", [b"t1"])]
            ok, val = c.update(b"m", (Atom("update"), b"hits",
                                      Atom("increment")), b"w1")
            assert ok == Atom("ok") and (b"hits", 2) in val


def test_oversized_state_rejected_before_any_interning():
    """A structurally-valid state naming more actors/elems than the
    declared universes is refused up front — nothing interned."""
    with BridgeServer() as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            c.start("v")
            c.declare(b"s", "riak_dt_orswot", n_elems=4, n_actors=2)
            big = ([(f"a{i}".encode(), 1) for i in range(5)], [])
            resp = c.bind(b"s", big)
            assert resp[0] == Atom("error")
            assert b"rejected before interning" in resp[2]
            # both declared actor slots still usable
            for i in range(2):
                ok, _ = c.update(b"s", (Atom("add"), b"x"), f"w{i}".encode())
                assert ok == Atom("ok")
            # gset elem overflow too
            c.declare(b"g", "lasp_gset", n_elems=2)
            resp = c.bind(b"g", [b"e1", b"e2", b"e3"])
            assert resp[0] == Atom("error")
            ok, _ = c.update(b"g", (Atom("add"), b"fine"), b"w")
            assert ok == Atom("ok")


def test_durable_bridge_concurrent_clients_stress(tmp_path):
    """Several clients hammering DIFFERENT durable stores concurrently:
    the name-lock registry and per-connection host logs must not cross
    wires; a contended name serializes via {error, locked}."""
    import threading

    d = str(tmp_path / "stores")
    errors: list = []

    def worker(port, name, n_ops):
        try:
            with BridgeClient("127.0.0.1", port) as c:
                assert c.start(name)[0] == Atom("ok")
                c.declare(b"s", "lasp_gset", n_elems=64)
                for i in range(n_ops):
                    ok, _ = c.update(b"s", (Atom("add"), f"{name}-{i}".encode()),
                                     b"w")
                    assert ok == Atom("ok")
        except Exception as e:  # surfaced after join
            errors.append((name, repr(e)))

    with BridgeServer(data_dir=d) as server:
        threads = [
            threading.Thread(target=worker, args=(server.port, f"p{k}", 50))
            for k in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        # every store durably holds exactly its own writes
        for k in range(4):
            with BridgeClient("127.0.0.1", server.port) as c:
                import time

                for _ in range(100):
                    if c.start(f"p{k}")[0] == Atom("ok"):
                        break
                    time.sleep(0.02)
                ok, val = c.read(b"s")
                assert ok == Atom("ok") and len(val) == 50
                assert all(v.startswith(f"p{k}-".encode()) for v in val)


def test_map_bridge_dynamic_field_admission():
    """The reference's exact wire flow (riak_test/lasp_kvs_replica_test.erl:
    57-135): declare riak_dt_map with NO schema, update a {Name, Type}
    tuple key never declared anywhere. The tagged key encoding
    (("tuple", ("atom", Name), ("atom", Type)) after _to_key) must
    self-describe its embedded type and admit on first update — and on
    state import (put/bind with fields this node has never seen)."""
    with BridgeServer() as server:
        with BridgeClient("127.0.0.1", server.port) as c:
            c.start("v")
            resp = c.declare(b"m", "riak_dt_map")  # schemaless
            assert resp == (Atom("ok"), b"m")
            key = (Atom("X"), Atom("lasp_orset"))
            ok, val = c.update(
                b"m", (Atom("update"), key, (Atom("add"), b"Chris")), b"w0"
            )
            assert ok == Atom("ok")
            assert val == [(key, [b"Chris"])]
            # a second dynamic field through the batched op shape
            ckey = (Atom("hits"), Atom("riak_dt_gcounter"))
            ok, val = c.update(
                b"m",
                (Atom("update"), [(Atom("update"), ckey, (Atom("increment"), 2))]),
                b"w1",
            )
            assert ok == Atom("ok")
            assert dict(val) == {key: [b"Chris"], ckey: 2}
            # remove of a never-admitted {Name, Type} key: precondition
            # error (riak_dt_map not_present), NOT silent admission
            resp = c.update(
                b"m", (Atom("remove"), (Atom("Z"), Atom("lasp_orset"))), b"w0"
            )
            assert resp[0] == Atom("error")
            # portable-state import admits unknown self-describing fields:
            # put m's state into a twin declared with NO fields at all
            ok, (type_atom, portable) = c.get(b"m")
            assert type_atom == Atom("riak_dt_map")
            resp = c.put(b"m2", "riak_dt_map", portable)
            assert resp == Atom("ok")
            assert dict(c.read(b"m2")[1]) == {key: [b"Chris"], ckey: 2}
            # a non-self-describing unknown field still rejects, with
            # nothing admitted (the twin keeps serving)
            bad = ([(b"w9", 1)], [(b"nope", [(b"w9", 1)], [])])
            resp = c.put(b"m3", "riak_dt_map", bad)
            assert resp[0] == Atom("error")
            ok, _ = c.update(
                b"m2", (Atom("update"), ckey, (Atom("increment"),)), b"w1"
            )
            assert ok == Atom("ok")
