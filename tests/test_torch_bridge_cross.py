"""The port's bridge against the JAX package's on one seeded request stream
(``bench_scenarios.bridge_stream``: the five kinds of ``ingest_storm``,
YCSB workload A's idem-wrapped updates and value reads, and 16-variable
``merge_batch`` frames):
the same frames through JAX's ``_Conn.handle`` and the port's must give
the same response bytes, in memory and durable; a durable ``data_dir``
written by either package's server reads back, byte for byte, through the
other's, its persisted idem window included."""

import os

import pytest
import torch

from lasp_tpu.bridge import etf as jetf
from lasp_tpu.bridge.server import BridgeServer as JServer
from lasp_tpu.bridge.server import _Conn as JConn
from lasp_tpu_torch.bench_scenarios import bridge_stream, run_bridge_stream
from lasp_tpu_torch.bridge import Atom, BridgeClient, BridgeServer
from lasp_tpu_torch.bridge import etf as tetf
from lasp_tpu_torch.bridge.server import _Conn as TConn

torch.set_num_threads(1)

STREAM = dict(n_requests=600, n_partitions=4, vars_per_partition=8, seed=3)


def _conns(data_dir=None):
    """One connection per partition of each package, sharing each
    package's lock and idem registries as a server's connections do."""
    jshared, tshared = ({}, {}), ({}, {})

    def jconn():
        return JConn(16, data_dir and os.path.join(data_dir, "jax"), *jshared)

    def tconn():
        return TConn(16, data_dir and os.path.join(data_dir, "torch"), *tshared,
                     device="cpu")

    return jconn, tconn


def _drive(conns: dict, make, stream, phase: str) -> list:
    out = []
    for name, term in stream[phase]:
        conn = conns.get(name)
        if conn is None:
            conn = conns[name] = make()
        out.append(_handle(conn, term))
    return out


def _handle(conn, term) -> bytes:
    """One request through a connection of either package, as wire bytes."""
    raw = tetf.encode(term)
    if isinstance(conn, JConn):
        return jetf.encode(conn.handle(jetf.decode(raw)))
    return tetf.encode(conn.handle(tetf.decode(raw)))


def _gets(conns: dict, stream) -> list:
    return [_handle(conns[name], (Atom("get"), vid)) for name, vid in stream["vars"]]


def _close(conns: dict) -> None:
    for c in conns.values():
        c.close()
    conns.clear()


@pytest.mark.parametrize("durable", [False, True], ids=["memory", "durable"])
def test_seeded_stream_gives_jax_bytes(durable, tmp_path):
    stream = bridge_stream(**STREAM)
    jconn, tconn = _conns(str(tmp_path) if durable else None)
    jc, tc = {}, {}
    for phase in ("setup", "requests"):
        want = _drive(jc, jconn, stream, phase)
        got = _drive(tc, tconn, stream, phase)
        for i, (a, b) in enumerate(zip(got, want)):
            assert a == b, (phase, i, stream[phase][i], tetf.decode(a),
                            jetf.decode(b))
            # every request of the stream is one the server accepts
            assert tetf.decode(a)[0] != tetf.ERROR, (phase, i, tetf.decode(a))
    # the stream exercises every path: merges, idem writes, value reads
    kinds = {str(t[0]) for _n, t in stream["requests"]}
    assert kinds == {"idem", "read", "merge_batch"}
    assert all(_handle(tc[n], (Atom("get"), v)) == _handle(jc[n], (Atom("get"), v))
               for n, v in stream["vars"])
    _close(jc)
    _close(tc)


def test_durable_restart_and_cross_package_reload(tmp_path):
    """Each package's durable stores reopen after a restart with every
    variable equal (no acked write lost), and each reads the other's."""
    stream = bridge_stream(**STREAM)
    jconn, tconn = _conns(str(tmp_path))
    jc, tc = {}, {}
    for phase in ("setup", "requests"):
        _drive(jc, jconn, stream, phase)
        _drive(tc, tconn, stream, phase)
    before = _gets(tc, stream)
    assert before == _gets(jc, stream)
    _close(jc)
    _close(tc)
    starts = {"setup": [st for st in stream["setup"] if str(st[1][0]) == "start"]}
    # restart: each package on its own directory
    jconn, tconn = _conns(str(tmp_path))
    _drive(jc, jconn, starts, "setup")
    _drive(tc, tconn, starts, "setup")
    assert _gets(tc, stream) == before == _gets(jc, stream)
    _close(jc)
    _close(tc)
    # cross: the port on JAX's files, JAX on the port's
    jd, td = os.path.join(str(tmp_path), "jax"), os.path.join(str(tmp_path), "torch")
    cross_t = {}
    cross_j = {}
    for name, term in starts["setup"]:
        cross_t[name] = TConn(16, jd, {}, {}, device="cpu")
        cross_j[name] = JConn(16, td, {}, {})
        assert _handle(cross_t[name], term) == _handle(cross_j[name], term)
    assert _gets(cross_t, stream) == before == _gets(cross_j, stream)
    _close(cross_t)
    _close(cross_j)


def test_idem_window_persisted_by_jax_dedups_in_the_port(tmp_path):
    """An update applied through JAX's durable server and replayed after a
    restart of the port's server on the same directory is answered from
    the persisted window, not applied twice — and the other way round."""
    for first, second in ((JServer, BridgeServer), (BridgeServer, JServer)):
        data = str(tmp_path / first.__module__.split(".")[0])
        frame = (Atom("idem"), os.urandom(16),
                 (Atom("update"), b"v", (Atom("increment"),), b"w"))

        def server(cls):
            return cls(port=0, data_dir=data, **(
                {"device": "cpu"} if cls is BridgeServer else {}))

        with server(first) as s1, BridgeClient("127.0.0.1", s1.port) as c:
            c.start("soak")
            c.declare(b"v", "riak_dt_gcounter")
            assert c.call(frame) == (Atom("ok"), 1)
        with server(second) as s2, BridgeClient("127.0.0.1", s2.port) as c:
            c.start("soak")
            assert c.call(frame) == (Atom("ok"), 1)
            assert c.read(b"v") == (Atom("ok"), 1)


def test_stream_over_loopback_equals_conn_bytes():
    """``run_bridge_stream`` (what chip_smoke.py's bridge phase runs) over
    a live port server gives the bytes JAX's connections give for the same
    stream."""
    stream = bridge_stream(n_requests=200, n_partitions=2, vars_per_partition=5,
                           seed=9)
    with BridgeServer(device="cpu") as server:
        got = run_bridge_stream(server.port, stream)
    jconn, _ = _conns()
    jc = {}
    _drive(jc, jconn, stream, "setup")
    assert got["responses"] == _drive(jc, jconn, stream, "requests")
    assert len(got["latency_s"]) == 200 and got["seconds"] > 0
