"""The port's path server against the JAX package's on the same bytes: the
``AuthTok`` handshake with auth off (a no-op ``OK``) and on, its length
bound and quiet drops, the ``GetPthN``/``NewPthN`` commands without
per-stream stores and with them (in range and out of range), the
``GetStat`` counter keys and ``streams`` list, and TLS and mutual TLS with
certificates made by ``cryptography``."""

from __future__ import annotations

import datetime
import json
import socket
import ssl
import struct

import pytest
import torch

from tod_tpu.core.config import ServerConfig as JaxServerConfig
from tod_tpu.core.types import Path as JaxPath
from tod_tpu.serve import server as jax_server
from tod_tpu_torch.core.config import ServerConfig
from tod_tpu_torch.core.types import Path
from tod_tpu_torch.serve import server as port_server

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

CREATED = 1700000013.0
DIRECTIONS = [(2.0, 0.5), (1.25, -0.75)]
TOKEN = b"s3cret"


def auth(token: bytes = TOKEN, n: int | None = None) -> bytes:
    return b"AuthTok" + (len(token) if n is None else n).to_bytes(4, "big") + token


# each session: the bytes one client sends before it closes its write side
SESSIONS = {
    "handshake then commands": auth() + b"GetPath" + b"GetPth2" + b"NewPath",
    "empty token": auth(b"") + b"GetPath",
    "GetPthN without stores": b"GetPthN" + (0).to_bytes(4, "big") + b"GetPath",
    "NewPthN without stores": b"NewPthN" + (2).to_bytes(4, "big"),
    "GetPthN short index": b"GetPthN" + b"\x00\x00",
    "length over the bound": b"AuthTok" + (1025).to_bytes(4, "big") + b"x" * 16,
    "length at the bound": auth(b"t" * 1024) + b"GetPath",
    "vanished after the command": b"AuthTok",
    "vanished mid-length": b"AuthTok\x00\x00",
    "vanished mid-token": b"AuthTok" + (10).to_bytes(4, "big") + b"abc",
    "wrong token": auth(b"wrong") + b"GetPath",
    "command before the handshake": b"GetPath" + auth(),
    "unknown command": b"Bogus!!" + b"GetPath",
}


def stream_path(kind, i: int):
    """Stream i's path: i + 1 directions, stamped CREATED + i."""
    return kind(CREATED + i, [(1.0 + i, 0.25 * k) for k in range(i + 1)])


class Pair:
    """The JAX server and the port's, each on its own thread and port, each
    with a store holding the same path, and with ``streams`` per-stream
    stores holding the same per-stream paths."""

    def __init__(self, streams: int | None = None, **cfg):
        self.stores = {"jax": jax_server.PathStore(), "port": port_server.PathStore()}
        self.paths = {"jax": JaxPath(CREATED, list(DIRECTIONS)),
                      "port": Path(CREATED, list(DIRECTIONS))}
        self.n_streams = streams
        self.stream_stores = {"jax": None, "port": None}
        self.threads, self.servers = {}, {}
        for name, mod, config, kind in (("jax", jax_server, JaxServerConfig, JaxPath),
                                        ("port", port_server, ServerConfig, Path)):
            if streams is not None:
                self.stream_stores[name] = [mod.PathStore() for _ in range(streams)]
            self.reset(name)
            self.threads[name], self.servers[name] = mod.run_in_thread(
                self.stores[name], config(port=0, **cfg),
                stream_stores=self.stream_stores[name])

    def reset(self, name: str) -> None:
        self.stores[name].set(self.paths[name])
        kind = JaxPath if name == "jax" else Path
        for i, store in enumerate(self.stream_stores[name] or ()):
            store.set(stream_path(kind, i))

    def close(self) -> None:
        for name, mod in (("jax", jax_server), ("port", port_server)):
            mod.stop_thread_server(self.servers[name])
            self.threads[name].join(timeout=10)
            assert not self.threads[name].is_alive()


def exchange(port: int, data: bytes, wrap=None) -> bytes:
    """Send ``data``, close the write side, read the replies to EOF."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as raw:
        sock = wrap(raw) if wrap else raw
        sock.sendall(data)
        if wrap is None:
            sock.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            try:
                chunk = sock.recv(65536)
            except (ConnectionResetError, ssl.SSLError, TimeoutError):
                break
            if not chunk:
                break
            out += chunk
            if wrap is not None and len(out) >= 2 + 8 + 8 * len(DIRECTIONS):
                break  # a TLS client reads its replies, then closes
        return out


def getstat(port: int, prefix: bytes = b"") -> dict:
    reply = exchange(port, prefix + b"GetStat")
    if prefix:
        assert reply[:2] == b"OK"
        reply = reply[2:]
    n = int.from_bytes(reply[:4], "big")
    assert len(reply) == 4 + n
    return json.loads(reply[4:])


@pytest.fixture(scope="module")
def no_auth():
    pair = Pair()
    yield pair
    pair.close()


@pytest.fixture(scope="module")
def with_auth():
    pair = Pair(auth_token=TOKEN.decode())
    yield pair
    pair.close()


def index(i: int) -> bytes:
    return i.to_bytes(4, "big")


# each session: the bytes one client sends to servers with 3 stream stores
STREAM_SESSIONS = {
    "GetPthN each stream": b"GetPthN" + index(0) + b"GetPthN" + index(1) + b"GetPthN" + index(2),
    "NewPthN then another stream": b"NewPthN" + index(1) + b"GetPthN" + index(2),
    "pipelined with the single-store commands":
        b"GetPath" + b"GetPthN" + index(2) + b"GetPth2" + b"NewPthN" + index(0),
    "GetPthN out of range": b"GetPthN" + index(3) + b"GetPath",
    "NewPthN out of range": b"NewPthN" + index(9) + b"GetPath",
    "GetPthN largest index": b"GetPthN" + index(2**32 - 1),
    "GetPthN short index": b"GetPthN" + b"\x00",
    "in range after the handshake": auth() + b"GetPthN" + index(1),
}


def run_sessions(pair: Pair, sessions=SESSIONS) -> dict[str, dict[str, bytes]]:
    replies: dict[str, dict[str, bytes]] = {}
    for session, data in sessions.items():
        for name in ("jax", "port"):
            pair.reset(name)
            replies.setdefault(session, {})[name] = exchange(pair.servers[name].port, data)
    return replies


@pytest.mark.parametrize("mode", ["auth off", "auth on"])
def test_same_bytes_same_replies_and_counters(mode, no_auth, with_auth):
    pair = no_auth if mode == "auth off" else with_auth
    before = {name: dict(s.counters) for name, s in pair.servers.items()}
    replies = run_sessions(pair)
    for session, got in replies.items():
        assert got["port"] == got["jax"], session
    counts = {name: {k: v - before[name][k] for k, v in s.counters.items()}
              for name, s in pair.servers.items()}
    assert counts["port"] == counts["jax"]
    path = Path(CREATED, DIRECTIONS).serialize()
    handshake = replies["handshake then commands"]["port"]
    assert handshake == b"OK" + path + len(path).to_bytes(4, "big") + path + b"OK"
    assert replies["length over the bound"]["port"] == b""
    assert replies["vanished mid-token"]["port"] == b""
    assert replies["GetPthN without stores"]["port"] == b""
    if mode == "auth off":
        # a client set up with a token works against a server without one
        assert replies["wrong token"]["port"] == b"OK" + path
        assert replies["command before the handshake"]["port"] == path + b"OK"
        assert counts["port"]["unauthorized"] == 1  # the over-long length
    else:
        assert replies["wrong token"]["port"] == b""
        assert replies["command before the handshake"]["port"] == b""
        assert replies["GetPthN without stores"]["port"] == b""
        assert counts["port"]["unauthorized"] == 9  # every session but the first and the vanished
    assert counts["port"]["AuthTok"] == 9 - (0 if mode == "auth off" else 1)


@pytest.mark.parametrize("mode", ["auth off", "auth on"])
def test_getstat_counter_keys_and_values_match(mode, no_auth, with_auth):
    pair = no_auth if mode == "auth off" else with_auth
    prefix = b"" if mode == "auth off" else auth()
    stats = {name: getstat(s.port, prefix) for name, s in pair.servers.items()}
    assert set(stats["port"]) == set(stats["jax"])
    assert stats["port"]["requests"] == stats["jax"]["requests"]
    assert set(stats["port"]["requests"]) == {
        "NewPath", "GetPath", "GetPth2", "GetStat", "GetPthN", "NewPthN", "AuthTok",
        "unauthorized", "errors"}


def test_bad_token_then_good_connection(with_auth):
    port = with_auth.servers["port"]
    with_auth.reset("port")
    before = port.counters["unauthorized"]
    assert exchange(port.port, auth(b"nope") + b"GetPath") == b""
    assert port.counters["unauthorized"] == before + 1
    reply = exchange(port.port, auth() + b"GetPath")
    assert reply[:2] == b"OK"
    assert Path.deserialize(reply[2:]).directions == DIRECTIONS


def make_cert(tmp_path, cn: str):
    """A self-signed certificate and its key, as ``tests/test_serve.py``
    makes them."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=1))
        .add_extension(x509.SubjectAlternativeName([x509.DNSName("localhost")]),
                       critical=False)
        .add_extension(x509.BasicConstraints(ca=True, path_length=None), critical=True)
        .sign(key, hashes.SHA256())
    )
    cert_p, key_p = tmp_path / f"{cn}.pem", tmp_path / f"{cn}.key"
    cert_p.write_bytes(cert.public_bytes(serialization.Encoding.PEM))
    key_p.write_bytes(key.private_bytes(serialization.Encoding.PEM,
                                        serialization.PrivateFormat.TraditionalOpenSSL,
                                        serialization.NoEncryption()))
    return str(cert_p), str(key_p)


def tls_client(ca: str, cert: str | None = None, key: str | None = None):
    ctx = ssl.create_default_context(cafile=ca)
    if cert:
        ctx.load_cert_chain(cert, key)
    return lambda sock: ctx.wrap_socket(sock, server_hostname="localhost")


def serve_port(**cfg):
    store = port_server.PathStore()
    store.set(Path(CREATED, list(DIRECTIONS)))
    return port_server.run_in_thread(store, ServerConfig(port=0, **cfg))


def test_tls_round_trip_and_plaintext_refused(tmp_path):
    cert, key = make_cert(tmp_path, "server")
    thread, server = serve_port(tls_cert=cert, tls_key=key, auth_token="tok")
    try:
        reply = exchange(server.port, auth(b"tok") + b"GetPath", wrap=tls_client(cert))
        assert reply[:2] == b"OK"
        assert Path.deserialize(reply[2:]).directions == DIRECTIONS
        plain = exchange(server.port, b"GetPath")
        assert plain[:8] != struct.pack(">Q", int(CREATED))  # never a path in the clear
        assert server.counters["AuthTok"] == 1 and server.counters["GetPath"] == 1
    finally:
        port_server.stop_thread_server(server)
        thread.join(timeout=10)


def test_mutual_tls_requires_a_client_certificate(tmp_path):
    cert, key = make_cert(tmp_path, "server")
    client_cert, client_key = make_cert(tmp_path, "client")
    stranger_cert, stranger_key = make_cert(tmp_path, "stranger")
    thread, server = serve_port(tls_cert=cert, tls_key=key, tls_client_ca=client_cert)
    try:
        reply = exchange(server.port, b"GetPath",
                         wrap=tls_client(cert, client_cert, client_key))
        assert Path.deserialize(reply).directions == DIRECTIONS
        for wrap in (tls_client(cert), tls_client(cert, stranger_cert, stranger_key)):
            try:
                got = exchange(server.port, b"GetPath", wrap=wrap)
            except (ssl.SSLError, ConnectionResetError, BrokenPipeError):
                got = b""
            assert got == b""
        assert server.counters["GetPath"] == 1
    finally:
        port_server.stop_thread_server(server)
        thread.join(timeout=10)


def test_ssl_context_only_with_a_certificate(tmp_path):
    cert, key = make_cert(tmp_path, "server")
    store = port_server.PathStore()
    assert port_server.PathServer(store, ServerConfig())._ssl_context() is None
    ctx = port_server.PathServer(store, ServerConfig(tls_cert=cert, tls_key=key,
                                                     tls_client_ca=cert))._ssl_context()
    assert ctx.verify_mode == ssl.CERT_REQUIRED


@pytest.fixture(scope="module")
def with_streams():
    pair = Pair(streams=3)
    yield pair
    pair.close()


def test_stream_stores_same_bytes_same_replies_and_counters(with_streams):
    """Both servers with 3 stream stores get the same sessions: the same
    replies and counter changes; each GetPthN answers its stream's path with
    GetPth2's framing, NewPthN resets only its stream, and an index out of
    range drops the connection as an error."""
    pair = with_streams
    before = {name: dict(s.counters) for name, s in pair.servers.items()}
    replies = run_sessions(pair, STREAM_SESSIONS)
    for session, got in replies.items():
        assert got["port"] == got["jax"], session
    counts = {name: {k: v - before[name][k] for k, v in s.counters.items()}
              for name, s in pair.servers.items()}
    assert counts["port"] == counts["jax"]
    framed = [len(p).to_bytes(4, "big") + p
              for p in (stream_path(Path, i).serialize() for i in range(3))]
    assert replies["GetPthN each stream"]["port"] == b"".join(framed)
    assert replies["NewPthN then another stream"]["port"] == b"OK" + framed[2]
    assert replies["in range after the handshake"]["port"] == b"OK" + framed[1]
    for session in ("GetPthN out of range", "NewPthN out of range", "GetPthN largest index",
                    "GetPthN short index"):
        assert replies[session]["port"] == b"", session
    assert counts["port"]["errors"] == 3 and counts["port"]["GetPthN"] == 6
    assert counts["port"]["NewPthN"] == 2
    # NewPthN reset that stream alone (the last session to touch stream 1)
    pair.reset("port")
    exchange(pair.servers["port"].port, b"NewPthN" + index(1))
    stores = pair.stream_stores["port"]
    assert stores[1].get().directions == [] and len(stores[2].get().directions) == 3
    assert pair.stores["port"].get().directions == DIRECTIONS


def test_getstat_lists_the_streams_as_jax_does(with_streams, no_auth):
    pair = with_streams
    for name in ("jax", "port"):
        pair.reset(name)
    stats = {name: getstat(s.port) for name, s in pair.servers.items()}
    assert set(stats["port"]) == set(stats["jax"]) and "streams" in stats["port"]
    for got, want in zip(stats["port"]["streams"], stats["jax"]["streams"]):
        assert set(got) == set(want) == {"path_age_s", "path_len", "path_truncated"}
        assert (got["path_len"], got["path_truncated"]) == (want["path_len"],
                                                            want["path_truncated"])
    assert [x["path_len"] for x in stats["port"]["streams"]] == [1, 2, 3]
    assert "streams" not in getstat(no_auth.servers["port"].port)
