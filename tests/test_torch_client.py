"""The port's ``PathClient`` (``serve/client.py``) against the port's
server and the JAX package's ``PathServer``, and the JAX package's client
against the port's server: every request, auth (a rejection is not
retried), reconnecting after a server restart, TLS and mutual TLS, and the
multistream commands."""

from __future__ import annotations

import contextlib

import pytest
import torch

from test_torch_serve_auth import make_cert
from tod_tpu.core.config import ServerConfig as JaxServerConfig
from tod_tpu.core.types import Path as JaxPath
from tod_tpu.serve import server as jax_server
from tod_tpu.serve.client import AuthError as JaxAuthError
from tod_tpu.serve.client import PathClient as JaxPathClient
from tod_tpu_torch.core.config import ServerConfig
from tod_tpu_torch.core.types import Path
from tod_tpu_torch.serve import server as port_server
from tod_tpu_torch.serve.client import AuthError, PathClient

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

CREATED = 1700000021.0
DIRECTIONS = [(2.0, 0.5), (1.25, -0.75), (0.5, 3.0)]
SIDES = {"port": (port_server, ServerConfig, Path), "jax": (jax_server, JaxServerConfig, JaxPath)}


@contextlib.contextmanager
def serving(side: str = "port", streams: int | None = None, **cfg):
    """A server of ``side`` on a free port (or ``cfg['port']``), its store
    holding ``DIRECTIONS``; stream i's store holds i + 1 directions."""
    mod, config, kind = SIDES[side]
    store = mod.PathStore()
    store.set(kind(CREATED, list(DIRECTIONS)))
    stream_stores = None
    if streams is not None:
        stream_stores = [mod.PathStore() for _ in range(streams)]
        for i, s in enumerate(stream_stores):
            s.set(kind(CREATED + i, [(1.0 + i, 0.25 * k) for k in range(i + 1)]))
    cfg.setdefault("port", 0)
    thread, server = mod.run_in_thread(store, config(**cfg), stream_stores=stream_stores)
    try:
        yield server
    finally:
        mod.stop_thread_server(server)
        thread.join(timeout=10)
        assert not thread.is_alive()


@pytest.mark.parametrize("server_side,client_side", [("port", "port"), ("jax", "port"),
                                                     ("port", "jax")])
def test_every_request(server_side, client_side):
    client_cls = PathClient if client_side == "port" else JaxPathClient
    with serving(server_side) as srv, client_cls(port=srv.port) as c:
        got = c.get_path()
        assert got.directions == DIRECTIONS and got.created == CREATED
        if client_side == "port":
            assert type(got) is Path
        assert c.get_path_v2().directions == DIRECTIONS
        stats = c.get_stats()
        assert stats["requests"]["GetPath"] == 1 and stats["requests"]["GetPth2"] == 1
        assert stats["path_len"] == len(DIRECTIONS)
        assert c.new_path() is True
        assert c.get_path().directions == []
        assert c.get_path_v2().directions == []
    assert c.sock is None  # the context manager closed it


@pytest.mark.parametrize("server_side", ["port", "jax"])
def test_stream_commands(server_side):
    with serving(server_side, streams=3) as srv, PathClient(port=srv.port) as c:
        for i in range(3):
            p = c.get_path_stream(i)
            assert p.created == CREATED + i
            assert p.directions == [(1.0 + i, 0.25 * k) for k in range(i + 1)]
        assert c.new_path_stream(1) is True
        assert c.get_path_stream(1).directions == []
        assert c.get_path_stream(2).directions != []
        assert len(c.get_stats()["streams"]) == 3


@pytest.mark.parametrize("client_cls", [PathClient, JaxPathClient], ids=["port", "jax"])
def test_auth_token_and_rejection_without_retry(client_cls):
    error = AuthError if client_cls is PathClient else JaxAuthError
    with serving("port", auth_token="s3cret") as srv:
        with client_cls(port=srv.port, auth_token="s3cret") as c:
            assert c.get_path().directions == DIRECTIONS
        before = srv.counters["unauthorized"]
        with pytest.raises(error):
            client_cls(port=srv.port, auth_token="wrong", retries=3, backoff=0.01)
        assert srv.counters["unauthorized"] == before + 1  # one attempt, not four
        assert issubclass(error, ConnectionError)


def test_reconnects_after_a_server_restart():
    with serving("port") as srv:
        port = srv.port
        c = PathClient(port=port, retries=6, backoff=0.05, auth_token="t")
        assert c.get_path().directions == DIRECTIONS
    # the old connection is dead; a new server on the same port answers
    with serving("port", port=port, auth_token="t") as srv2:
        try:
            assert c.get_path_v2().directions == DIRECTIONS
            assert c.get_stats()["requests"]["AuthTok"] == 1  # sent again on reconnect
        finally:
            c.close()
        assert srv2.counters["GetPth2"] == 1


def test_connect_retries_then_fails_fast_without_retries():
    with serving("port") as srv:
        port = srv.port
    with pytest.raises(OSError):
        PathClient(port=port, retries=0)
    with pytest.raises(OSError):
        PathClient(port=port, retries=2, backoff=0.01)


def test_tls_and_mutual_tls(tmp_path):
    cert, key = make_cert(tmp_path, "server")
    with serving("port", tls_cert=cert, tls_key=key) as srv:
        with PathClient(port=srv.port, tls_ca=cert) as c:
            assert c.get_path().directions == DIRECTIONS
        with pytest.raises(OSError):
            PathClient(port=srv.port).get_path()  # plaintext against TLS
    ccert, ckey = make_cert(tmp_path, "client")
    with serving("port", tls_cert=cert, tls_key=key, tls_client_ca=ccert) as srv:
        with PathClient(port=srv.port, tls_ca=cert, tls_client_cert=ccert,
                        tls_client_key=ckey) as c:
            assert c.get_path_v2().directions == DIRECTIONS
        with pytest.raises(OSError):
            PathClient(port=srv.port, tls_ca=cert).get_path()  # no client certificate


def test_package_exports():
    import tod_tpu_torch
    from tod_tpu_torch import serve

    assert tod_tpu_torch.PathClient is PathClient and serve.PathClient is PathClient
    assert serve.AuthError is AuthError
    for name in ("Engine", "PathStore", "Path", "Frame", "Scene", "Detections",
                 "PipelineConfig", "ModelConfig", "GeometryConfig"):
        assert name in dir(tod_tpu_torch) and getattr(tod_tpu_torch, name) is not None
    with pytest.raises(AttributeError):
        tod_tpu_torch.NoSuchName  # noqa: B018


def test_import_is_cheap():
    """``import tod_tpu_torch`` imports neither torch nor a submodule."""
    import subprocess
    import sys

    code = ("import sys, tod_tpu_torch; "
            "print(sorted(m for m in sys.modules if m == 'torch' or m.startswith('tod_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    assert out.strip() == "['tod_tpu_torch']"
