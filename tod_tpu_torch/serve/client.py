"""Blocking TCP client for the path protocol, the robot controller's side
(counterpart of the JAX package's ``serve/client.py``; the wire protocol is
``serve/server.py``'s).

The client owns the robot side's failure handling: connect retries with
capped exponential backoff, and reconnect-and-retry when a request meets a
dead connection, so that a controller polling mid-match rides out a restart
of the vision process.  An auth rejection is never retried.
"""

from __future__ import annotations

import socket
import time

from tod_tpu_torch.core.types import Path


class AuthError(ConnectionError):
    """Auth handshake deterministically rejected (wrong/missing token).

    Distinct from transient transport errors so the retry machinery does
    NOT spin reconnect cycles against a misconfiguration — each rejected
    attempt would also inflate the server's ``unauthorized`` counter."""


class PathClient:
    """One path-protocol connection.

    ``retries``/``backoff`` control recovery: the initial connect is attempted
    ``1 + retries`` times with exponential backoff (``backoff``, 2x per try,
    capped at 2 s), and each request that fails with a connection error is
    retried on a fresh connection up to ``retries`` times.  ``retries=0``
    (default) keeps the old fail-fast behavior.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8080,
        timeout: float = 5.0,
        retries: int = 0,
        backoff: float = 0.1,
        auth_token: str | None = None,
        tls_ca: str | None = None,
        tls_client_cert: str | None = None,
        tls_client_key: str | None = None,
    ):
        """Hardening knobs mirror ServerConfig: ``auth_token`` performs the
        ``AuthTok`` handshake right after every (re)connect; ``tls_ca``
        switches the connection to TLS and verifies the server against that
        CA bundle (pass the server's own cert for self-signed deployments);
        ``tls_client_cert``/``tls_client_key`` present a client certificate
        for mutual TLS."""
        self.host, self.port, self.timeout = host, port, timeout
        self.retries, self.backoff = retries, backoff
        self.auth_token = auth_token
        self._ssl = None
        if tls_ca:
            import ssl

            ctx = ssl.create_default_context(cafile=tls_ca)
            # deployments address the vision host by IP; the CA pin is the
            # identity check here, not the DNS name
            ctx.check_hostname = False
            if tls_client_cert:
                ctx.load_cert_chain(tls_client_cert, tls_client_key)
            self._ssl = ctx
        self.sock: socket.socket | None = None
        self._connect()

    # --- connection management -------------------------------------------
    def _connect(self) -> None:
        delay = self.backoff
        for attempt in range(self.retries + 1):
            try:
                self.sock = socket.create_connection(
                    (self.host, self.port), timeout=self.timeout
                )
                if self._ssl is not None:
                    self.sock = self._ssl.wrap_socket(
                        self.sock, server_hostname=self.host
                    )
                if self.auth_token is not None:
                    self.sock.sendall(
                        b"AuthTok"
                        + len(self.auth_token.encode()).to_bytes(4, "big")
                        + self.auth_token.encode()
                    )
                    try:
                        ok = self._read_exactly(2)
                    except ConnectionError as e:
                        # the server replies OK or severs the connection
                        # (server.py drops on bad tokens without a reply), so
                        # a close during the handshake reply IS the rejection
                        raise AuthError(
                            "auth handshake rejected (connection closed)"
                        ) from e
                    if ok != b"OK":
                        raise AuthError("auth handshake rejected")
                return
            except AuthError:
                self.close()
                raise  # deterministic misconfiguration — never retried
            except OSError:
                self.close()
                if attempt == self.retries:
                    raise
                time.sleep(delay)
                delay = min(delay * 2, 2.0)

    def _reconnect(self) -> None:
        self.close()
        self._connect()

    def _request(self, op):
        """Run ``op()``; on a connection error, reconnect and retry."""
        delay = self.backoff
        for attempt in range(self.retries + 1):
            try:
                return op()
            except (ConnectionError, TimeoutError, OSError):
                if attempt == self.retries:
                    raise
                time.sleep(delay)
                delay = min(delay * 2, 2.0)
                self._reconnect()
        raise AssertionError("unreachable")

    # --- protocol ---------------------------------------------------------
    def new_path(self) -> bool:
        """Send NewPath; returns True on the b"OK" ack."""

        def op() -> bool:
            self.sock.sendall(b"NewPath")
            return self._read_exactly(2) == b"OK"

        return self._request(op)

    def get_path(self) -> Path:
        """Send GetPath; reads the full serialized Path.

        The wire format has no length prefix (src/path.rs:17-21) — the reply is
        8 bytes of timestamp plus 8 bytes per direction; we read until the
        server would block, relying on each reply being written in one piece.
        """

        def op() -> Path:
            self.sock.sendall(b"GetPath")
            data = self._read_exactly(8)
            self.sock.settimeout(0.2)
            try:
                while True:
                    chunk = self.sock.recv(65536)
                    if not chunk:
                        break
                    data += chunk
            except TimeoutError:
                pass
            finally:
                self.sock.settimeout(self.timeout)
            try:
                return Path.deserialize(data)
            except ValueError as e:
                # a stall >0.2 s mid-payload truncates the unframed reply —
                # that is a transport fault, so surface it to the retry
                # machinery instead of crashing past it.  (A truncation
                # landing exactly on an 8-byte boundary is undetectable in
                # this format — use get_path_v2's length-prefixed framing on
                # lossy links.)
                raise ConnectionError(f"truncated/malformed GetPath reply: {e}") from e

        return self._request(op)

    def get_path_v2(self) -> Path:
        """Length-prefixed variant (server extension ``GetPth2``): exact
        framing, no read-timeout heuristics."""

        def op() -> Path:
            self.sock.sendall(b"GetPth2")
            n = int.from_bytes(self._read_exactly(4), "big")
            return Path.deserialize(self._read_exactly(n))

        return self._request(op)

    def get_path_stream(self, stream: int) -> Path:
        """Multi-stream extension (``GetPthN``): the path for one camera
        stream (runtime/multistream.py), length-prefixed framing."""

        def op() -> Path:
            self.sock.sendall(b"GetPthN" + int(stream).to_bytes(4, "big"))
            n = int.from_bytes(self._read_exactly(4), "big")
            return Path.deserialize(self._read_exactly(n))

        return self._request(op)

    def new_path_stream(self, stream: int) -> bool:
        """Multi-stream extension (``NewPthN``): reset one stream's path."""

        def op() -> bool:
            self.sock.sendall(b"NewPthN" + int(stream).to_bytes(4, "big"))
            return self._read_exactly(2) == b"OK"

        return self._request(op)

    def get_stats(self) -> dict:
        """Observability extension (``GetStat``): length-prefixed JSON of
        server counters, path staleness, and live pipeline metrics."""

        def op() -> dict:
            import json

            self.sock.sendall(b"GetStat")
            n = int.from_bytes(self._read_exactly(4), "big")
            return json.loads(self._read_exactly(n))

        return self._request(op)

    def _read_exactly(self, n: int) -> bytes:
        data = b""
        while len(data) < n:
            chunk = self.sock.recv(n - len(data))
            if not chunk:
                raise ConnectionError("short read")
            data += chunk
        return data

    def close(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
