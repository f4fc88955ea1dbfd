"""TCP path server: the byte-compatible NewPath/GetPath control plane
(counterpart of the JAX package's ``serve/server.py``).

Wire protocol:

- the client sends exactly 7 ASCII bytes: ``b"NewPath"`` or ``b"GetPath"``
- ``NewPath`` -> the stored path resets to empty (stamped now), reply ``b"OK"``
- ``GetPath`` -> the serialized path: 8-byte big-endian unix seconds, then two
  big-endian f32s per direction
- ``GetPth2`` -> the same payload prefixed with its u32 big-endian length
- ``GetStat`` -> length-prefixed JSON of counters, path staleness and, when
  the server was given a ``stats_fn``, the engine's live metrics under
  ``pipeline`` (fps, stage timers, restarts)
- ``AuthTok`` + u32 big-endian length (at most 1024) + token -> ``b"OK"``.
  With ``ServerConfig.auth_token`` set it must precede every other command,
  and a wrong token drops the connection; with auth off it is a no-op, so a
  client configured with a token works against a server without one
- ``GetPthN`` / ``NewPthN`` + u32 big-endian stream index -> the multistream
  commands, on the server's ``stream_stores`` (one a camera stream):
  ``GetPthN`` answers that stream's path with ``GetPth2``'s framing,
  ``NewPthN`` resets it and answers ``OK``.  Without stores, or for an index
  out of range, each is counted as an error and the connection dropped
- anything else -> logged, connection dropped

With ``ServerConfig.tls_cert`` the server speaks TLS, and with
``tls_client_ca`` it requires a client certificate signed by that CA.

Connections are served concurrently; commands may be pipelined.
"""

from __future__ import annotations

import asyncio
import hmac
import json
import logging
import threading
import time

from tod_tpu_torch.core.config import ServerConfig
from tod_tpu_torch.core.types import Path

log = logging.getLogger(__name__)


class PathStore:
    """Thread-safe holder of the current Path: the planner swaps paths in,
    the server reads them."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._path = Path(created=time.time(), directions=[])

    def get(self) -> Path:
        with self._lock:
            return self._path

    def set(self, path: Path) -> None:
        with self._lock:
            self._path = path

    def reset(self) -> Path:
        fresh = Path(created=time.time(), directions=[])
        self.set(fresh)
        return fresh


class PathServer:
    """``stats_fn`` (optional) returns live pipeline metrics, merged into the
    ``GetStat`` reply.  ``stream_stores`` (optional) are the multistream
    engine's per-stream stores, addressed by ``GetPthN``/``NewPthN`` and
    listed under ``streams`` in ``GetStat``; the single-store commands keep
    serving ``store`` (stream 0's, by convention)."""

    def __init__(self, store: PathStore, cfg: ServerConfig | None = None, stats_fn=None,
                 stream_stores: list[PathStore] | None = None) -> None:
        self.store = store
        self.stream_stores = stream_stores
        self.cfg = cfg or ServerConfig()
        self.stats_fn = stats_fn
        self._started = time.time()
        self.counters = {
            "NewPath": 0, "GetPath": 0, "GetPth2": 0, "GetStat": 0,
            "GetPthN": 0, "NewPthN": 0,
            "AuthTok": 0, "unauthorized": 0, "errors": 0,
        }
        self._server: asyncio.AbstractServer | None = None
        self._writers: set[asyncio.StreamWriter] = set()

    async def _reply(self, writer: asyncio.StreamWriter, payload: bytes) -> None:
        writer.write(payload)
        await writer.drain()

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        peer = writer.get_extra_info("peername")
        self._writers.add(writer)
        authed = self.cfg.auth_token is None  # auth off: every connection trusted
        try:
            while True:
                try:
                    buf = await reader.readexactly(7)
                except asyncio.IncompleteReadError:
                    return
                if buf == b"AuthTok":
                    self.counters["AuthTok"] += 1
                    try:
                        n = int.from_bytes(await reader.readexactly(4), "big")
                        if n > 1024:
                            self.counters["unauthorized"] += 1
                            log.error("AuthTok length %d exceeds bound; dropping %s", n, peer)
                            return
                        token = await reader.readexactly(n)
                    except asyncio.IncompleteReadError:
                        return  # the client vanished mid-handshake: drop quietly
                    if self.cfg.auth_token is None:
                        await self._reply(writer, b"OK")
                    elif hmac.compare_digest(token, self.cfg.auth_token.encode()):
                        authed = True
                        await self._reply(writer, b"OK")
                    else:
                        self.counters["unauthorized"] += 1
                        log.error("bad auth token from %s; dropping", peer)
                        return
                elif not authed:
                    self.counters["unauthorized"] += 1
                    log.error("unauthenticated %r from %s; dropping", buf, peer)
                    return
                elif buf in (b"GetPthN", b"NewPthN"):
                    cmd = buf.decode()
                    try:
                        idx = int.from_bytes(await reader.readexactly(4), "big")
                    except asyncio.IncompleteReadError:
                        return
                    stores = self.stream_stores
                    if stores is None or not 0 <= idx < len(stores):
                        self.counters["errors"] += 1
                        log.error("RequestError(%s stream %d of %s)", cmd, idx,
                                  "none" if stores is None else len(stores))
                        return
                    self.counters[cmd] += 1
                    if cmd == "NewPthN":
                        stores[idx].reset()
                        await self._reply(writer, b"OK")
                    else:
                        payload = stores[idx].get().serialize()
                        await self._reply(writer, len(payload).to_bytes(4, "big") + payload)
                elif buf == b"NewPath":
                    self.counters["NewPath"] += 1
                    self.store.reset()
                    await self._reply(writer, b"OK")
                elif buf == b"GetPath":
                    self.counters["GetPath"] += 1
                    await self._reply(writer, self.store.get().serialize())
                elif buf in (b"GetPth2", b"GetStat"):
                    cmd = buf.decode()
                    self.counters[cmd] += 1
                    if cmd == "GetPth2":
                        payload = self.store.get().serialize()
                    else:
                        payload = json.dumps(self.stats()).encode()
                    await self._reply(writer, len(payload).to_bytes(4, "big") + payload)
                else:
                    self.counters["errors"] += 1
                    log.error("RequestError(%r is not a request) from %s", buf, peer)
                    return
        except (ConnectionResetError, BrokenPipeError) as e:
            log.error("failed to read/write socket; err = %r", e)
        finally:
            self._writers.discard(writer)
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    def stats(self) -> dict:
        path = self.store.get()
        out = {
            "uptime_s": time.time() - self._started,
            "requests": dict(self.counters),
            "path_age_s": time.time() - path.created,
            "path_len": len(path.directions),
            "path_truncated": bool(path.truncated),
        }
        if self.stream_stores is not None:
            out["streams"] = [
                {"path_age_s": time.time() - p.created, "path_len": len(p.directions),
                 "path_truncated": bool(p.truncated)}
                for p in (s.get() for s in self.stream_stores)
            ]
        if self.stats_fn is not None:
            try:
                out["pipeline"] = self.stats_fn()
            except Exception as e:  # metrics must never take the server down
                out["pipeline_error"] = repr(e)
        return out

    def _ssl_context(self):
        """Server-side SSLContext from the config, or None (plaintext)."""
        if not self.cfg.tls_cert:
            return None
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.cfg.tls_cert, self.cfg.tls_key)
        if self.cfg.tls_client_ca:
            ctx.verify_mode = ssl.CERT_REQUIRED  # mutual TLS
            ctx.load_verify_locations(self.cfg.tls_client_ca)
        return ctx

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.cfg.host, self.cfg.port, ssl=self._ssl_context()
        )

    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("server not started")
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for w in list(self._writers):
                w.close()
            await self._server.wait_closed()
            self._server = None


def run_in_thread(store: PathStore, cfg: ServerConfig | None = None, stats_fn=None,
                  stream_stores: list[PathStore] | None = None):
    """Start the server on a daemon thread with its own event loop; returns
    ``(thread, server)`` or raises if it fails to start within 10 s."""
    server = PathServer(store, cfg, stats_fn=stats_fn, stream_stores=stream_stores)
    ready = threading.Event()
    holder: dict = {}

    def _run():
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        holder["loop"] = loop
        try:
            loop.run_until_complete(server.start())
        except BaseException as e:  # handed to the caller below
            holder["error"] = e
            loop.close()
            return
        finally:
            ready.set()
        try:
            loop.run_forever()
        finally:
            loop.run_until_complete(server.stop())
            loop.close()

    t = threading.Thread(target=_run, daemon=True, name="tod-path-server")
    t.start()
    if not ready.wait(timeout=10):
        raise RuntimeError("path server did not start within 10s")
    if "error" in holder:
        raise RuntimeError(f"path server failed to start: {holder['error']!r}") from holder["error"]
    server._loop = holder["loop"]  # type: ignore[attr-defined]
    return t, server


def stop_thread_server(server: PathServer) -> None:
    loop = getattr(server, "_loop", None)
    if loop is not None and not loop.is_closed():
        try:
            loop.call_soon_threadsafe(loop.stop)
        except RuntimeError:
            pass  # the loop closed between the check and the call
