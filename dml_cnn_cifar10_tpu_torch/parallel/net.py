"""Network transport for the cluster's coordination.

A copy of ``dml_cnn_cifar10_tpu/parallel/net.py`` over the port's
``parallel/cluster.py`` and ``utils/backoff.py``. The wire format is the
JAX module's: the paths, the ``X-DML-Proc`` header, the JSON bodies and
the files on the server's disk, so a port client works against a JAX
server and a JAX client against a port server.

The file-backed :class:`~dml_cnn_cifar10_tpu_torch.parallel.cluster.HeartbeatStore`
and :class:`~dml_cnn_cifar10_tpu_torch.parallel.cluster.RestartCoordinator`
assume every host mounts one shared directory. This module keeps their
contracts but carries them over a socket: process 0 hosts
:class:`CoordServer`, a stdlib ``ThreadingHTTPServer`` gateway over the
coordination directory, and every process (process 0 too, over loopback)
talks to it through :class:`CoordClient`. The server's on-disk state stays
``cat``-able post-mortem like the file store's.

- **Every request is bounded.** Each operation carries a socket timeout
  (``--net_timeout_s``) and a retry budget (``--net_retries``) over the
  shared bounded backoff (``utils/backoff.py``). The ``no_net_timeout``
  plant of the chaos oracle (``tools/chaos.py``) strips the bound to
  prove the campaign notices.
- **Every failure is classified.** Socket-level failures raise
  :class:`TransportError` with a machine-readable ``reason``
  (``timeout`` / ``unreachable`` / ``http_<code>`` / ``proto``). It
  subclasses ``OSError``, so every caller hardened against file-store IO
  errors (the peer-replica push retry, the beat reads) handles a network
  failure the same way.
- **Degraded, never hung.** :class:`NetHeartbeatStore` turns a transport
  failure into the observable the file store gives for a dead peer, an
  absent beat, so the watchdog's ``peer_lost`` classification fires
  unchanged. :class:`NetRestartCoordinator` turns a failed ``record``
  into :class:`~dml_cnn_cifar10_tpu_torch.parallel.cluster.EvictedError`:
  a chief that cannot commit a decision is cut off, and the supervisor's
  fence-or-rejoin path is the answer (under ``elastic_expand`` it
  rejoins once the partition heals).

Fault injection: the server consults ``utils/netfaults.py`` once a
request (partition: hold the connection and never answer; delay: answer
late; drop: 503 every second request; dup: apply writes twice), armed by
``POST /fault`` from the process the fault spec isolates.

Rendezvous: the server atomically writes ``coord_addr.json`` into the
coordination directory; clients resolve it lazily, with a grace on the
first resolution so a client racing the server's bind classifies as
``unreachable`` only once the grace is spent.
"""

from __future__ import annotations

import dataclasses
import hashlib
import http.client
import json
import os
import shutil
import socket
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence

from dml_cnn_cifar10_tpu_torch.parallel import cluster as cluster_lib
from dml_cnn_cifar10_tpu_torch.utils import backoff, netfaults

#: Rendezvous file the server commits (atomic rename) into the
#: coordination directory; clients resolve it lazily.
ADDR_FILENAME = "coord_addr.json"

#: Request header naming the calling process id — how the server (and
#: the armed netfaults state) knows WHOM a request belongs to.
PROC_HEADER = "X-DML-Proc"

#: Grace a client grants the server's bind on FIRST resolution only:
#: in the lockstep simulations every process starts at once and the
#: server host pays its imports before it binds.
RESOLVE_GRACE_S = 10.0

#: Sentinel: "use the client's configured timeout". Distinct from None,
#: which means NO timeout at all — the misconfiguration the
#: ``no_net_timeout`` planted regression injects on purpose.
_DEFAULT = object()


class TransportError(OSError):
    """A classified transport failure. ``reason`` is machine-readable:
    ``timeout`` (the bounded wait expired), ``unreachable`` (connect
    refused / no address published), ``http_<code>`` (the server
    answered but unhappily), ``proto`` (undecodable response)."""

    def __init__(self, reason: str, message: str):
        super().__init__(f"[{reason}] {message}")
        self.reason = reason


class CoordClient:
    """Bounded, classified, retrying HTTP client for one coordination
    directory. Thread-safe; one per process (the beat publisher,
    watchdog, and seam threads share it)."""

    def __init__(self, coord_dir: str, process_id: int,
                 timeout_s: float = 5.0, retries: int = 2,
                 log_fn=None, resolve_grace_s: float = RESOLVE_GRACE_S):
        self.coord_dir = coord_dir
        self.process_id = int(process_id)
        self.timeout_s = float(timeout_s)
        self.retries = max(int(retries), 0)
        self.resolve_grace_s = float(resolve_grace_s)
        self._addr_path = os.path.join(coord_dir, ADDR_FILENAME)
        self._addr: Optional[tuple] = None
        self._resolved_once = False
        self._log = log_fn
        self._lock = threading.Lock()
        self._last_note: Dict[tuple, float] = {}
        # Each thread keeps one connection (the publisher, the watchdog
        # and the step thread each their own).
        self._local = threading.local()

    # -- plumbing ---------------------------------------------------------

    def _resolve(self) -> tuple:
        with self._lock:
            if self._addr is not None:
                return self._addr
            grace = 0.0 if self._resolved_once else self.resolve_grace_s
        deadline = time.time() + grace
        attempt = 0
        while True:
            try:
                with open(self._addr_path) as f:
                    doc = json.load(f)
                addr = (str(doc["host"]), int(doc["port"]))
            except (OSError, ValueError, KeyError, TypeError) as e:
                if time.time() >= deadline:
                    raise TransportError(
                        "unreachable",
                        f"no coordinator address at {self._addr_path}: "
                        f"{e}")
                attempt += 1
                time.sleep(backoff.delay_s(0.05, 0.5, attempt))
                continue
            with self._lock:
                self._addr = addr
                self._resolved_once = True
            return addr

    def _connection(self, addr: tuple, timeout) -> http.client.HTTPConnection:
        """This thread's kept connection to ``addr`` with ``timeout`` on its
        socket (a new one when the address changed or the last request on
        it failed)."""
        conn = getattr(self._local, "conn", None)
        if conn is not None and (conn.host, conn.port) != addr:
            self._drop_connection()
            conn = None
        if conn is None:
            conn = self._local.conn = http.client.HTTPConnection(
                *addr, timeout=timeout)
        conn.timeout = timeout
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        return conn

    def _drop_connection(self) -> None:
        conn = getattr(self._local, "conn", None)
        self._local.conn = None
        if conn is not None:
            conn.close()

    def _request(self, method: str, path: str, body=None,
                 timeout_s=_DEFAULT):
        """ONE bounded attempt: returns ``(status, payload_bytes)`` for
        any HTTP answer, raises classified :class:`TransportError` for
        socket-level failures. The same timeout bounds the connect and
        every read. ``timeout_s=None`` disables the bound — never passed
        by this module; it exists so the ``no_net_timeout`` chaos plant
        can demonstrate what happens when it is.

        The JAX module opens a connection a request (``urllib``); on the
        card's gVisor machine a loopback connect is slow enough to double
        the eager CNN's step over this transport (PERF.md, PR 20), so a
        thread keeps its connection (HTTP/1.1; a JAX server's HTTP/1.0
        answer closes it, and the next request opens another). A kept
        connection that the server closed while idle is retried once on
        a new one; any other failure drops the connection, so a request
        held by a partition never blocks the next."""
        addr = self._resolve()
        method_path = f"{method} {path}"
        headers = {PROC_HEADER: str(self.process_id),
                   "Content-Type": "application/octet-stream"}
        timeout = self.timeout_s if timeout_s is _DEFAULT else timeout_s
        for retry in (False, True):
            conn = self._connection(addr, timeout)
            kept = conn.sock is not None
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                return resp.status, resp.read()
            except (socket.timeout, TimeoutError) as e:
                self._drop_connection()
                raise TransportError(
                    "timeout", f"{method_path} overran {timeout}s") from e
            except (http.client.RemoteDisconnected, BrokenPipeError,
                    ConnectionResetError) as e:
                self._drop_connection()
                if kept and not retry:
                    continue
                raise TransportError("unreachable",
                                     f"{method_path}: {e!r}") from e
            except http.client.HTTPException as e:
                self._drop_connection()
                raise TransportError("proto", f"{method_path}: {e!r}") from e
            except OSError as e:
                self._drop_connection()
                raise TransportError("unreachable",
                                     f"{method_path}: {e}") from e

    def _call(self, op: str, method: str, path: str, body=None,
              ok: Sequence[int] = (200,),
              retry_status: Sequence[int] = (500, 502, 503)):
        """Retrying wrapper: ``retries`` extra attempts over the shared
        bounded backoff, ``net`` telemetry on resolution (rate-limited
        per op+outcome — a partition must not flood the stream at the
        heartbeat cadence)."""
        attempts = self.retries + 1
        err: Optional[TransportError] = None
        t0 = time.perf_counter()
        for attempt in range(1, attempts + 1):
            try:
                status, payload = self._request(method, path, body=body)
            except TransportError as e:
                err = e
                if e.reason == "unreachable":
                    # The address may be stale (server restarted on a
                    # new port): drop the cache so the next attempt
                    # re-resolves.
                    with self._lock:
                        self._addr = None
            else:
                if status in ok:
                    self._note(op, True, attempt,
                               time.perf_counter() - t0, status=status)
                    return status, payload
                err = TransportError(
                    f"http_{status}",
                    f"{method} {path} -> {status}: {payload[:200]!r}")
                if status not in retry_status:
                    break
            if attempt < attempts:
                time.sleep(backoff.delay_s(0.05, 0.5, attempt))
        self._note(op, False, attempts, time.perf_counter() - t0,
                   error=err.reason)
        raise err

    def _note(self, op: str, ok: bool, attempts: int, secs: float,
              status=None, error=None) -> None:
        if self._log is None:
            return
        key = (op, error or "ok")
        now = time.time()
        if now - self._last_note.get(key, 0.0) < 1.0:
            return
        self._last_note[key] = now
        self._log("net", op=op, ok=ok, ms=round(secs * 1000.0, 3),
                  attempts=attempts, status=status, error=error,
                  wallclock=round(now, 3))

    # -- operations (paths are RELATIVE to the coordination dir) ----------

    @staticmethod
    def _q(rel: str) -> str:
        return urllib.parse.quote(rel, safe="/")

    def get(self, rel: str) -> Optional[bytes]:
        status, payload = self._call("get", "GET", "/kv/" + self._q(rel),
                                     ok=(200, 404))
        return None if status == 404 else payload

    def put(self, rel: str, data: bytes) -> None:
        self._call("put", "PUT", "/kv/" + self._q(rel), body=data)

    def delete(self, rel: str) -> None:
        self._call("delete", "DELETE", "/kv/" + self._q(rel),
                   ok=(200, 404))

    def scan(self, rel: str) -> Dict[str, str]:
        """All ``*.json`` files directly under ``rel``, name → raw
        text, in ONE round trip (``read_all`` must not pay a request
        per peer)."""
        _, payload = self._call("scan", "GET", "/scan/" + self._q(rel))
        try:
            return dict(json.loads(payload)["files"])
        except (ValueError, TypeError, KeyError) as e:
            raise TransportError("proto", f"undecodable scan of "
                                          f"{rel!r}: {e}")

    def list_dir(self, rel: str) -> List[str]:
        _, payload = self._call("list", "GET", "/list/" + self._q(rel))
        try:
            return list(json.loads(payload)["names"])
        except (ValueError, TypeError, KeyError) as e:
            raise TransportError("proto", f"undecodable listing of "
                                          f"{rel!r}: {e}")

    def rename(self, src: str, dst: str) -> None:
        body = json.dumps({"src": src, "dst": dst}).encode()
        self._call("rename", "POST", "/rename", body=body)

    def delete_tree(self, rel: str) -> None:
        self._call("delete_tree", "DELETE", "/tree/" + self._q(rel),
                   ok=(200, 404))

    def post_fault(self, kind: str, isolate: Sequence[int],
                   duration_s: Optional[float] = None) -> Dict:
        """Arm a network fault ON THE SERVER (utils/netfaults.py). The
        injector calls this from the process being isolated — the arm
        request itself must land before the fault takes effect."""
        doc = {"kind": kind, "isolate": list(isolate)}
        if duration_s is not None:
            doc["duration_s"] = float(duration_s)
        _, payload = self._call("fault", "POST", "/fault",
                                body=json.dumps(doc).encode())
        try:
            return dict(json.loads(payload))
        except (ValueError, TypeError) as e:
            raise TransportError("proto", f"undecodable fault ack: {e}")

    def healthz(self) -> bool:
        try:
            self._call("healthz", "GET", "/healthz")
            return True
        except TransportError:
            return False


class _CoordHTTPServer(ThreadingHTTPServer):
    # Handler threads may be parked forever inside an armed partition
    # hold, or idle on a kept connection; they must neither outlive-block
    # process exit nor stall server_close().
    daemon_threads = True
    block_on_close = False
    coord_root = ""
    coord_stopping = False

    def server_bind(self):
        super().server_bind()
        self._open = set()
        self._open_lock = threading.Lock()

    def process_request(self, request, client_address):
        with self._open_lock:
            self._open.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._open_lock:
            self._open.discard(request)
        super().shutdown_request(request)

    def close_connections(self) -> None:
        """End every kept connection (their handler threads read EOF)."""
        with self._open_lock:
            conns = list(self._open)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class _CoordHandler(BaseHTTPRequestHandler):
    """File-gateway endpoints over the coordination directory:

    ``GET/PUT/DELETE /kv/<rel>`` (octet-stream; writes are atomic
    tmp→rename server-side), ``GET /scan/<rel>`` (every ``*.json``
    under a dir in one response), ``GET /list/<rel>``,
    ``POST /rename`` ``{src, dst}`` (the peer-replica commit),
    ``DELETE /tree/<rel>``, ``GET /healthz``, ``POST /fault``
    (arm utils/netfaults.py state)."""

    server_version = "DMLCoord/1.0"
    # Kept connections (the port's client keeps one a thread); a client
    # that sends ``Connection: close`` (the JAX package's urllib) gets
    # one response a connection, as from the JAX module's server.
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet: telemetry is JSONL
        pass

    # -- helpers ----------------------------------------------------------

    def _pid(self) -> Optional[int]:
        raw = self.headers.get(PROC_HEADER)
        try:
            return int(raw) if raw is not None else None
        except ValueError:
            return None

    def _gate(self) -> Optional[str]:
        """Armed-fault gate, consulted once per request. Returns the
        write mode (``"ok"`` / ``"dup"``) or None when the request was
        consumed by the fault (held or dropped)."""
        action = netfaults.server_action(self._pid())
        if action[0] in ("hold", "drop"):
            # The request's body may be unread: this connection carries
            # no further request.
            self.close_connection = True
        if action[0] == "hold":
            # A partitioned link eats the reply: hold the connection
            # and NEVER answer. The client's socket timeout is what
            # bounds this — strip it (--plant no_net_timeout) and the
            # caller hangs to the chaos deadline, by design.
            while not self.server.coord_stopping:
                time.sleep(0.05)
            return None
        if action[0] == "drop":
            self._json(503, {"error": "injected_drop"})
            return None
        if action[0] == "delay":
            time.sleep(action[1])
            return "ok"
        return action[0]

    def _safe(self, rel: str) -> str:
        root = self.server.coord_root
        p = os.path.normpath(os.path.join(root, rel))
        if p != root and not p.startswith(root + os.sep):
            raise ValueError(f"path escapes coordination dir: {rel!r}")
        return p

    def _body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    def _reply(self, status: int, body: bytes, ctype: str) -> None:
        try:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except OSError:
            pass  # client gave up (timed out) — nothing to tell it

    def _json(self, status: int, doc) -> None:
        self._reply(status, json.dumps(doc).encode(),
                    "application/json")

    # -- verbs ------------------------------------------------------------

    def do_GET(self):
        if self._gate() is None:
            return
        try:
            if self.path == "/healthz":
                return self._json(200, {"ok": True})
            if self.path.startswith("/kv/"):
                target = self._safe(
                    urllib.parse.unquote(self.path[len("/kv/"):]))
                try:
                    with open(target, "rb") as f:
                        payload = f.read()
                except OSError:
                    return self._json(404, {"error": "not_found"})
                return self._reply(200, payload,
                                   "application/octet-stream")
            if self.path.startswith("/scan/"):
                d = self._safe(
                    urllib.parse.unquote(self.path[len("/scan/"):]))
                files: Dict[str, str] = {}
                try:
                    names = os.listdir(d)
                except OSError:
                    names = []
                for name in names:
                    if not name.endswith(".json"):
                        continue
                    try:
                        with open(os.path.join(d, name)) as f:
                            files[name] = f.read()
                    except OSError:
                        continue  # mid-rename; self-heals next poll
                return self._json(200, {"files": files})
            if self.path.startswith("/list/"):
                d = self._safe(
                    urllib.parse.unquote(self.path[len("/list/"):]))
                try:
                    names = sorted(os.listdir(d))
                except OSError:
                    names = []
                return self._json(200, {"names": names})
            return self._json(400, {"error": "bad_path"})
        except ValueError as e:
            return self._json(400, {"error": str(e)[:200]})

    def do_PUT(self):
        mode = self._gate()
        if mode is None:
            return
        payload = self._body()
        if not self.path.startswith("/kv/"):
            return self._json(400, {"error": "bad_path"})
        try:
            target = self._safe(
                urllib.parse.unquote(self.path[len("/kv/"):]))
        except ValueError as e:
            return self._json(400, {"error": str(e)[:200]})
        # A net_dup window applies the write twice: duplicate delivery
        # must be invisible because every commit is an atomic replace.
        for _ in range(2 if mode == "dup" else 1):
            os.makedirs(os.path.dirname(target), exist_ok=True)
            tmp = target + f".tmp{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb") as f:
                f.write(payload)
            os.replace(tmp, target)
        return self._json(200, {"ok": True, "dup": mode == "dup"})

    def do_POST(self):
        mode = self._gate()
        if mode is None:
            return
        body = self._body()
        if self.path == "/fault":
            try:
                doc = json.loads(body)
                rec = netfaults.arm(doc["kind"],
                                    doc.get("isolate") or [],
                                    duration_s=doc.get("duration_s"))
            except (ValueError, TypeError, KeyError) as e:
                return self._json(400, {"error": str(e)[:200]})
            return self._json(200, {k: rec[k] for k in
                                    ("kind", "isolate", "duration_s",
                                     "until")})
        if self.path == "/rename":
            try:
                doc = json.loads(body)
                src = self._safe(str(doc["src"]))
                dst = self._safe(str(doc["dst"]))
            except (ValueError, TypeError, KeyError) as e:
                return self._json(400, {"error": str(e)[:200]})
            try:
                for _ in range(2 if mode == "dup" else 1):
                    if os.path.isdir(src):
                        os.rename(src, dst)  # dir commit (peerstore)
                    else:
                        os.replace(src, dst)
            except OSError as e:
                return self._json(404, {"error": str(e)[:200]})
            return self._json(200, {"ok": True})
        return self._json(400, {"error": "bad_path"})

    def do_DELETE(self):
        if self._gate() is None:
            return
        try:
            if self.path.startswith("/kv/"):
                target = self._safe(
                    urllib.parse.unquote(self.path[len("/kv/"):]))
                try:
                    os.remove(target)
                except FileNotFoundError:
                    return self._json(404, {"error": "not_found"})
                except OSError as e:
                    return self._json(500, {"error": str(e)[:200]})
                return self._json(200, {"ok": True})
            if self.path.startswith("/tree/"):
                target = self._safe(
                    urllib.parse.unquote(self.path[len("/tree/"):]))
                shutil.rmtree(target, ignore_errors=True)
                return self._json(200, {"ok": True})
            return self._json(400, {"error": "bad_path"})
        except ValueError as e:
            return self._json(400, {"error": str(e)[:200]})


class CoordServer:
    """The coordination service: an HTTP gateway over one directory,
    hosted by process 0 of the cluster. Publishes its address via atomic rename of
    ``coord_addr.json`` into the directory it serves."""

    def __init__(self, coord_dir: str, host: str = "127.0.0.1",
                 port: int = 0):
        os.makedirs(coord_dir, exist_ok=True)
        self.coord_dir = os.path.abspath(coord_dir)
        self._httpd = _CoordHTTPServer((host, port), _CoordHandler)
        self._httpd.coord_root = self.coord_dir
        self._httpd.coord_stopping = False
        self.host = self._httpd.server_address[0]
        self.port = int(self._httpd.server_address[1])
        addr_path = os.path.join(self.coord_dir, ADDR_FILENAME)
        tmp = addr_path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"host": self.host, "port": self.port}, f)
        os.replace(tmp, addr_path)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1}, daemon=True,
            name="coord-server")
        self._thread.start()

    def stop(self) -> None:
        self._httpd.coord_stopping = True
        self._httpd.shutdown()
        self._httpd.close_connections()
        self._httpd.server_close()
        self._thread.join(timeout=2.0)


class NetHeartbeatStore:
    """The :class:`~dml_cnn_cifar10_tpu_torch.parallel.cluster.HeartbeatStore`
    contract over :class:`CoordClient`.

    Failure mapping is the whole design: a publish that cannot reach
    the coordinator is swallowed (the classified ``net`` record is the
    trace) — from the rest of the cluster this process simply stops
    beating, which is what a partitioned host IS. A read that cannot
    reach the coordinator returns None/empty — from this process every
    peer looks absent, and the watchdog ages them from ``started_at``
    into the ordinary ``peer_lost`` path. No caching: a partition must
    look like silence, not like a frozen-but-fresh world."""

    def __init__(self, cluster_dir: str, process_id: int,
                 client: CoordClient, log_fn=None):
        self.dir = os.path.join(cluster_dir, "heartbeats")
        self.process_id = process_id
        self.client = client
        self.started_at = time.time()
        self._log = log_fn
        self._last_decode_note: Dict[str, float] = {}

    def _rel(self, pid: int) -> str:
        return f"heartbeats/proc_{pid}.json"

    def publish(self, step: int, phase: str,
                extra: Optional[Dict] = None) -> "cluster_lib.Beat":
        beat = cluster_lib.Beat(self.process_id, int(step), time.time(),
                                phase, extra=extra)
        try:
            self.client.put(self._rel(self.process_id),
                            json.dumps(dataclasses.asdict(beat)).encode())
        except TransportError:
            pass  # classified by the client's net record; stay silent
        return beat

    def read(self, pid: int) -> Optional["cluster_lib.Beat"]:
        try:
            payload = self.client.get(self._rel(pid))
        except TransportError:
            return None
        if payload is None:
            return None
        try:
            return cluster_lib.Beat(**json.loads(payload))
        except (ValueError, TypeError):
            return None

    def read_peers(self, expected: Sequence[int]
                   ) -> Dict[int, Optional["cluster_lib.Beat"]]:
        return {pid: self.read(pid) for pid in expected
                if pid != self.process_id}

    def _note_decode(self, path: str, error: str) -> None:
        if self._log is None:
            return
        now = time.time()
        if now - self._last_decode_note.get(path, 0.0) < 1.0:
            return
        self._last_decode_note[path] = now
        self._log("beat_decode_error", path=path, error=error[:200])

    def read_all(self) -> Dict[int, "cluster_lib.Beat"]:
        try:
            files = self.client.scan("heartbeats")
        except TransportError:
            return {}
        out: Dict[int, cluster_lib.Beat] = {}
        for name, text in files.items():
            if not (name.startswith("proc_") and name.endswith(".json")):
                continue
            try:
                pid = int(name[len("proc_"):-len(".json")])
            except ValueError:
                continue
            try:
                out[pid] = cluster_lib.Beat(**json.loads(text))
            except (ValueError, TypeError) as e:
                self._note_decode(f"heartbeats/{name}", str(e))
        return out


class NetRestartCoordinator:
    """The :class:`~dml_cnn_cifar10_tpu_torch.parallel.cluster.RestartCoordinator`
    contract over :class:`CoordClient`: same payload, same sha256
    sidecar, same payload→sidecar commit order (each PUT is an atomic
    replace server-side), same monotone-epoch rule.

    The one new failure mode — the coordinator is unreachable — maps
    onto the existing protocol: ``read`` reports the decision absent
    (poll loops self-heal, ``await_decision`` times out into the
    coordinator-lost ``PeerLostError``), and ``record`` raises
    :class:`~dml_cnn_cifar10_tpu_torch.parallel.cluster.EvictedError` after
    the bounded retries — a chief that cannot commit is cut off from
    the world it is deciding for, and fencing (or, under
    ``elastic_expand``, rejoining once the partition heals) is the only
    split-brain-free move."""

    REL = "restart_decision.json"

    def __init__(self, cluster_dir: str, client: CoordClient,
                 log_fn=None):
        self.path = os.path.join(cluster_dir, self.REL)
        self.sidecar_path = self.path + ".sha256"
        self.client = client
        self._log = log_fn
        self._last_bad_digest: Optional[str] = None

    def _note_corrupt(self, digest: str, error: str) -> None:
        if digest == self._last_bad_digest:
            return
        self._last_bad_digest = digest
        print(f"[cluster] corrupt restart decision {self.path}: "
              f"{error}; reading as absent", file=sys.stderr)
        if self._log is not None:
            self._log("decision_corrupt", path=self.path, error=error)

    def read(self) -> Optional["cluster_lib.RestartDecision"]:
        try:
            payload = self.client.get(self.REL)
        except TransportError:
            return None
        if payload is None:
            return None
        digest = hashlib.sha256(payload).hexdigest()
        want = None
        try:
            sidecar = self.client.get(self.REL + ".sha256")
        except TransportError:
            sidecar = None  # answered for payload, lost for sidecar:
            #                 treat as mid-commit, self-heal next poll
        if sidecar is not None:
            try:
                want = json.loads(sidecar)["digest"]
            except (ValueError, TypeError, KeyError) as e:
                self._note_corrupt(digest, f"undecodable sidecar: {e}")
                return None
        if want is not None and want != digest:
            self._note_corrupt(
                digest, f"sidecar digest mismatch (have {digest[:12]}…, "
                        f"sidecar says {str(want)[:12]}…)")
            return None
        try:
            return cluster_lib.RestartDecision(**json.loads(payload))
        except (ValueError, TypeError) as e:
            self._note_corrupt(digest, f"undecodable decision: {e}")
            return None

    def record(self, decision: "cluster_lib.RestartDecision"
               ) -> "cluster_lib.RestartDecision":
        prior = self.read()
        if prior is not None and prior.epoch >= decision.epoch:
            # Decision race: this seat classified a failure and decided
            # while ANOTHER seat's decision for the same (or a newer)
            # epoch was already committed — the partitioned-minority
            # case, where the majority's shrink landed while our reads
            # were timing out. The committed file wins, always:
            # excluded → the fence/rejoin path (exactly what a healed
            # minority must do); included → adopt the committed world
            # instead of racing it. Unlike the file coordinator's
            # monotone ValueError, this is a REACHABLE runtime state
            # under net, not a programming error.
            if self.client.process_id not in prior.survivors:
                raise cluster_lib.EvictedError(
                    f"decision race lost: epoch {prior.epoch} already "
                    f"committed excluding process "
                    f"{self.client.process_id} (was recording epoch "
                    f"{decision.epoch}); fencing")
            return prior
        payload = json.dumps(dataclasses.asdict(decision)).encode()
        sidecar = json.dumps(
            {"algo": "sha256",
             "digest": hashlib.sha256(payload).hexdigest()}).encode()
        try:
            self.client.put(self.REL, payload)
            self.client.put(self.REL + ".sha256", sidecar)
        except TransportError as e:
            raise cluster_lib.EvictedError(
                f"cut off from the coordination service while "
                f"recording epoch {decision.epoch} ({e.reason}); "
                f"fencing") from e
        return decision

    def await_decision(self, min_epoch: int, timeout_s: float,
                       poll_s: float = 0.05
                       ) -> "cluster_lib.RestartDecision":
        deadline = time.time() + timeout_s
        attempt = 0
        while True:
            d = self.read()
            if d is not None and d.epoch >= min_epoch:
                return d
            if time.time() > deadline:
                raise cluster_lib.PeerLostError(
                    [0], f"no restart decision at epoch >= {min_epoch} "
                         f"within {timeout_s:.1f}s — coordinator lost")
            attempt += 1
            time.sleep(backoff.delay_s(poll_s, poll_s * 10.0, attempt))
