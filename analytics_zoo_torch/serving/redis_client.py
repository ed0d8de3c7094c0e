"""Minimal Redis client (RESP protocol) + embedded in-process broker.

The reference's Cluster Serving rides Redis streams
(ClusterServing.scala:103-113 reads stream ``image_stream``, results
land in the ``result`` table; client pyzoo/zoo/serving/client.py uses
XADD/HGETALL).  No redis-py is vendored here: RESP is a tiny protocol,
so ``RedisClient`` speaks it directly over a socket — zero external
dependencies.  ``EmbeddedBroker`` implements the same command subset
in-process for tests and single-node serving without a Redis server.
"""

from __future__ import annotations

import itertools
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple


class _RespReader:
    """Buffered RESP framing over a recv callable — the \\r\\n line /
    exact-n bulk reads shared by the client and the TCP broker."""

    def __init__(self, recv):
        self._recv = recv
        self.buf = b""

    def _fill(self) -> None:
        chunk = self._recv(65536)
        if not chunk:
            raise ConnectionError("connection closed")
        self.buf += chunk

    def line(self) -> bytes:
        while b"\r\n" not in self.buf:
            self._fill()
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    def exact(self, n: int) -> bytes:
        while len(self.buf) < n + 2:    # payload + trailing \r\n
            self._fill()
        data, self.buf = self.buf[:n], self.buf[n + 2:]
        return data


class RedisClient:
    """Speaks RESP2 for the commands serving needs: XADD, XREAD, XLEN,
    XTRIM, XDEL, HSET, HGETALL, HDEL, DEL, PING, INFO."""

    def __init__(self, host: str = "localhost", port: int = 6379,
                 timeout: float = 5.0):
        self.sock = socket.create_connection((host, port), timeout)
        self._reader = _RespReader(self.sock.recv)

    # ------------------------------------------------------------ protocol
    def execute(self, *args) -> Any:
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            if isinstance(a, str):
                a = a.encode()
            elif not isinstance(a, bytes):
                a = str(a).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(a), a))
        self.sock.sendall(b"".join(out))
        return self._read_reply()

    def _read_line(self) -> bytes:
        return self._reader.line()

    def _read_exact(self, n: int) -> bytes:
        return self._reader.exact(n)

    def _read_reply(self) -> Any:
        line = self._read_line()
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            raise RuntimeError(f"redis error: {rest.decode()}")
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            return None if n == -1 else self._read_exact(n)
        if t == b"*":
            n = int(rest)
            return None if n == -1 else [self._read_reply()
                                         for _ in range(n)]
        raise RuntimeError(f"bad RESP type {t!r}")

    # ------------------------------------------------------------ commands
    def ping(self) -> bool:
        return self.execute("PING") == "PONG"

    def xadd(self, stream: str, fields: Dict[str, Any]) -> bytes:
        args = ["XADD", stream, "*"]
        for k, v in fields.items():
            args += [k, v]
        return self.execute(*args)

    def xread(self, stream: str, last_id: str = "0-0",
              count: int = 64, block_ms: Optional[int] = None):
        args = ["XREAD", "COUNT", count]
        # BLOCK 0 means block FOREVER to redis; callers use 0/None for
        # "return immediately", so only emit BLOCK for positive waits
        if block_ms:
            args += ["BLOCK", block_ms]
        args += ["STREAMS", stream, last_id]
        reply = self.execute(*args)
        return _parse_xread(reply)

    def xgroup_create(self, stream: str, group: str,
                      start_id: str = "0") -> None:
        """Create a consumer group (MKSTREAM so a fresh deployment
        works before the first enqueue); BUSYGROUP = already exists."""
        try:
            self.execute("XGROUP", "CREATE", stream, group, start_id,
                         "MKSTREAM")
        except RuntimeError as e:
            if "BUSYGROUP" not in str(e):
                raise

    def xreadgroup(self, group: str, consumer: str, stream: str,
                   count: int = 64, block_ms: Optional[int] = None):
        """Pop NEW entries for this consumer — each stream entry is
        delivered to exactly one consumer in the group."""
        args = ["XREADGROUP", "GROUP", group, consumer, "COUNT", count]
        if block_ms:          # see xread: BLOCK 0 = forever on redis
            args += ["BLOCK", block_ms]
        args += ["STREAMS", stream, ">"]
        return _parse_xread(self.execute(*args))

    def xack(self, stream: str, group: str, *ids) -> int:
        return self.execute("XACK", stream, group, *ids)

    def xautoclaim(self, stream: str, group: str, consumer: str,
                   min_idle_ms: int, count: int = 64):
        """Claim another consumer's pending entries idle for at least
        ``min_idle_ms`` (crash recovery; Redis >= 6.2)."""
        reply = self.execute("XAUTOCLAIM", stream, group, consumer,
                             min_idle_ms, "0-0", "COUNT", count)
        # reply: [next_cursor, [[id, [k,v,...]], ...], (deleted ids)]
        entries = reply[1] if reply and len(reply) > 1 else []
        # Redis 6.2 returns [id, nil] for pending entries whose data
        # was XTRIMmed out of the stream (7.0 drops them server-side).
        # Their payload is unrecoverable — ack them out of the PEL so
        # they can't wedge every future reclaim pass.
        live, dead = [], []
        for entry_id, kvs in entries:
            (live if kvs is not None else dead).append((entry_id, kvs))
        if dead:
            self.xack(stream, group,
                      *[i.decode() if isinstance(i, bytes) else i
                        for i, _ in dead])
        return _parse_xread([[stream, live]])

    def xlen(self, stream: str) -> int:
        return self.execute("XLEN", stream)

    def xlag(self, stream: str, group: str) -> int:
        """The group's true BACKLOG: entries never delivered to any
        consumer (``lag``, Redis >= 7.0) plus delivered-but-unacked
        pending.  ``XLEN`` cannot express this — served entries stay
        in the stream until trimmed, so stream length reads high
        forever; backlog is what admission control and the fleet
        autoscaler actually need.  Falls back to ``XLEN`` when XINFO
        is unavailable (old server) or lag is nil (entries deleted
        mid-stream make it uncomputable)."""
        try:
            reply = self.execute("XINFO", "GROUPS", stream)
        except RuntimeError:
            return self.xlen(stream)
        for entry in reply or []:
            fields = {}
            for i in range(0, len(entry) - 1, 2):
                k = entry[i]
                fields[k.decode() if isinstance(k, bytes) else k] = \
                    entry[i + 1]
            name = fields.get("name")
            if isinstance(name, bytes):
                name = name.decode()
            if name == group:
                lag = fields.get("lag")
                if lag is None:
                    return self.xlen(stream)
                return int(lag) + int(fields.get("pending", 0) or 0)
        return self.xlen(stream)

    def xtrim(self, stream: str, maxlen: int) -> int:
        return self.execute("XTRIM", stream, "MAXLEN", maxlen)

    def xdel(self, stream: str, *ids) -> int:
        return self.execute("XDEL", stream, *ids)

    def shutdown(self) -> None:
        """Terminate the redis server (cluster-serving-shutdown's
        ``redis-cli shutdown`` role); the server closes the connection
        without a reply."""
        try:
            self.execute("SHUTDOWN", "NOSAVE")
        except Exception:
            pass   # connection drop IS the success signal

    def hset(self, key: str, fields: Dict[str, Any]) -> int:
        args = ["HSET", key]
        for k, v in fields.items():
            args += [k, v]
        return self.execute(*args)

    def hgetall(self, key: str) -> Dict[str, bytes]:
        reply = self.execute("HGETALL", key) or []
        return {reply[i].decode(): reply[i + 1]
                for i in range(0, len(reply), 2)}

    def hdel(self, key: str, *fields) -> int:
        return self.execute("HDEL", key, *fields)

    def delete(self, *keys) -> int:
        return self.execute("DEL", *keys)

    def close(self):
        self.sock.close()


def _parse_xread(reply):
    """[[stream, [[id, [k,v,...]], ...]]] -> list of (id, fields)"""
    out: List[Tuple[str, Dict[str, bytes]]] = []
    if not reply:
        return out
    for _stream, entries in reply:
        for entry_id, kvs in entries:
            if kvs is None:      # trimmed-entry tombstone (Redis 6.2)
                continue
            fields = {kvs[i].decode(): kvs[i + 1]
                      for i in range(0, len(kvs), 2)}
            out.append((entry_id.decode()
                        if isinstance(entry_id, bytes) else entry_id,
                        fields))
    return out


class EmbeddedBroker:
    """In-process stand-in with the same method surface."""

    def __init__(self):
        self._streams: Dict[str, List[Tuple[str, Dict]]] = {}
        self._hashes: Dict[str, Dict[str, Any]] = {}
        # (stream, group) -> {"delivered": last id handed out,
        #                     "pending": {id: consumer}}
        self._groups: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)

    def ping(self) -> bool:
        return True

    def xadd(self, stream: str, fields: Dict[str, Any]) -> str:
        with self._cv:
            entry_id = f"{int(time.time() * 1000)}-{next(self._seq)}"
            enc = {k: (v.encode() if isinstance(v, str) else v)
                   for k, v in fields.items()}
            self._streams.setdefault(stream, []).append((entry_id, enc))
            self._cv.notify_all()
            return entry_id

    def xread(self, stream: str, last_id: str = "0-0", count: int = 64,
              block_ms: Optional[int] = None):
        deadline = time.time() + (block_ms or 0) / 1000.0
        while True:
            with self._cv:
                entries = self._streams.get(stream, [])
                out = [(i, f) for i, f in entries
                       if _id_gt(i, last_id)][:count]
                if out or block_ms is None:
                    return out
                remaining = deadline - time.time()
                if remaining <= 0:
                    return out
                self._cv.wait(min(remaining, 0.05))

    def xgroup_create(self, stream: str, group: str,
                      start_id: str = "0") -> None:
        with self._lock:
            entries = self._streams.setdefault(stream, [])
            if start_id in ("0", "0-0"):
                cursor = "0-0"
            elif start_id == "$":
                cursor = entries[-1][0] if entries else "0-0"
            else:
                cursor = start_id   # must be an exact ms-seq id
                _id_gt(cursor, "0-0")   # validates the format
            self._groups.setdefault(
                (stream, group),
                {"delivered": cursor, "pending": {}})

    def xreadgroup(self, group: str, consumer: str, stream: str,
                   count: int = 64, block_ms: Optional[int] = None):
        deadline = time.time() + (block_ms or 0) / 1000.0
        while True:
            with self._cv:
                g = self._groups.get((stream, group))
                if g is None:
                    raise RuntimeError(
                        f"NOGROUP no such consumer group {group}")
                entries = self._streams.get(stream, [])
                out = [(i, f) for i, f in entries
                       if _id_gt(i, g["delivered"])][:count]
                if out:
                    g["delivered"] = out[-1][0]
                    now = time.time()
                    for i, _f in out:
                        g["pending"][i] = (consumer, now)
                    return out
                if block_ms is None or time.time() >= deadline:
                    return out
                self._cv.wait(min(deadline - time.time(), 0.05))

    def xack(self, stream: str, group: str, *ids) -> int:
        with self._lock:
            g = self._groups.get((stream, group))
            if g is None:
                return 0
            n = 0
            for i in ids:
                n += g["pending"].pop(i, None) is not None
            return n

    def xautoclaim(self, stream: str, group: str, consumer: str,
                   min_idle_ms: int, count: int = 64):
        with self._lock:
            g = self._groups.get((stream, group))
            if g is None:
                return []
            now = time.time()
            stale = [i for i, (_c, ts) in g["pending"].items()
                     if (now - ts) * 1000.0 >= min_idle_ms][:count]
            if not stale:
                return []
            by_id = dict(self._streams.get(stream, []))
            out = []
            for i in stale:
                g["pending"][i] = (consumer, now)
                if i in by_id:
                    out.append((i, by_id[i]))
                else:           # trimmed away — drop from pending
                    g["pending"].pop(i, None)
            return out

    def xlen(self, stream: str) -> int:
        with self._lock:
            return len(self._streams.get(stream, []))

    def group_info(self, stream: str):
        """Per-group bookkeeping snapshot for ``stream``:
        ``[(group, lag, pending, last_delivered_id), ...]`` where lag
        counts entries never delivered past the group cursor — the
        ONE computation behind both ``xlag`` and the TCP broker's
        ``XINFO GROUPS`` answer, so the embedded and wire paths can
        never report different backlogs."""
        with self._lock:
            entries = self._streams.get(stream, [])
            out = []
            for (s, group), g in self._groups.items():
                if s != stream:
                    continue
                lag = sum(1 for i, _f in entries
                          if _id_gt(i, g["delivered"]))
                out.append((group, lag, len(g["pending"]),
                            g["delivered"]))
            return out

    def xlag(self, stream: str, group: str) -> int:
        """Undelivered entries past the group cursor + unacked
        pending (see RedisClient.xlag); stream length when the group
        does not exist yet."""
        for name, lag, pending, _delivered in self.group_info(stream):
            if name == group:
                return lag + pending
        return self.xlen(stream)

    def xtrim(self, stream: str, maxlen: int) -> int:
        with self._lock:
            s = self._streams.get(stream, [])
            drop = max(len(s) - maxlen, 0)
            self._streams[stream] = s[drop:]
            return drop

    def xdel(self, stream: str, *ids) -> int:
        with self._lock:
            s = self._streams.get(stream, [])
            keep = [(i, f) for i, f in s if i not in ids]
            self._streams[stream] = keep
            return len(s) - len(keep)

    def hset(self, key: str, fields: Dict[str, Any]) -> int:
        with self._lock:
            self._hashes.setdefault(key, {}).update(
                {k: (v.encode() if isinstance(v, str) else v)
                 for k, v in fields.items()})
            return len(fields)

    def hgetall(self, key: str) -> Dict[str, Any]:
        with self._lock:
            return dict(self._hashes.get(key, {}))

    def hdel(self, key: str, *fields) -> int:
        with self._lock:
            h = self._hashes.get(key, {})
            n = 0
            for f in fields:
                n += h.pop(f, None) is not None
            return n

    def delete(self, *keys) -> int:
        with self._lock:
            n = 0
            for k in keys:
                n += self._hashes.pop(k, None) is not None
                n += self._streams.pop(k, None) is not None
            return n

    def close(self):
        pass

    def shutdown(self) -> None:
        """In-process broker: clear all state (the redis-server
        shutdown analogue)."""
        with self._lock:
            self._streams.clear()
            self._hashes.clear()


def _id_gt(a: str, b: str) -> bool:
    def parse(x):
        ms, _, seq = x.partition("-")
        # zoolint: disable=SYNC002 — stream ids are host strings
        return (int(ms), int(seq or 0))
    return parse(a) > parse(b)


# ----------------------------------------------------------- TCP broker
def _enc_simple(s: str) -> bytes:
    return b"+%s\r\n" % s.encode()


def _enc_err(s: str) -> bytes:
    return b"-%s\r\n" % s.encode()


def _enc_int(i: int) -> bytes:
    return b":%d\r\n" % int(i)


def _enc_bulk(v) -> bytes:
    if v is None:
        return b"$-1\r\n"
    if isinstance(v, str):
        v = v.encode()
    return b"$%d\r\n%s\r\n" % (len(v), v)


def _enc_array(items) -> bytes:
    if items is None:
        return b"*-1\r\n"
    return b"*%d\r\n" % len(items) + b"".join(items)


def _enc_entries(entries) -> bytes:
    """[(id, {k: bytes})] -> RESP [[id, [k, v, ...]], ...]"""
    out = []
    for entry_id, fields in entries:
        kvs = []
        for k, v in fields.items():
            kvs.append(_enc_bulk(k))
            kvs.append(_enc_bulk(v))
        out.append(_enc_array([_enc_bulk(entry_id), _enc_array(kvs)]))
    return _enc_array(out)


class BrokerServer:
    """TCP RESP front-end over an ``EmbeddedBroker`` — a single-node
    "real" broker, so the socket ``RedisClient`` serves against an
    actual wire protocol (and single-host deployments run without a
    Redis install).  Speaks exactly the command subset the serving
    stack uses; one thread per connection (blocking XREADs park their
    own connection only)."""

    def __init__(self, broker: Optional[EmbeddedBroker] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.broker = broker if broker is not None else EmbeddedBroker()
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()[:2]
        self._stop = threading.Event()
        # accept loop adds, per-conn threads discard, stop() snapshots:
        # three threads on one set, so every touch holds the lock
        self._conns_lock = threading.Lock()
        self._conns: set = set()
        self._accept = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._accept.start()

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._srv.accept()
            except OSError:
                return
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        reader = _RespReader(conn.recv)
        try:
            while not self._stop.is_set():
                line = reader.line()
                if not line.startswith(b"*"):
                    conn.sendall(_enc_err("ERR protocol"))
                    continue
                n = int(line[1:])
                args = []
                for _ in range(n):
                    lens = reader.line()
                    assert lens.startswith(b"$"), lens
                    args.append(reader.exact(int(lens[1:])))
                if not args:
                    continue
                cmd = args[0].decode().upper()
                if cmd == "SHUTDOWN":
                    self.broker.shutdown()
                    conn.close()       # connection drop = success signal
                    self.stop()
                    return
                try:
                    conn.sendall(self._dispatch(cmd, args[1:]))
                except ConnectionError:
                    raise
                except Exception as e:   # command error -> RESP error
                    conn.sendall(_enc_err(f"ERR {e}"))
        except (ConnectionError, OSError):
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, cmd: str, a: List[bytes]) -> bytes:
        b = self.broker
        dec = lambda x: x.decode()
        if cmd == "PING":
            return _enc_simple("PONG")
        if cmd == "INFO":
            return _enc_bulk("# Server\r\nembedded_broker:1\r\n")
        if cmd == "XADD":
            fields = {dec(a[i]): a[i + 1] for i in range(2, len(a), 2)}
            return _enc_bulk(b.xadd(dec(a[0]), fields))
        if cmd == "XREAD":
            opts = self._stream_opts(a)
            entries = b.xread(opts["stream"], opts["id"],
                              count=opts["count"],
                              block_ms=opts["block"])
            if not entries:
                return _enc_array(None)
            return _enc_array([_enc_array(
                [_enc_bulk(opts["stream"]), _enc_entries(entries)])])
        if cmd == "XREADGROUP":
            group, consumer = dec(a[1]), dec(a[2])
            opts = self._stream_opts(a[3:])
            entries = b.xreadgroup(group, consumer, opts["stream"],
                                   count=opts["count"],
                                   block_ms=opts["block"])
            if not entries:
                return _enc_array(None)
            return _enc_array([_enc_array(
                [_enc_bulk(opts["stream"]), _enc_entries(entries)])])
        if cmd == "XGROUP":
            if dec(a[0]).upper() != "CREATE":
                return _enc_err("ERR unsupported XGROUP subcommand")
            # embedded create is idempotent, so no BUSYGROUP ever; a
            # real failure (bad start id) must surface as ERR — the
            # client deliberately swallows BUSYGROUP only
            b.xgroup_create(dec(a[1]), dec(a[2]), dec(a[3]))
            return _enc_simple("OK")
        if cmd == "XACK":
            return _enc_int(b.xack(dec(a[0]), dec(a[1]),
                                   *[dec(i) for i in a[2:]]))
        if cmd == "XAUTOCLAIM":
            # stream group consumer min-idle start [COUNT n]
            count = 64
            if len(a) >= 7 and dec(a[5]).upper() == "COUNT":
                count = int(a[6])
            entries = b.xautoclaim(dec(a[0]), dec(a[1]), dec(a[2]),
                                   int(a[3]), count=count)
            return _enc_array([_enc_bulk("0-0"), _enc_entries(entries),
                               _enc_array([])])
        if cmd == "XLEN":
            return _enc_int(b.xlen(dec(a[0])))
        if cmd == "XINFO":
            if dec(a[0]).upper() != "GROUPS":
                return _enc_err("ERR unsupported XINFO subcommand")
            out = []
            for group, lag, pending, delivered in \
                    b.group_info(dec(a[1])):
                out.append(_enc_array([
                    _enc_bulk("name"), _enc_bulk(group),
                    _enc_bulk("consumers"), _enc_int(0),
                    _enc_bulk("pending"), _enc_int(pending),
                    _enc_bulk("last-delivered-id"),
                    _enc_bulk(delivered),
                    _enc_bulk("lag"), _enc_int(lag),
                ]))
            return _enc_array(out)
        if cmd == "XTRIM":
            return _enc_int(b.xtrim(dec(a[0]), int(a[2])))
        if cmd == "XDEL":
            return _enc_int(b.xdel(dec(a[0]), *[dec(i) for i in a[1:]]))
        if cmd == "HSET":
            fields = {dec(a[i]): a[i + 1] for i in range(1, len(a), 2)}
            return _enc_int(b.hset(dec(a[0]), fields))
        if cmd == "HGETALL":
            flat = []
            for k, v in b.hgetall(dec(a[0])).items():
                flat.append(_enc_bulk(k))
                flat.append(_enc_bulk(v))
            return _enc_array(flat)
        if cmd == "HDEL":
            return _enc_int(b.hdel(dec(a[0]), *[dec(f) for f in a[1:]]))
        if cmd == "DEL":
            return _enc_int(b.delete(*[dec(k) for k in a]))
        return _enc_err(f"ERR unknown command '{cmd}'")

    @staticmethod
    def _stream_opts(a: List[bytes]) -> Dict[str, Any]:
        """Parse [COUNT n] [BLOCK ms] STREAMS stream id."""
        out: Dict[str, Any] = {"count": 64, "block": None}
        i = 0
        while i < len(a):
            word = a[i].decode().upper()
            if word == "COUNT":
                out["count"] = int(a[i + 1])
                i += 2
            elif word == "BLOCK":
                out["block"] = int(a[i + 1])
                i += 2
            elif word == "STREAMS":
                out["stream"] = a[i + 1].decode()
                out["id"] = a[i + 2].decode()
                i += 3
            else:
                i += 1
        return out

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._conns_lock:        # copy: serve threads discard
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass


def connect(url: Optional[str] = None):
    """'host:port' → RedisClient; None/'embedded' → EmbeddedBroker."""
    if url in (None, "embedded"):
        return EmbeddedBroker()
    host, _, port = url.partition(":")
    return RedisClient(host or "localhost", int(port or 6379))


# ------------------------------------------------------ circuit breaker
class CircuitOpenError(ConnectionError):
    """Fast-fail: the breaker is open — no broker IO was attempted."""


#: the exception classes the breaker counts as broker failures:
#: socket/transport trouble (ConnectionError and TimeoutError are both
#: OSError subclasses) plus injected chaos faults.  Redis COMMAND
#: errors (NOGROUP, WRONGTYPE, …) are application bugs, not outages —
#: they raise RuntimeError and pass through uncounted.
def _breaker_failure_excs():
    from analytics_zoo_torch.resilience.chaos import InjectedFault
    return (OSError, InjectedFault)


BREAKER_CLOSED, BREAKER_HALF_OPEN, BREAKER_OPEN = 0, 1, 2
_BREAKER_STATE_NAMES = {BREAKER_CLOSED: "closed",
                        BREAKER_HALF_OPEN: "half_open",
                        BREAKER_OPEN: "open"}


def _note_breaker_transition(frm: int, to: int, **detail) -> None:
    """Report a breaker state change to the flight recorder — the
    primary forensic signal of a broker outage (zoo-doctor's
    ``broker_outage`` rule).  Never raises; called OUTSIDE the
    breaker's lock."""
    try:
        from analytics_zoo_torch.observability.flightrec import \
            record_event
        record_event("breaker.transition",
                     frm=_BREAKER_STATE_NAMES[frm],
                     to=_BREAKER_STATE_NAMES[to], **detail)
    except Exception:   # noqa: BLE001 — forensics must not break IO
        pass


class CircuitBreaker:
    """k-consecutive-failures → open → cooldown → half-open probe.

    Closed: every call allowed; ``failures`` consecutive recorded
    failures open it.  Open: every call fast-fails for ``cooldown_s``.
    Half-open: exactly ONE probe call is allowed through; its success
    closes the breaker, its failure re-opens (fresh cooldown).  All
    transitions happen under one lock that is never held across IO —
    the caller does the blocking call *outside* and reports back."""

    def __init__(self, failures: int = 5, cooldown_s: float = 2.0,
                 clock=time.monotonic):
        self.failures = max(int(failures), 1)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._consecutive = 0
        self._state = BREAKER_CLOSED
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a call be attempted right now?  (Claims the half-open
        probe slot when it grants one during cooldown recovery.)"""
        trans = None
        with self._lock:
            if self._state == BREAKER_CLOSED:
                return True
            if self._state == BREAKER_OPEN and \
                    self._clock() - self._opened_at >= self.cooldown_s:
                self._state = BREAKER_HALF_OPEN
                trans = (BREAKER_OPEN, BREAKER_HALF_OPEN)
            allowed = self._state == BREAKER_HALF_OPEN \
                and not self._probing
            if allowed:
                self._probing = True
        if trans is not None:
            _note_breaker_transition(*trans)
        return allowed

    def record_success(self) -> None:
        with self._lock:
            trans = (self._state, BREAKER_CLOSED) \
                if self._state != BREAKER_CLOSED else None
            self._consecutive = 0
            self._probing = False
            self._state = BREAKER_CLOSED
        if trans is not None:
            _note_breaker_transition(*trans)

    def record_failure(self) -> None:
        trans = None
        with self._lock:
            self._consecutive += 1
            self._probing = False
            if self._state == BREAKER_HALF_OPEN or \
                    self._consecutive >= self.failures:
                if self._state != BREAKER_OPEN:
                    trans = (self._state, BREAKER_OPEN,
                             self._consecutive)
                self._state = BREAKER_OPEN
                self._opened_at = self._clock()
        if trans is not None:
            _note_breaker_transition(trans[0], trans[1],
                                     failures=trans[2])


class BreakerClient:
    """Circuit breaker around a broker connection.

    Every delegated op goes through :meth:`_call`: breaker-open →
    :class:`CircuitOpenError` with **no** socket IO (a broker outage
    degrades to fast-fail instead of a per-op connect-timeout
    crash-loop); a transport failure (see ``_breaker_failure_excs``)
    is counted AND drops the underlying connection, so the half-open
    probe reconnects through ``factory`` instead of reusing a dead
    socket.  Exposes the breaker state as the ``serving_breaker_state``
    gauge (0 closed / 1 half-open / 2 open).

    The chaos site ``serving.redis`` fires here, between the breaker
    gate and the real op — step = attempted ops since the active plan
    was installed (each new plan sees steps 0, 1, 2, …), so a scripted
    outage is "the next k ops fail" regardless of how many ops ran
    before the test armed it.

    Like the raw clients, a ``BreakerClient`` is NOT thread-safe for
    concurrent ops (serving keeps all broker IO on one thread); the
    breaker's own state is locked so `/healthz` threads may read
    ``breaker.state`` concurrently."""

    def __init__(self, factory, failures: int = 5,
                 cooldown_s: float = 2.0, conn=None,
                 clock=time.monotonic):
        self._factory = factory
        self._conn = conn
        self.breaker = CircuitBreaker(failures, cooldown_s, clock)
        # attempted ops while a chaos plan is armed; reset per plan so
        # FaultSpec(at_step=0, times=k) means "the next k ops"
        self._chaos_step = 0
        self._chaos_plan = None
        try:
            from analytics_zoo_torch.observability import get_registry
            self._gauge = get_registry().gauge(
                "serving_breaker_state",
                "redis circuit breaker: 0 closed, 1 half-open, 2 open")
            self._gauge.set(BREAKER_CLOSED)
        except Exception:   # pragma: no cover — registry unavailable
            self._gauge = None

    # ------------------------------------------------------------ plumbing
    def _set_gauge(self) -> None:
        if self._gauge is not None:
            self._gauge.set(self.breaker.state)

    def _drop_conn(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            try:
                conn.close()
            except Exception:   # noqa: BLE001 — already broken
                pass

    def _trip_chaos(self) -> None:
        from analytics_zoo_torch.resilience.chaos import (
            SITE_SERVING_REDIS, active_chaos)
        plan = active_chaos()
        if plan is None:
            self._chaos_plan = None
            return
        if plan is not self._chaos_plan:
            self._chaos_plan = plan
            self._chaos_step = 0
        step = self._chaos_step
        self._chaos_step += 1
        plan.trip(SITE_SERVING_REDIS, step)

    def _call(self, name: str, *args, **kwargs):
        if not self.breaker.allow():
            self._set_gauge()
            raise CircuitOpenError(
                f"redis breaker open: {name} not attempted")
        try:
            self._trip_chaos()
            if self._conn is None:
                self._conn = self._factory()
            out = getattr(self._conn, name)(*args, **kwargs)
        except _breaker_failure_excs():
            self.breaker.record_failure()
            self._drop_conn()
            self._set_gauge()
            raise
        except Exception:
            # a redis COMMAND error (NOGROUP, WRONGTYPE, …) means the
            # broker answered — the transport is healthy.  Recording
            # success matters beyond bookkeeping: it releases a
            # half-open probe slot; leaking it would wedge the breaker
            # HALF_OPEN forever (every later op fast-failing) while
            # readiness, which only checks BREAKER_OPEN, reads ready.
            self.breaker.record_success()
            self._set_gauge()
            raise
        self.breaker.record_success()
        self._set_gauge()
        return out

    def __getattr__(self, name: str):
        # delegate the whole broker command surface through the breaker
        if name.startswith("_"):
            raise AttributeError(name)

        def call(*args, **kwargs):
            return self._call(name, *args, **kwargs)
        call.__name__ = name
        return call

    def close(self) -> None:
        """Release the underlying connection (never breaker-gated)."""
        self._drop_conn()


def with_breaker(url: Optional[str] = None, broker=None,
                 failures: int = 5, cooldown_s: float = 2.0):
    """Wrap a broker in a :class:`BreakerClient`.

    ``url`` given → connects lazily and RE-connects after transport
    failures; ``broker`` given (embedded/test double) → the "reconnect"
    returns the same instance — as does an embedded ``url`` (None /
    'embedded'): an in-process broker IS the state, so a "reconnect"
    must never swap in a fresh empty one.  ``failures <= 0`` disables
    the breaker and returns the raw broker unchanged."""
    if broker is None and url in (None, "embedded"):
        broker = connect(url)
    if failures <= 0:
        return broker if broker is not None else connect(url)
    if broker is not None:
        return BreakerClient(lambda: broker, failures, cooldown_s,
                             conn=broker)
    return BreakerClient(lambda: connect(url), failures, cooldown_s)
