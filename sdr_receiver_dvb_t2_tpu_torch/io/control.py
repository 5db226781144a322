"""Runtime control channel for the streaming receiver: switch the TS sink
and the PLP selection of a RUNNING receiver without losing lock.

Reference parity: the reference changes TS output (UDP port / file) and the
PLP filter live, mid-reception, via a `set_out` signal crossing the thread
chain into the de-headerer (bb_de_header.cpp:500-525, wired from the GUI at
main_window.cpp:547-565).  Here the same control plane is a line-oriented
TCP socket (the framework is headless), polled by the streaming loop
between blocks:

  PLP <id>|ALL        select which PLP's BB frames feed the TS output
  OUT <path>          switch the TS sink to (re)open a file
  UDP <host:port>     switch the TS sink to UDP datagrams (188*7 chunks)
  STATUS              one JSON line of live stats
  STOP                end the run gracefully

Replies are "OK ..." / "ERR ..." lines.  Commands apply at the next block
boundary — the lock (frame grid, CFO/SCO state, L1) is untouched, so
switching never drops samples; the TS assembler's SYNCD logic carries each
PLP stream's packet continuity exactly as it does across any other frame.
"""
from __future__ import annotations

import json
import socket
import threading


class SwitchableSink:
    """TS byte sink whose target can be swapped mid-stream (file or UDP).

    Callable: `sink(arr)` writes the bytes to the current target.  The
    reference's equivalent keeps one QUdpSocket / QFile open at a time
    (bb_de_header.cpp:436-443); chunking UDP payloads at 7 packets
    matches its datagram framing."""

    def __init__(self, path: str | None = None,
                 udp: tuple[str, int] | None = None):
        self._lock = threading.Lock()
        self._file = None
        self._sock = None
        self._udp = None
        if path is not None:
            self.set_file(path)
        elif udp is not None:
            self.set_udp(*udp)

    def set_file(self, path: str) -> None:
        with self._lock:
            # open FIRST: an unwritable path must not tear down the
            # currently-working sink (the client already saw "OK" at
            # queue time; the stream must keep flowing to the old target)
            f = open(path, "wb")
            self._close_locked()
            self._file = f

    def set_udp(self, host: str, port: int) -> None:
        with self._lock:
            self._close_locked()
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._udp = (host, port)

    def _close_locked(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._sock is not None:
            self._sock.close()
            self._sock = None
        self._udp = None

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def __call__(self, arr) -> None:
        with self._lock:
            if self._file is not None:
                self._file.write(bytes(memoryview(arr)))
                self._file.flush()
            elif self._sock is not None:
                b = bytes(memoryview(arr))
                step = 188 * 7
                for i in range(0, len(b), step):
                    self._sock.sendto(b[i:i + step], self._udp)


class ControlServer:
    """TCP control endpoint; pass as `control=` to StreamingReceiver.run.

    The accept/read loop runs on a daemon thread; commands queue and the
    streaming loop applies them between blocks via `poll` (the queued-
    signal hop of the reference's set_out path).  STATUS replies
    immediately from the latest snapshot the loop published."""

    def __init__(self, sink: SwitchableSink, port: int = 0,
                 host: str = "127.0.0.1"):
        self.sink = sink
        self._pending: list[tuple[str, str]] = []
        self._lock = threading.Lock()
        self._status: dict = {}
        self._last_error: str | None = None
        self.stop_requested = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(2)
        self.port = self._srv.getsockname()[1]
        self._done = False
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    # -- server thread ------------------------------------------------------
    def _serve(self) -> None:
        while not self._done:
            try:
                self._srv.settimeout(0.2)
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with conn:
                conn.settimeout(10.0)
                buf = b""
                try:
                    while not self._done:
                        chunk = conn.recv(4096)
                        if not chunk:
                            break
                        buf += chunk
                        while b"\n" in buf:
                            line, buf = buf.split(b"\n", 1)
                            reply = self._handle(line.decode().strip())
                            conn.sendall(reply.encode() + b"\n")
                except (socket.timeout, OSError):
                    pass

    def _handle(self, line: str) -> str:
        if not line:
            return "ERR empty"
        op, _, arg = line.partition(" ")
        op = op.upper()
        if op == "STATUS":
            with self._lock:
                return json.dumps(self._status)
        if op == "STOP":
            self.stop_requested = True
            return "OK stopping"
        if op == "PLP":
            a = arg.strip().upper()
            if a != "ALL":
                try:
                    int(a)
                except ValueError:
                    return f"ERR bad PLP {arg!r}"
            with self._lock:
                self._pending.append(("plp", a))
            return f"OK plp {a}"
        if op == "OUT":
            if not arg.strip():
                return "ERR OUT needs a path"
            with self._lock:
                self._pending.append(("out", arg.strip()))
            return f"OK out {arg.strip()}"
        if op == "UDP":
            host, _, port = arg.strip().rpartition(":")
            try:
                int(port)
            except ValueError:
                return f"ERR bad UDP target {arg!r}"
            with self._lock:
                self._pending.append(("udp", arg.strip()))
            return f"OK udp {arg.strip()}"
        return f"ERR unknown command {op}"

    # -- streaming-loop side -------------------------------------------------
    def poll(self, receiver, flush_ts) -> bool:
        """Apply queued commands; called between blocks by the streaming
        loop.  `flush_ts()` drains decoded packets to the CURRENT sink
        before a sink swap, so a switch never re-routes bytes that belong
        to the old target.  Returns True when a STOP was requested."""
        with self._lock:
            cmds, self._pending = self._pending, []
        for op, arg in cmds:
            try:
                if op == "plp":
                    if getattr(receiver, "regen_sink", None) is not None:
                        # same invariant as the cli startup guard: a
                        # regenerated feed advertises a full multiplex, so
                        # a mid-run PLP filter would silently starve it
                        raise ValueError(
                            "PLP filter rejected: regen sink attached "
                            "(a regenerated multiplex needs every PLP)")
                    receiver.plp_filter = None if arg == "ALL" else int(arg)
                elif op == "out":
                    flush_ts()
                    self.sink.set_file(arg)
                elif op == "udp":
                    flush_ts()
                    host, _, port = arg.rpartition(":")
                    self.sink.set_udp(host or "127.0.0.1", int(port))
                # a successful apply clears the sticky error, so STATUS
                # stops reporting a failure that has since been corrected
                with self._lock:
                    self._last_error = None
            except (OSError, ValueError) as e:
                # a bad target must not crash the running receiver (the
                # previous sink stays attached — set_file opens before it
                # closes); surface the failure in the next STATUS snapshot
                with self._lock:
                    self._last_error = f"{op} {arg}: {e}"
        return self.stop_requested

    def publish(self, status: dict) -> None:
        with self._lock:
            self._status = dict(status)
            if self._last_error is not None:
                self._status["control_error"] = self._last_error

    def close(self) -> None:
        self._done = True
        try:
            self._srv.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)
