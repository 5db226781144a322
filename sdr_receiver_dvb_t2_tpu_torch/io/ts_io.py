"""Transport-stream sinks: UDP datagrams (VLC-compatible, the reference's
default out -- bb_de_header.cpp:436-443, `vlc udp://@:7654`) and files."""
from __future__ import annotations

import socket
from urllib.parse import urlparse

import numpy as np

TS_PACKET = 188
UDP_PACKETS_PER_DATAGRAM = 7  # 1316 bytes, standard for TS over UDP


class UDPSink:
    def __init__(self, host: str = "127.0.0.1", port: int = 7654):
        self.addr = (host, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._buf = bytearray()

    def write(self, ts_bytes: np.ndarray | bytes) -> None:
        self._buf += bytes(ts_bytes)
        chunk = UDP_PACKETS_PER_DATAGRAM * TS_PACKET
        while len(self._buf) >= chunk:
            self.sock.sendto(bytes(self._buf[:chunk]), self.addr)
            del self._buf[:chunk]

    def flush(self) -> None:
        if self._buf:
            self.sock.sendto(bytes(self._buf), self.addr)
            self._buf.clear()

    def close(self) -> None:
        self.flush()
        self.sock.close()


class FileSink:
    def __init__(self, path: str):
        self.f = open(path, "wb")

    def write(self, ts_bytes) -> None:
        self.f.write(bytes(ts_bytes))

    def flush(self) -> None:
        self.f.flush()

    def close(self) -> None:
        self.f.close()


def open_sink(url: str):
    """'udp://host:port' | 'udp:port' | plain path -> sink object."""
    if url.startswith("udp:"):
        u = urlparse(url if "//" in url else "udp://127.0.0.1:" + url[4:])
        return UDPSink(u.hostname or "127.0.0.1", u.port or 7654)
    return FileSink(url)
