"""Network IQ ingest: stream int16 I/Q over TCP with an in-band control
channel for the retune/AGC feedback loop.

This is the TPU-native answer to the reference's PlutoSDR front end
(`reference/src/rx_plutosdr.cpp`, `libplutosdr/plutosdr_hi_speed_rx.c`):
there the radio hangs off the receiver host's USB bus and a custom kernel
module streams int16 blocks; a TPU host has no USB radio, so the radio-side
daemon (`IQStreamServer`, wrapping any `SDRDevice` — on a real deployment the
Pluto/airspy vendor read loop) ships the same int16 blocks over the network
and the receive host runs `NetworkDevice`.  Hardware feedback
(`SignalEstimate`: retune, gain steps, reset — dvbt2_demodulator.h:42-52)
travels upstream on the same socket, so the closed loops the streaming
receiver runs (AGC, LO centering) actuate the remote radio exactly like the
reference's device thread actuates mir_sdr/libairspy
(rx_sdrplay.cpp:158-197).

Wire protocol (deliberately minimal, one socket):
  server -> client: a 16-byte header (b"T2IQ" magic + version + float64
                    native sample rate, so the client's rate conversion
                    engages for 9.2/10 Msps vendor front ends), then
                    interleaved int16 I,Q pairs, little-endian, full-scale
                    `SCALE` (Pluto's 12-bit ADC convention)
  client -> server: ASCII command lines  b"TUNE <abs_hz>\n" (absolute
                    center frequency) | b"FREQ <offset_hz>\n" (relative
                    retune step) | b"GAIN <db>\n" | b"RESET\n"
The int16 -> complex64 conversion uses the native AVX2 kernel when built
(native/ingest.cpp, the reference's iqconverter_int16 equivalent).
"""
from __future__ import annotations

import socket
import threading

import numpy as np

from ..dvbt2.params import SAMPLE_RATE
from .devices import SDRDevice, SignalEstimate

SCALE = 2048.0          # 12-bit ADC full scale (Pluto convention)
_BYTES_PER_SAMPLE = 4   # int16 I + int16 Q
# stream header sent by the server on connect: magic + version + pad +
# float64 sample rate (Hz).  Lets the client run its rate conversion for
# vendor front ends whose native rate differs from the elementary rate
# (sdrplay 9.2 Msps, airspy 10 Msps); a header-less legacy stream is
# detected by the magic and treated as elementary-rate raw samples.
_HDR_MAGIC = b"T2IQ"
_HDR_LEN = 16


def _pack_header(rate_hz: float) -> bytes:
    import struct
    return _HDR_MAGIC + struct.pack("<HH", 1, 0) + struct.pack(
        "<d", float(rate_hz))


class NetworkDevice(SDRDevice):
    """TCP client front end: connects to an `IQStreamServer` (or any daemon
    speaking the protocol above) and exposes the standard SDRDevice
    interface to `StreamingReceiver`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 47392,
                 sample_rate: float = SAMPLE_RATE, timeout: float = 10.0,
                 max_stall: float | None = None):
        self.host, self.port = host, port
        self.sample_rate = sample_rate
        self.timeout = timeout
        # total silent time tolerated before read_block raises; a single
        # recv timeout is a transient stall, not EOF
        self.max_stall = 3.0 * timeout if max_stall is None else max_stall
        self._sock: socket.socket | None = None
        self._rem = b""   # non-sample-aligned remainder of the last recv

    @classmethod
    def from_url(cls, url: str, **kw) -> "NetworkDevice":
        """tcp://host:port"""
        if not url.startswith("tcp://"):
            raise ValueError(f"expected tcp://host:port, got {url}")
        host, _, port = url[6:].rpartition(":")
        return cls(host=host or "127.0.0.1", port=int(port), **kw)

    def init(self, frequency_hz: float, gain_db: float = 0.0) -> None:
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=self.timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._read_header()
        # absolute tune and relative retune are distinct commands: FREQ is
        # a retune OFFSET (SignalEstimate.coarse_freq_offset semantics);
        # the initial center frequency goes out as TUNE <hz>
        if frequency_hz:
            self._send(f"TUNE {frequency_hz!r}\n")
        if gain_db:
            self._send(f"GAIN {gain_db!r}\n")

    def _read_header(self) -> None:
        """Parse the server's rate announcement; a stream without one
        (legacy/foreign daemon) is raw samples at the constructed rate."""
        import struct
        buf = b""
        while len(buf) < _HDR_LEN:
            try:
                b = self._sock.recv(_HDR_LEN - len(buf))
            except (socket.timeout, OSError):
                break
            if not b:
                break
            buf += b
        if len(buf) >= _HDR_LEN and buf[:4] == _HDR_MAGIC:
            (rate,) = struct.unpack("<d", buf[8:16])
            if rate > 0:
                self.sample_rate = float(rate)
        else:
            # not a header: those bytes are samples
            self._rem = buf

    def _send(self, line: str) -> None:
        if self._sock is not None:
            try:
                self._sock.sendall(line.encode())
            except OSError:
                pass

    def read_block(self, n: int) -> np.ndarray | None:
        """Read up to n samples (blocking); None on server EOF.

        A recv timeout is a transient stall, NOT end-of-stream: it is
        retried until `max_stall` seconds pass with zero bytes, then
        raises TimeoutError (so the caller can distinguish a dead link
        from a finished capture).  Bytes that do not fill a whole int16
        I/Q pair are buffered for the next call — dropping them would
        byte-shift every subsequent sample and permanently corrupt the
        I/Q framing."""
        if self._sock is None:
            return None
        need = n * _BYTES_PER_SAMPLE - len(self._rem)
        chunks = [self._rem]
        stalled = 0.0
        eof = False
        while need > 0:
            try:
                b = self._sock.recv(need)
            except socket.timeout:
                if len(chunks) > 1:
                    break          # partial block: deliver what arrived
                # NB a leftover sub-sample remainder alone is NOT progress:
                # breaking on it would return empty blocks forever on a
                # stalled link and the max_stall deadline would never fire
                stalled += self.timeout
                if stalled >= self.max_stall:
                    raise TimeoutError(
                        f"no samples from {self.host}:{self.port} for "
                        f"{stalled:.0f}s (link stalled, not EOF)")
                continue
            except OSError:
                eof = True
                break
            if not b:
                eof = True
                break
            chunks.append(b)
            need -= len(b)
            stalled = 0.0
        raw = b"".join(chunks)
        got = len(raw) // _BYTES_PER_SAMPLE
        self._rem = raw[got * _BYTES_PER_SAMPLE:]
        if got == 0:
            return None if eof else np.zeros(0, np.complex64)
        iq = np.frombuffer(raw[:got * _BYTES_PER_SAMPLE], dtype="<i2")
        from .. import native
        return native.int16_to_complex(iq, scale=1.0 / SCALE)

    def apply(self, est: SignalEstimate) -> None:
        if est.change_frequency:
            self._send(f"FREQ {est.coarse_freq_offset!r}\n")
        if est.change_gain:
            self._send(f"GAIN {est.gain_offset!r}\n")
        if est.reset:
            self._send("RESET\n")

    def stop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None


class IQStreamServer:
    """Radio-side daemon: serves one `SDRDevice`'s sample stream to one
    client and applies the client's FREQ/GAIN/RESET commands to the device
    between blocks — the role the reference's device thread plays
    (rx_sdrplay.cpp:199-291), moved to the machine that owns the radio.

    Runs in a background thread; `port` is bound immediately (port=0 picks
    a free one) so tests can connect right after construction."""

    def __init__(self, device: SDRDevice, host: str = "127.0.0.1",
                 port: int = 0, block: int = 65536):
        self.device = device
        self.block = block
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(1)
        self.port = self._lsock.getsockname()[1]
        self._stop = threading.Event()
        self._abs_freq: float | None = None   # last TUNE'd center frequency
        self.commands: list[str] = []
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _apply_commands(self, buf: bytes) -> bytes:
        *lines, rest = buf.split(b"\n")
        for ln in lines:
            parts = ln.decode(errors="replace").split()
            if not parts:
                continue
            self.commands.append(ln.decode(errors="replace"))
            est = SignalEstimate()
            if parts[0] == "TUNE" and len(parts) == 2:
                # absolute center frequency: prefer the device's native
                # tune(); otherwise treat subsequent TUNEs as deltas
                # against the last absolute frequency (first TUNE only
                # records the baseline — the radio is assumed centered
                # there by whoever constructed/init'ed it)
                hz = float(parts[1])
                tune = getattr(self.device, "tune", None)
                if callable(tune):
                    tune(hz)
                elif self._abs_freq is not None and hz != self._abs_freq:
                    est.coarse_freq_offset = hz - self._abs_freq
                    est.change_frequency = True
                    self.device.apply(est)
                self._abs_freq = hz
                continue
            if parts[0] == "FREQ" and len(parts) == 2:
                est.coarse_freq_offset = float(parts[1])
                est.change_frequency = True
                if self._abs_freq is not None:
                    self._abs_freq += est.coarse_freq_offset
            elif parts[0] == "GAIN" and len(parts) == 2:
                est.gain_offset = float(parts[1])
                est.change_gain = True
            elif parts[0] == "RESET":
                est.reset = True
            else:
                continue
            self.device.apply(est)
        return rest

    def _serve(self) -> None:
        """Accept clients until close(): one client at a time, re-accept
        after a disconnect (daemon semantics); device EOF (capture
        exhausted) ends the serve loop entirely."""
        self._lsock.settimeout(0.2)
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = self._lsock.accept()
                except socket.timeout:
                    continue
                if self._serve_client(conn):
                    return      # device stream ended
        finally:
            self._lsock.close()

    def _serve_client(self, conn) -> bool:
        """Serve one client; True when the DEVICE ended (EOF), False when
        the client disconnected (caller re-accepts)."""
        device_eof = False
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # announce the device's native rate so the client's rate
            # conversion engages for vendor front ends
            try:
                conn.sendall(_pack_header(self.device.sample_rate))
            except OSError:
                return False
            self.device.start()
            cmdbuf = b""
            import select
            while not self._stop.is_set():
                # poll for commands without stalling the sample stream
                # (sends stay blocking so TCP backpressure paces the radio)
                try:
                    readable, _, _ = select.select([conn], [], [], 0)
                    if readable:
                        data = conn.recv(4096)
                        if data:
                            cmdbuf = self._apply_commands(cmdbuf + data)
                        else:
                            break   # client closed
                except OSError:
                    break
                blk = self.device.read_block(self.block)
                if blk is None:
                    device_eof = True
                    # capture exhausted: half-close so the client sees EOF,
                    # but keep applying late feedback (a retune decided
                    # after the last block still reaches the radio)
                    try:
                        conn.shutdown(socket.SHUT_WR)
                    except OSError:
                        pass
                    conn.settimeout(0.2)
                    while not self._stop.is_set():
                        try:
                            data = conn.recv(4096)
                        except socket.timeout:
                            continue
                        except OSError:
                            break
                        if not data:
                            break
                        cmdbuf = self._apply_commands(cmdbuf + data)
                    break
                i16 = np.empty(2 * len(blk), dtype="<i2")
                re = np.clip(np.round(np.real(blk) * SCALE), -32768, 32767)
                im = np.clip(np.round(np.imag(blk) * SCALE), -32768, 32767)
                i16[0::2] = re.astype(np.int16)
                i16[1::2] = im.astype(np.int16)
                try:
                    conn.sendall(i16.tobytes())
                except OSError:
                    break
        finally:
            try:
                conn.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            conn.close()
        return device_eof or self._stop.is_set()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=3.0)

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the serve loop ends (device stream exhausted or
        close()); a client disconnect does NOT end it — the daemon
        re-accepts.  True when it ended within `timeout`."""
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()


def main(argv=None) -> int:
    """`t2radio`: the radio-side daemon.  Run next to the SDR hardware and
    point the receive host at it:

        radio$  t2radio --device sdrplay --frequency 634e6 --gain 40
        tpu$    t2rx tcp://radio:47392 --stream --device-path --out out.ts

    This is the deployment topology replacing the reference's USB-attached
    PlutoSDR (rx_plutosdr.cpp): the vendor read loop runs here, the DSP
    runs on the TPU host, and the streaming receiver's AGC/retune feedback
    crosses the socket upstream."""
    import argparse

    from . import devices as devmod

    ap = argparse.ArgumentParser(
        prog="t2radio", description="DVB-T2 radio-side IQ stream daemon")
    ap.add_argument("--device", default="file",
                    choices=sorted(devmod.DEVICES),
                    help="SDR front end (vendor drivers need the vendor "
                         "library installed on this machine)")
    ap.add_argument("--input", default=None,
                    help="capture path (file device) / sample source")
    ap.add_argument("--format", default="cf32", choices=("cf32", "ci16"))
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=47392)
    ap.add_argument("--frequency", type=float, default=0.0,
                    help="initial center frequency (Hz)")
    ap.add_argument("--gain", type=float, default=0.0)
    ap.add_argument("--block", type=int, default=65536)
    ap.add_argument("--max-seconds", type=float, default=0.0,
                    help="exit after this long (0 = serve until killed)")
    args = ap.parse_args(argv)

    if args.device == "file":
        if not args.input:
            ap.error("--device file needs --input CAPTURE")
        dev = devmod.FileDevice(args.input, fmt=args.format)
    elif args.device == "sim":
        ap.error("sim device is test-only; use --device file")
    else:
        dev = devmod.DEVICES[args.device]()
    dev.init(frequency_hz=args.frequency, gain_db=args.gain)
    srv = IQStreamServer(dev, host=args.host, port=args.port,
                         block=args.block)
    print(f"t2radio: serving {args.device} on {args.host}:{srv.port} "
          f"(freq {args.frequency:.0f} Hz, gain {args.gain:g} dB)",
          flush=True)
    try:
        srv.wait(timeout=args.max_seconds or None)
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
        dev.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
