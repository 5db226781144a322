"""ctypes bindings for the native ingest library (see ingest.cpp).

The library is built on first use (g++ is assumed present, as in the dev
image); all entry points degrade gracefully to NumPy when the build is
unavailable so the pure-Python path keeps working.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libt2ingest.so")
_lib = None


def _build() -> bool:
    try:
        subprocess.run(["sh", os.path.join(_DIR, "build.sh")], check=True,
                       capture_output=True)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def get_lib():
    """Load (building if needed/stale) the native library; None if
    unavailable.  Stale = ingest.cpp newer than the built .so."""
    global _lib
    if _lib is not None:
        return _lib
    src = os.path.join(_DIR, "ingest.cpp")
    stale = (os.path.exists(_LIB_PATH) and os.path.exists(src)
             and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH))
    if (not os.path.exists(_LIB_PATH) or stale) and not _build():
        if not os.path.exists(_LIB_PATH):
            return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.iq_int16_to_float.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_float]
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_int64]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ring_fill.restype = ctypes.c_int64
    lib.ring_fill.argtypes = [ctypes.c_void_p]
    lib.ring_overruns.restype = ctypes.c_int64
    lib.ring_overruns.argtypes = [ctypes.c_void_p]
    lib.ring_push.restype = ctypes.c_int64
    lib.ring_push.argtypes = [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.ring_push_int16.restype = ctypes.c_int64
    lib.ring_push_int16.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
        ctypes.c_float]
    lib.ring_pop.restype = ctypes.c_int64
    lib.ring_pop.argtypes = [ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.read_ci16_file.restype = ctypes.c_int64
    lib.read_ci16_file.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_float]
    lib.udp_ts_open.restype = ctypes.c_void_p
    lib.udp_ts_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.udp_ts_send.restype = ctypes.c_int64
    lib.udp_ts_send.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_uint8),
                                ctypes.c_int64]
    lib.udp_ts_close.argtypes = [ctypes.c_void_p]
    lib.crc8_rows.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8)]
    try:
        lib.crc8_rows_strided.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]
    except AttributeError:
        pass   # pre-existing .so without the strided entry
    _lib = lib
    return lib


def int16_to_complex(iq_int16: np.ndarray,
                     scale: float = 1.0 / 32768.0) -> np.ndarray:
    """Interleaved int16 IQ -> complex64, native (AVX2) when available."""
    iq_int16 = np.ascontiguousarray(iq_int16, dtype=np.int16)
    n = len(iq_int16) // 2
    lib = get_lib()
    if lib is None:
        pairs = iq_int16[:2 * n].reshape(-1, 2).astype(np.float32) * scale
        return (pairs[:, 0] + 1j * pairs[:, 1]).astype(np.complex64)
    out = np.empty(2 * n, dtype=np.float32)
    lib.iq_int16_to_float(
        iq_int16.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, scale)
    return out.view(np.complex64)


class IQRing:
    """SPSC streaming ring for capture ingest (native; NumPy fallback)."""

    def __init__(self, capacity: int):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("native ingest library unavailable")
        self._h = self._lib.ring_create(capacity)

    def push(self, samples: np.ndarray) -> int:
        arr = np.ascontiguousarray(
            np.stack([np.real(samples), np.imag(samples)], -1),
            dtype=np.float32)
        return self._lib.ring_push(
            self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(samples))

    def push_int16(self, iq: np.ndarray, scale: float = 1 / 32768.0) -> int:
        iq = np.ascontiguousarray(iq, dtype=np.int16)
        return self._lib.ring_push_int16(
            self._h, iq.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            len(iq) // 2, scale)

    def pop(self, n: int) -> np.ndarray:
        out = np.empty(2 * n, dtype=np.float32)
        got = self._lib.ring_pop(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
        return out[:2 * got].view(np.complex64)

    @property
    def fill(self) -> int:
        return self._lib.ring_fill(self._h)

    def flush(self) -> int:
        """Drop everything currently buffered (consumer side); returns the
        number of samples discarded.  Used on hardware retunes: samples
        captured at the old LO must not be re-measured (the reference
        resets its elastic buffer the same way)."""
        dropped = 0
        while True:
            n = self.fill
            if n <= 0:
                return dropped
            got = self.pop(min(n, 1 << 16))
            if not len(got):
                return dropped
            dropped += len(got)

    @property
    def overruns(self) -> int:
        return self._lib.ring_overruns(self._h)

    def close(self):
        if self._h:
            self._lib.ring_destroy(self._h)
            self._h = None


def crc8_rows(rows) -> "np.ndarray | None":
    """Native per-row CRC-8 (0xD5) of an (n, m) uint8 matrix; None when
    the library is unavailable (caller falls back to NumPy).  A row-
    strided view with a contiguous inner dim (e.g. `block[:, 1:]` of TS
    rows) is processed in place — no defensive copy."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.asarray(rows, dtype=np.uint8)
    if rows.ndim != 2:
        raise ValueError("crc8_rows wants (n, m)")
    n, m = rows.shape
    out = np.empty(n, dtype=np.uint8)
    if (rows.strides[1] == 1 and rows.strides[0] >= m
            and hasattr(lib, "crc8_rows_strided")):
        lib.crc8_rows_strided(
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n, m, rows.strides[0],
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out
    rows = np.ascontiguousarray(rows)
    lib.crc8_rows(rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                  n, m, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def read_ci16(path: str, max_samples: int = 1 << 62,
              scale: float = 1 / 32768.0) -> np.ndarray:
    """Native bulk reader for interleaved-int16 captures."""
    lib = get_lib()
    if lib is None:
        from ..io.iq import read_iq
        return read_iq(path, "ci16")
    size = os.path.getsize(path) // 4
    n = min(size, max_samples)
    out = np.empty(2 * n, dtype=np.float32)
    got = lib.read_ci16_file(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, scale)
    if got < 0:
        raise IOError(f"cannot read {path}")
    return out[:2 * got].view(np.complex64)
