"""IQ capture file I/O.

Formats mirror what the reference's device layer delivers (int16 I/Q from
SdrPlay/AirSpy/PlutoSDR: rx_sdrplay.cpp:245-256, rx_airspy.cpp:77-83) plus
float32/complex64 for synthetic captures:

  - "cf32": interleaved float32 I,Q (= raw complex64)
  - "ci16": interleaved int16 I,Q (device native)
  - "cf32_legacy"/"ci16" files have no header; rate/format supplied by the
    caller or inferred from the filename suffix (.cf32 / .ci16 / .iq)
"""
from __future__ import annotations

import numpy as np

FORMATS = ("cf32", "ci16")


def infer_format(path: str) -> str:
    if path.endswith(".ci16") or path.endswith(".i16"):
        return "ci16"
    return "cf32"


def read_iq(path: str, fmt: str | None = None,
            count: int = -1, offset: int = 0) -> np.ndarray:
    fmt = fmt or infer_format(path)
    if fmt == "cf32":
        raw = np.fromfile(path, dtype=np.complex64, count=count,
                          offset=offset * 8)
        return raw
    if fmt == "ci16":
        raw = np.fromfile(path, dtype=np.int16,
                          count=-1 if count < 0 else 2 * count,
                          offset=offset * 4)
        raw = raw[:len(raw) // 2 * 2].reshape(-1, 2)
        return ((raw[:, 0].astype(np.float32)
                 + 1j * raw[:, 1].astype(np.float32)) / 32768.0
                ).astype(np.complex64)
    raise ValueError(f"unknown IQ format {fmt!r}")


def write_iq(path: str, samples: np.ndarray, fmt: str | None = None) -> None:
    fmt = fmt or infer_format(path)
    if fmt == "cf32":
        samples.astype(np.complex64).tofile(path)
        return
    if fmt == "ci16":
        scaled = np.empty((len(samples), 2), dtype=np.int16)
        s = samples * 32767.0 / max(np.abs(samples).max(), 1e-9)
        scaled[:, 0] = np.round(np.real(s)).astype(np.int16)
        scaled[:, 1] = np.round(np.imag(s)).astype(np.int16)
        scaled.tofile(path)
        return
    raise ValueError(f"unknown IQ format {fmt!r}")
