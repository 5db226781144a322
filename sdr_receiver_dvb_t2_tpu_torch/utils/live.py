"""Live terminal dashboard for the streaming receiver: the CLI's answer to
the reference's Qt GUI live panels (constellation / SNR / sync state /
frequency-timing indicators, main_window.cpp:393-441) without a display
server — ANSI redraw-in-place on stderr.

Shows per block: lock state + discovered mode, frame/TS counters, an SNR
meter, the closed-loop states (CFO, SCO, AGC gain, retunes), per-stage
throughput from utils.metrics, and a character-cell constellation of the
most recent equalized cells (ReceiverStats.last_cells, fed by both the
NumPy and the device receive paths)."""
from __future__ import annotations

import sys
import time

import numpy as np

_CSI = "\x1b["


def render_constellation(cells: np.ndarray, rows: int = 12,
                         cols: int = 38, span: float = 1.6) -> list[str]:
    """Density map of complex cells onto a rows x cols character grid
    (the GUI constellation plot as text).  `span`: plotted IQ half-range."""
    shades = " .:-=+*#%@"
    grid = np.zeros((rows, cols), dtype=np.int64)
    if cells is not None and len(cells):
        c = np.asarray(cells)
        # a NaN/Inf cell (e.g. a divide-by-zero equalizer tap) must not
        # crash the dashboard: np.clip passes NaN through and the int64
        # cast then indexes out of range
        c = c[np.isfinite(c.real) & np.isfinite(c.imag)]
        x = np.clip((np.real(c) / span + 1.0) * 0.5 * (cols - 1),
                    0, cols - 1).astype(np.int64)
        y = np.clip((1.0 - np.imag(c) / span) * 0.5 * (rows - 1),
                    0, rows - 1).astype(np.int64)
        np.add.at(grid, (y, x), 1)
    mx = max(int(grid.max()), 1)
    lvl = np.minimum((grid * (len(shades) - 1) * 2 + mx - 1) // mx,
                     len(shades) - 1)
    return ["".join(shades[int(v)] for v in row) for row in lvl]


def render_spectrum(x, rows: int = 6, cols: int = 56,
                    span_db: float = 50.0) -> list[str]:
    """ASCII power spectrum of the latest raw block (the reference GUI's
    live input spectrograph, main_window.cpp:393-441, as text).

    Welch-style: 512-point segments, |FFT|^2 averaged, fftshifted, folded
    into `cols` bins; each column is a bar scaled over `span_db` below
    the peak.  NaN/short/absent input renders an empty pane instead of
    crashing the dashboard."""
    grid = [[" "] * cols for _ in range(rows)]
    n_fft = 512
    if x is not None and len(x) >= n_fft:
        c = np.asarray(x, np.complex64)
        c = np.where(np.isfinite(c.real) & np.isfinite(c.imag), c, 0)
        n_seg = len(c) // n_fft
        seg = c[:n_seg * n_fft].reshape(n_seg, n_fft)
        seg = seg * np.hanning(n_fft)[None, :]
        psd = np.fft.fftshift(np.mean(np.abs(np.fft.fft(seg, axis=1)) ** 2,
                                      axis=0))
        binned = psd[:n_fft - n_fft % cols].reshape(cols, -1).mean(axis=1)
        db = 10.0 * np.log10(np.maximum(binned, 1e-30))
        top = float(db.max())
        if np.isfinite(top):
            h = np.clip((db - (top - span_db)) / span_db, 0.0, 1.0) * rows
            for j in range(cols):
                full = int(h[j])
                for r in range(full):
                    grid[rows - 1 - r][j] = "#"
                if full < rows and h[j] - full > 0.5:
                    grid[rows - 1 - full][j] = "."
    return ["".join(r) for r in grid]


def _bar(value: float, lo: float, hi: float, width: int = 24) -> str:
    frac = 0.0 if hi <= lo else (value - lo) / (hi - lo)
    if not np.isfinite(frac):
        frac = 0.0
    n = int(np.clip(frac, 0.0, 1.0) * width)
    return "[" + "#" * n + "-" * (width - n) + "]"


class LiveDashboard:
    """Throttled in-place status renderer; call `update` from the streaming
    loop's per-block callback and `close` at the end."""

    def __init__(self, out=None, interval: float = 0.25):
        self.out = out if out is not None else sys.stderr
        self.interval = interval
        self._last = 0.0
        self._lines = 0
        self._t0 = time.time()

    def _mode_str(self, lock) -> str:
        if lock is None:
            return "ACQUIRING"
        p = lock.params
        return (f"LOCKED  {p.fft_mode.name.replace('FFT_', '')} "
                f"{p.guard.name.replace('GI_', 'GI ')} "
                f"{p.pilot_pattern.name}"
                + (" MISO" if p.miso else " SISO"))

    def update(self, st, lock, rxstats, final: bool = False) -> None:
        self._seen = (st, lock, rxstats)
        now = time.time()
        if not final and now - self._last < self.interval:
            return
        self._last = now
        snr = float(rxstats.snr_db[-1]) if rxstats.snr_db else float("nan")
        iters = None
        for ps in rxstats.plp_stats.values():
            if ps.ldpc_iters:
                iters = float(np.mean(ps.ldpc_iters[-32:]))
        elapsed = max(now - self._t0, 1e-9)
        lines = [
            f"t2rx live  |  {self._mode_str(lock)}",
            f"  frames {rxstats.frames_decoded:6d}   skipped "
            f"{st.frames_skipped:4d}   reacq {st.reacquisitions:2d}   "
            f"blocks {st.blocks:5d}  ({st.raw_samples / elapsed / 1e6:6.1f} "
            f"Msps in)",
            f"  SNR {snr:5.1f} dB {_bar(snr, 0, 35)}   "
            + (f"LDPC {iters:4.1f} it" if iters is not None else ""),
            f"  CFO {st.cfo_hz if st.cfo_hz else 0.0:+9.1f} Hz   "
            f"SCO {st.sco_ppm:+7.2f} ppm   gain {st.gain_db_applied:+5.1f} dB"
            f"   retunes {st.retune_requests}",
            f"  TS packets {st.ts_packets:8d}   errors {st.ts_errors:4d}   "
            f"L1 failures {rxstats.l1_failures:3d}",
        ]
        lines.append("  input spectrum (50 dB span):")
        lines.extend("   |" + r + "|" for r in
                     render_spectrum(getattr(st, "last_raw", None)))
        cells = getattr(rxstats, "last_cells", None)
        label = getattr(rxstats, "last_cells_label", "")
        lines.append(f"  constellation: {label or '(waiting for lock)'}")
        lines.extend("   " + r for r in
                     render_constellation(cells))
        self._redraw(lines)

    def _redraw(self, lines) -> None:
        out = self.out
        if self._lines:
            out.write(f"{_CSI}{self._lines}A")
        for ln in lines:
            out.write(f"{_CSI}2K" + ln + "\n")
        out.flush()
        self._lines = len(lines)

    def close(self) -> None:
        """Final un-throttled redraw of the last observed state."""
        if getattr(self, "_seen", None) is not None:
            self.update(*self._seen, final=True)
