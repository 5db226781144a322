"""Headless plotting: the reference GUI's panels (spectrum, constellation,
P1-correlation oscilloscope, channel estimate — main_window.cpp:393-441,
plot.cpp) as PNG/CSV dumps for a CLI workflow."""
from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def spectrum_png(samples: np.ndarray, path: str, fs: float = 64e6 / 7.0,
                 nfft: int = 4096, title: str = "spectrum") -> None:
    plt = _plt()
    n = (len(samples) // nfft) * nfft
    spec = np.fft.fftshift(
        np.mean(np.abs(np.fft.fft(samples[:n].reshape(-1, nfft),
                                  axis=1)) ** 2, axis=0))
    f = np.fft.fftshift(np.fft.fftfreq(nfft, 1.0 / fs)) / 1e6
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(f, 10 * np.log10(spec + 1e-12), lw=0.7)
    ax.set_xlabel("MHz")
    ax.set_ylabel("dB")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def constellation_png(cells: np.ndarray, path: str, max_points: int = 20000,
                      title: str = "constellation") -> None:
    plt = _plt()
    c = cells.reshape(-1)
    if len(c) > max_points:
        c = c[:: len(c) // max_points]
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.scatter(np.real(c), np.imag(c), s=1, alpha=0.4)
    ax.set_aspect("equal")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def p1_correlation_png(x: np.ndarray, path: str) -> None:
    from ..rx.p1_detect import p1_correlate
    plt = _plt()
    mag, _ = p1_correlate(x)
    fig, ax = plt.subplots(figsize=(8, 3))
    ax.plot(mag, lw=0.6)
    ax.set_title("P1 correlation")
    ax.set_xlabel("sample")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def channel_estimate_png(carriers_row: np.ndarray, pilot_pos: np.ndarray,
                         pilot_ref: np.ndarray, path: str) -> None:
    plt = _plt()
    est = carriers_row[pilot_pos] / pilot_ref
    fig, (a1, a2) = plt.subplots(2, 1, figsize=(8, 5), sharex=True)
    a1.plot(pilot_pos, np.abs(est), lw=0.7)
    a1.set_ylabel("|H|")
    a2.plot(pilot_pos, np.unwrap(np.angle(est)), lw=0.7)
    a2.set_ylabel("arg H (rad)")
    a2.set_xlabel("carrier")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def loop_history_png(snr_db, timing, path: str) -> None:
    """Per-frame SNR + timing-offset history: the reference GUI's
    frequency/timing null-indicator panel (main_window.cpp:393-441) as a
    time series."""
    plt = _plt()
    fig, (a1, a2) = plt.subplots(2, 1, figsize=(8, 5), sharex=True)
    a1.plot(snr_db, ".-", lw=0.8)
    a1.set_ylabel("SNR (dB)")
    a2.plot(timing, ".-", lw=0.8)
    a2.set_ylabel("timing offset (samples)")
    a2.set_xlabel("frame")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def stage_plots(debug: dict, snr_hist, timing_hist, outdir: str,
                device="cuda") -> list:
    """Per-stage views of one captured frame from the DEVICE path (the
    fused demod on the torch `device`), covering what the reference GUI
    shows per stage
    (main_window.cpp:393-441): input spectrum, P1 correlation, channel
    estimate, L1 and data constellations post-equalization, loop history.

    `debug` comes from StreamingReceiver.run(capture_debug=True).
    Returns the list of files written."""
    import os

    import numpy as np

    from ..dvbt2 import l1 as l1mod
    from ..rx import demod as npdemod
    from ..rx import fusedpath
    from ..rx import p1_detect as rxp1

    p = debug["params"]
    l1pre = debug["l1pre"]
    frame = debug["frame"]
    os.makedirs(outdir, exist_ok=True)
    files = []

    def out(name):
        files.append(os.path.join(outdir, name))
        return files[-1]

    spectrum_png(frame, out("spectrum.png"), title="input spectrum")
    p1_correlation_png(frame[:4 * rxp1.P1_LEN], out("p1_corr.png"))

    # equalized cells straight from the fused device demod
    import torch
    demod = fusedpath.get_fused_demod(p)
    body = frame[rxp1.P1_LEN:rxp1.P1_LEN + p.len_frame * p.symbol_size]
    body2 = np.stack([np.real(body), np.imag(body)], -1).astype(np.float32)
    flat2 = demod(torch.from_numpy(body2).to(device)).cpu().numpy()
    cells = (flat2[:, 0] + 1j * flat2[:, 1])[demod.layout]
    l1_size = l1mod.L1_PRE_CELLS + l1pre.l1_post_size
    constellation_png(cells[:l1mod.L1_PRE_CELLS], out("const_l1pre.png"),
                      title="L1-pre cells (BPSK, equalized)")
    constellation_png(cells[l1mod.L1_PRE_CELLS:l1_size],
                      out("const_l1post.png"),
                      title="L1-post cells (equalized)")
    constellation_png(cells[l1_size:], out("const_data.png"),
                      title="data cells (equalized, pre-derotation)")

    # channel estimate across carriers from the first data symbol
    tabs = npdemod.pilot_tables(p)
    carriers = npdemod.extract_carriers(p, frame, rxp1.P1_LEN)
    t0 = tabs[p.n_p2]
    channel_estimate_png(carriers[p.n_p2], t0["pilot_pos"], t0["pilot_ref"],
                         out("channel_est.png"))

    if snr_hist or timing_hist:
        loop_history_png(snr_hist, timing_hist, out("loops.png"))
    return files
