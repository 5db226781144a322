"""rx_msamples_per_s: samples of every frame fully decoded in the window,
its bytes on the host, over the window's wall time (host clock), in
millions per second.  A frame's samples are counted at the elementary
rate (1,983,488 for the 32K mode; real time is 9.142857 Msamples/s)."""


def read(rec):
    if rec["frames"] == 0 or rec["window_s"] <= 0:
        return None
    return rec["frames"] * rec["samples_per_frame"] / rec["window_s"] / 1e6
