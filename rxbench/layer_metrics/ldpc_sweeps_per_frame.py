"""ldpc_sweeps_per_frame: layered LDPC sweeps the decoder ran per frame
(the sweep count `Superstep.__call__` returns, summed over the window's
steps, over its frames; every codeword of a frame runs the frame's
sweeps)."""


def read(rec):
    if rec["frames"] == 0:
        return None
    return rec["sweeps"] / rec["frames"]
