"""stream_decode_ms_per_frame: host ms per frame of the streaming loop's
`Metrics.stage("decode_batch")` and `Metrics.stage("decode")` together
(`rx/device_receiver.DeviceT2Receiver`: demod and LLRs, the LDPC decoder,
BCH, byte pack and TS), summed over the traced run's window, over the
frames decoded in the window.  Absent on the superstep's path."""


def read(rec):
    s = rec.get("stream")
    if not s or s["frames"] == 0:
        return None
    return ((s["stage_s"]["decode_batch"] + s["stage_s"]["decode"]) * 1e3
            / s["frames"])
