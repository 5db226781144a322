"""stream_batched_frames_pct: the share of the window's decoded frames
that `DeviceT2Receiver.decode_frames_batch` decoded, in percent: the
receiver's count of frames decoded less the calls of the streaming loop's
per-frame path (`Metrics.stage("decode")`), over the frames decoded.
Absent on the superstep's path or where the window decoded no frame."""


def read(rec):
    s = rec.get("stream")
    if not s or s["frames"] == 0:
        return None
    return 100.0 * s["batched_frames"] / s["frames"]
