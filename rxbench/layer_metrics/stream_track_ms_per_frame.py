"""stream_track_ms_per_frame: host ms per frame of the streaming loop's
`Metrics.stage("track")` (`io/devices.StreamingReceiver.run`'s
`track_one`: each frame's P1 measured on the host), summed over the
traced run's window, over the frames decoded in the window.  Absent on
the superstep's path."""


def read(rec):
    s = rec.get("stream")
    if not s or s["frames"] == 0:
        return None
    return s["stage_s"]["track"] * 1e3 / s["frames"]
