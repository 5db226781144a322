"""stream_frontend_ms_per_frame: host ms per frame of the streaming loop's
`Metrics.stage("frontend")` (`io/devices.StreamingReceiver`: the raw
block through `ops/frontend_device.DeviceFrontendChain`, its host
post-stages included, and back to the host), summed over the traced run's
window, over the frames decoded in the window.  Absent on the superstep's
path."""


def read(rec):
    s = rec.get("stream")
    if not s or s["frames"] == 0:
        return None
    return s["stage_s"]["frontend"] * 1e3 / s["frames"]
