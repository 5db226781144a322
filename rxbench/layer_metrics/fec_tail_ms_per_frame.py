"""fec_tail_ms_per_frame: device ms per frame of the superstep's fec_tail stage:
CUDA events at the program's `mark("fec_tail")` calls, each stage timed from
the mark before it, summed over every step of the traced run's window and
divided by its frames.  Absent without a card."""


def read(rec):
    ms = rec["stage_ms"].get("fec_tail")
    if ms is None or rec["frames"] == 0:
        return None
    return ms / rec["frames"]
