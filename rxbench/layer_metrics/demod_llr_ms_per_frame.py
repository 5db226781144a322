"""demod_llr_ms_per_frame: device ms per frame of the superstep's demod_llr stage:
CUDA events at the program's `mark("demod_llr")` calls, each stage timed from
the mark before it, summed over every step of the traced run's window and
divided by its frames.  Absent without a card."""


def read(rec):
    ms = rec["stage_ms"].get("demod_llr")
    if ms is None or rec["frames"] == 0:
        return None
    return ms / rec["frames"]
