"""step_p90_ms: the 90th percentile, over every step of the window, of the
host-clock time from issuing a step to its bytes being on the host
(`statistics.quantiles(..., n=10)[8]`, exclusive method)."""
import statistics


def read(rec):
    ms = rec["step_ms"]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=10)[8]
