"""device_idle_pct: 100 * (1 - busy / wall) over the traced steps of the
window: busy is the union of the device operations' intervals in
torch.profiler's trace (kernels, copies, sets), wall the host-clock time
of those steps ending in a synchronize.  Absent when no device operation
was traced."""


def read(rec):
    tr = rec["trace"]
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
