"""k1_roofline_pct: K1's least time over its device time, in percent, for
the traced steps.  The least time is `roofline.k1_bound_s` (operations
over 67 TFLOP/s f32 or bytes over 3.35 TB/s, the H100 SXM's published
peaks) for the sweeps and syndrome passes those steps' decodes ran; the
device time is the profiler's, summed over K1's kernels by name.  Absent
when no K1 kernel was traced."""
from rxbench import roofline


def read(rec):
    tr = rec["trace"]
    if not tr or tr["k1_s"] <= 0:
        return None
    sweeps = sum(rec["step_sweeps"][i] for i in tr["steps"])
    decodes = len(tr["steps"]) * rec["frames_per_step"]
    n_checks = roofline.checks(sweeps, decodes, rec["inv_nvar"])
    bound, _ = roofline.k1_bound_s(*rec["code"], rec["num_blocks"], sweeps,
                                   n_checks, decodes)
    return 100.0 * bound / tr["k1_s"]
