"""The card's idle share of the window: one less the union of kernel,
copy and memset intervals in the profiler trace over the window's wall."""
KIND = "per_layer"
UNIT = "%"


def read(run):
    trace = run["device"]
    if trace is None or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
