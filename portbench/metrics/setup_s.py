"""Seconds from process start to the first timed submission: imports,
CUDA, the kernels from the build cache and their known answers, the
inputs and the warm-up (host clock)."""
KIND = "end_to_end"
UNIT = "s"


def read(run):
    return run["setup_s"]
