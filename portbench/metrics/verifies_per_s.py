"""Signatures that got a verdict in the window, over the window's seconds
(host clock, from the answer that ends the warm-up to the last answer
before the close)."""
KIND = "end_to_end"
UNIT = "verifies/s"


def read(run):
    if run["window_s"] <= 0:
        return None
    return run["items_done"] / run["window_s"]
