"""What one run of a loop did: the answers, and the measured window."""
from __future__ import annotations


class Window:
    """What one closed-loop run did: every submission answered (distinct
    index and the verdict its future carried) and how many never were;
    and the measured window, from the answer that ended the warm-up
    (``t0``) to the last answer before the close (``t_end``), with the
    answers that came in it."""

    def __init__(self):
        self.done: list = []          # (k, verdict) answered
        self.unanswered = 0
        self.t0 = self.t_end = 0.0
        self.wall0 = self.wall_end = 0.0
        self.times: list = []         # when each answer in the window came

    @property
    def seconds(self) -> float:
        return self.t_end - self.t0

    @property
    def answered(self) -> int:
        return len(self.times)
