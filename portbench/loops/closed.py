"""The closed loop: a fixed number of requests in flight from one client
thread, each answer sending the next."""
from __future__ import annotations

import queue
import time

from harness.window import Window


def make(submit, outcome, n_distinct: int, mix: dict):
    """The loop of a mix: ``outstanding`` in flight, in waves of ``wave``
    (1 where the mix names none)."""
    return Loop(submit, outcome, n_distinct, mix["outstanding"],
                mix.get("wave", 1))


class Loop:
    """``outstanding`` requests in flight from one client thread, sent in
    waves of ``wave``: ``outstanding // wave`` clients each send a wave of
    consecutive distinct inputs at once and, when every answer of it has
    come, the next wave (``wave`` 1: each answer sends the next input),
    cycling through ``n_distinct``. Answers reach the client through a
    queue that the futures' callbacks fill; ``outcome(future)`` reads the
    verdict of each answer in the window.

    One run warms up and measures without a break: the window opens at the
    answer that completes the warm-up, with the loop already full, and
    closes ``seconds`` later; then sending stops and every request still
    out is waited for (at most ``grace_s``), to be judged like the rest.
    The window's rate is taken from answer to answer, so neither the
    loop's filling nor its draining is in it."""

    def __init__(self, submit, outcome, n_distinct: int, outstanding: int,
                 wave: int = 1):
        if wave < 1 or outstanding % wave:
            raise ValueError(f"outstanding {outstanding} is no whole "
                             f"number of waves of {wave}")
        self.submit = submit
        self.outcome = outcome
        self.n = n_distinct
        self.outstanding = outstanding
        self.wave = wave
        self.next_k = 0

    def run(self, warmup: int, seconds: float, on_open=None, on_close=None,
            grace_s: float = 60.0, warmup_limit_s: float = 300.0) -> Window:
        """``warmup`` answers first, then the window of ``seconds``.
        ``on_open()`` and ``on_close()`` are called as the window opens and
        as the first answer after its close comes."""
        answers: queue.SimpleQueue = queue.SimpleQueue()
        win = Window()
        inflight = 0
        due = {}                      # client -> answers due of its wave

        def send_wave(client):
            nonlocal inflight
            for _ in range(self.wave):
                k = self.next_k
                self.next_k = (k + 1) % self.n
                fut = self.submit(k)
                fut.add_done_callback(
                    lambda f, k=k: answers.put((client, k, f,
                                                time.perf_counter(),
                                                time.time())))
            inflight += self.wave
            due[client] = self.wave

        for client in range(self.outstanding // self.wave):
            send_wave(client)
        got = 0
        close = None
        closed = False
        limit = time.perf_counter() + warmup_limit_s
        while inflight:
            try:
                client, k, fut, t, wall = answers.get(
                    timeout=max(0.0, limit - time.perf_counter()))
            except queue.Empty:
                if close is None:
                    raise RuntimeError(f"warm-up: no answer in "
                                       f"{warmup_limit_s} s")
                win.unanswered = inflight
                break
            inflight -= 1
            due[client] -= 1
            got += 1
            if close is None:
                if got >= warmup:
                    win.t0, win.wall0 = t, wall
                    win.t_end, win.wall_end = t, wall
                    close = t + seconds
                    limit = close + grace_s
                    if on_open is not None:
                        on_open()
            else:
                # the verdict is read as it comes, so that no future, and
                # no refusal's traceback, stays alive through the window
                win.done.append((k, self.outcome(fut)))
                if t <= close:
                    win.times.append(t)
                    win.t_end, win.wall_end = t, wall
                elif not closed:
                    closed = True
                    if on_close is not None:
                        on_close()
            if not due[client] and (close is None
                                    or time.perf_counter() < close):
                send_wave(client)
        return win
