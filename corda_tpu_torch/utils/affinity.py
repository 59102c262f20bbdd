"""SerialExecutor — the single-threaded node-thread discipline.

Reference parity: AffinityExecutor.ServiceAffinityExecutor
(node/utilities/AffinityExecutor.kt:1-118): nearly all node logic runs
serialized on one thread; `check_on_thread` asserts the discipline, and
`fetch_from` lets other threads run a closure on the node thread and wait.
This is the structural race defense the reference relies on instead of
sanitizers (SURVEY.md §5).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import Future


class SerialExecutor:
    def __init__(self, name: str = "node-thread"):
        self._queue: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._shutdown = False
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            fn, fut = item
            try:
                result = fn()
            except BaseException as e:  # noqa: BLE001 — forwarded to the future
                if fut is not None:
                    fut.set_exception(e)
                continue
            if fut is not None:
                fut.set_result(result)

    # -- submission ----------------------------------------------------------
    def execute(self, fn) -> None:
        """Fire-and-forget on the node thread (executeASAP)."""
        if self.on_thread:
            fn()
            return
        self._queue.put((fn, None))

    def post(self, fn) -> None:
        """Queue ``fn`` for the node thread even when called on it: work
        that must run after the step in progress (an async completion that
        resolved before its flow finished parking)."""
        self._queue.put((fn, None))

    def fetch_from(self, fn) -> Future:
        """Run on the node thread, return a Future of the result
        (AffinityExecutor.fetchFrom)."""
        if self.on_thread:
            fut: Future = Future()
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)
            return fut
        fut = Future()
        self._queue.put((fn, fut))
        return fut

    # -- assertions ----------------------------------------------------------
    @property
    def on_thread(self) -> bool:
        return threading.current_thread() is self._thread

    def check_on_thread(self) -> None:
        assert self.on_thread, \
            f"Expected to run on {self._thread.name}, was on " \
            f"{threading.current_thread().name}"

    def shutdown(self) -> None:
        self._queue.put(None)
        self._thread.join(timeout=5)
