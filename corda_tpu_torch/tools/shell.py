"""Interactive shell — the operator console over the RPC surface.

Reference parity: the CRaSH-based shell (node/shell/InteractiveShell.kt:1-503
with FlowShellCommand / RunShellCommand / StartShellCommand and
FlowWatchPrintingSubscriber):

- ``run <op> [args]`` invokes any RPC operation,
- ``flow list`` shows registered flows,
- ``flow start <Name> name: value, ...`` starts a flow from a TYPED string:
  the arguments bind to the flow constructor's parameter names via the
  jackson StringToMethodCallParser analog (client.jackson) — amounts like
  ``100.00 USD``, 0x-hex bytes, X.500 names resolved to parties against the
  network map, annotations honoured. Positional ``flow start <Name> a b c``
  still works.
- ``flow watch`` renders state-machine add/remove events live from the
  streamed feed (remote: pushed observations; in-process: callbacks).
- ``output yaml|json`` switches rendering (JacksonSupport to_json /
  the Yaml emitter).

Works identically over an in-process ``CordaRPCOps`` or a remote
``CordaRPCClient``.
"""
from __future__ import annotations

import shlex
import sys

from ..client.jackson import (StringToMethodCallParser,
                              UnparseableCallException, render_yaml, to_json)


class Shell:
    def __init__(self, ops, out=None):
        """`ops` is a CordaRPCOps (in-process) or CordaRPCClient (remote)."""
        self.ops = ops
        self.out = out if out is not None else sys.stdout
        self.output_mode = "yaml"
        self.parser = StringToMethodCallParser(
            party_resolver=self._well_known)

    # -- rendering -----------------------------------------------------------
    def _render(self, value) -> str:
        if self.output_mode == "json":
            return to_json(value)
        return render_yaml(value)

    def _println(self, text: str) -> None:
        print(text, file=self.out)

    # -- argument parsing (positional fallback) ------------------------------
    def _parse_arg(self, token: str):
        return self.parser.convert(token)

    def _well_known(self, name: str):
        try:
            return self.ops.well_known_party_from_x500_name(name)
        except Exception:
            return None

    # -- commands ------------------------------------------------------------
    def execute(self, line: str) -> bool:
        """Run one command line; returns False when the shell should exit."""
        line = line.strip()
        if not line:
            return True
        try:
            tokens = shlex.split(line)
        except ValueError as e:
            self._println(f"parse error: {e}")
            return True
        cmd = tokens[0]
        if cmd in ("exit", "quit", "bye"):
            return False
        if cmd == "help":
            self._println(
                "commands:\n"
                "  run <op> [args...]              invoke an RPC op\n"
                "  flow list                       registered flows\n"
                "  flow start <Name> k: v, ...     typed named arguments\n"
                "  flow start <Name> [args...]     positional arguments\n"
                "  flow watch [n]                  live flow events\n"
                "  output yaml|json                switch rendering\n"
                "  exit")
            return True
        try:
            if cmd == "output" and len(tokens) == 2 and \
                    tokens[1] in ("yaml", "json"):
                self.output_mode = tokens[1]
            elif cmd == "run" and len(tokens) >= 2:
                method = getattr(self.ops, tokens[1])
                args = [self._parse_arg(t) for t in tokens[2:]]
                self._println(self._render(method(*args)))
            elif cmd == "flow" and len(tokens) >= 2 and tokens[1] == "list":
                for name in self.ops.registered_flows():
                    self._println(name)
            elif cmd == "flow" and len(tokens) >= 2 and tokens[1] == "watch":
                limit = int(tokens[2]) if len(tokens) > 2 else None
                self._watch_flows(limit)
            elif cmd == "flow" and len(tokens) >= 3 and tokens[1] == "start":
                import re as _re
                m = _re.search(
                    r"\bstart\s+(\"[^\"]*\"|'[^']*'|\S+)\s*(.*)$", line)
                rest = m.group(2).strip() if m else ""
                # named form only when the text actually opens with name:
                if _re.match(r"^[A-Za-z_][A-Za-z0-9_]*\s*:", rest):
                    args = self._bind_flow_args(tokens[2], rest)
                else:
                    args = [self._parse_arg(t) for t in tokens[3:]]
                result = self._start_flow(tokens[2], args)
                self._println(self._render(result))
            else:
                self._println(f"unknown command: {line!r} (try 'help')")
        except UnparseableCallException as e:
            self._println(f"cannot bind arguments: {e}")
        except Exception as e:
            self._println(f"error: {type(e).__name__}: {e}")
        return True

    # -- flow plumbing -------------------------------------------------------
    def _flow_class(self, name: str):
        from ..flows.api import rpc_startable_flows
        flows = rpc_startable_flows()
        cls = flows.get(name)
        if cls is None:
            matches = [c for n, c in flows.items()
                       if n.rsplit(".", 1)[-1] == name]
            cls = matches[0] if len(matches) == 1 else None
        return cls

    def _bind_flow_args(self, name: str, text: str) -> list:
        cls = self._flow_class(name)
        if cls is None:
            raise UnparseableCallException(
                f"unknown flow {name!r} (try 'flow list')")
        return self.parser.parse_arguments(cls, text)

    def _start_flow(self, name: str, args):
        if hasattr(self.ops, "start_flow_and_wait"):     # remote client
            return self.ops.start_flow_and_wait(name, *args)
        fsm = self.ops.start_flow_dynamic(name, *args)   # in-process ops
        return {"flow": name, "run_id": fsm.run_id}

    def _watch_flows(self, limit: int | None = None) -> None:
        """Render state-machine events as they stream
        (FlowWatchPrintingSubscriber). Remote feeds push observations;
        in-process feeds fire callbacks. ``limit`` bounds the events
        rendered (tests; interactive use stops with Ctrl-C)."""
        feed = self.ops.state_machines_feed()
        for info in feed.snapshot:
            self._println(self._render(info))
        shown = 0
        if hasattr(feed, "next_event"):                  # remote ClientDataFeed
            try:
                while limit is None or shown < limit:
                    event = feed.next_event(timeout_s=30.0)
                    self._println(self._render(event))
                    shown += 1
            except KeyboardInterrupt:    # pragma: no cover - interactive
                pass
            finally:
                close = getattr(feed, "close", None)
                if close:
                    close()
            return
        import queue as _q
        events: "_q.Queue" = _q.Queue()
        alive = {"on": True}
        # in-process feeds have no unsubscribe; gate the callback so an
        # ended watch stops feeding (and growing) the abandoned queue
        feed.subscribe(lambda ev: events.put(ev) if alive["on"] else None)
        try:
            while limit is None or shown < limit:
                self._println(self._render(events.get(timeout=30.0)))
                shown += 1
        except (KeyboardInterrupt, _q.Empty):  # pragma: no cover
            pass
        finally:
            alive["on"] = False

    def repl(self) -> None:  # pragma: no cover - interactive loop
        while True:
            try:
                line = input(">>> ")
            except (EOFError, KeyboardInterrupt):
                break
            if not self.execute(line):
                break
