"""Node Explorer — the ops console, terminal edition.

Reference parity: tools/explorer (the JavaFX ops GUI: transaction viewer,
vault/cash view, flow monitor, network map, all fed by the RPC observable
feeds). Same data, same feeds, rendered as a live terminal dashboard
instead of JavaFX — works over an in-process `CordaRPCOps` or a remote
`CordaRPCClient` identically.

    python -m corda_tpu_torch.tools.explorer --host 127.0.0.1 --port 10001
    python -m corda_tpu_torch.tools.explorer ... --watch   # live re-render

The non-interactive `render()` returns the dashboard as a string (tests,
logs, piping).
"""
from __future__ import annotations

import time


def _name_of(party) -> str:
    return str(getattr(party, "name", party))


class Explorer:
    def __init__(self, ops):
        self.ops = ops

    # -- data gathering ------------------------------------------------------
    def snapshot(self) -> dict:
        ops = self.ops
        vault = ops.vault_snapshot()
        by_type: dict[str, list] = {}
        for sar in vault:
            by_type.setdefault(type(sar.state.data).__name__, []).append(sar)
        txs = ops.verified_transactions_snapshot()
        return {
            "identity": ops.node_identity(),
            "network": ops.network_map_snapshot(),
            "notaries": ops.notary_identities(),
            "flows": ops.state_machines_snapshot(),
            "vault_by_type": by_type,
            "transactions": txs,
            "metrics": (ops.metrics_snapshot()
                        if hasattr(ops, "metrics_snapshot") else {}),
        }

    # -- rendering -----------------------------------------------------------
    def render(self) -> str:
        s = self.snapshot()
        lines = []
        me = s["identity"]
        lines.append(f"┌─ {_name_of(me.legal_identity)} ({me.address})")
        lines.append(f"│ network: {len(s['network'])} nodes, "
                     f"{len(s['notaries'])} notaries")
        lines.append("│")
        lines.append(f"│ FLOWS ({len(s['flows'])} in flight)")
        for info in s["flows"][:10]:
            state = "done" if info.done else "running"
            lines.append(f"│   {info.run_id[:8]}  {info.flow_class:40} {state}")
        lines.append("│")
        total_states = sum(len(v) for v in s["vault_by_type"].values())
        lines.append(f"│ VAULT ({total_states} unconsumed states)")
        for tname, sars in sorted(s["vault_by_type"].items()):
            qty = sum(getattr(getattr(sar.state.data, "amount", None),
                              "quantity", 0) for sar in sars)
            suffix = f"  total {qty}" if qty else ""
            lines.append(f"│   {tname:32} x{len(sars)}{suffix}")
        lines.append("│")
        lines.append(f"│ LEDGER ({len(s['transactions'])} verified transactions)")
        for stx in s["transactions"][-8:]:
            wtx = stx.tx if hasattr(stx, "tx") else stx
            lines.append(f"│   {stx.id.bytes.hex()[:16]}…  "
                         f"{len(wtx.inputs)} in / {len(wtx.outputs)} out  "
                         f"{len(stx.sigs)} sigs")
        flows_started = s["metrics"].get("Flows.Started", {}).get("count")
        if flows_started is not None:
            lines.append("│")
            lines.append(f"│ flows started: {flows_started}, "
                         f"in flight: "
                         f"{s['metrics'].get('Flows.InFlight', {}).get('value', 0)}")
        lines.append("└─")
        return "\n".join(lines)

    def watch(self, interval_s: float = 2.0, iterations: int | None = None
              ) -> None:
        """Live dashboard driven by PUSHED feed observations (the GUI's
        observable subscriptions, RPCClientProxyHandler demux): subscribe to
        the vault / transaction / state-machine / network-map feeds and
        re-render when an update arrives. ``interval_s`` only caps the idle
        redraw cadence; falls back to interval polling against an ops object
        without streaming feeds."""
        import threading
        wake = threading.Event()
        feeds = []
        for feed_op in ("vault_feed", "verified_transactions_feed",
                        "state_machines_feed", "network_map_feed"):
            try:
                feed = getattr(self.ops, feed_op)()
            except Exception:
                continue
            if hasattr(feed, "subscribe"):
                feed.subscribe(lambda _update: wake.set())
                feeds.append(feed)
        n = 0
        try:
            while iterations is None or n < iterations:
                print("\x1b[2J\x1b[H" + self.render(), flush=True)
                n += 1
                if iterations is None or n < iterations:
                    if feeds:
                        wake.wait(timeout=interval_s)
                        wake.clear()
                    else:
                        time.sleep(interval_s)
        finally:
            for feed in feeds:
                close = getattr(feed, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:
                        pass


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(prog="corda_tpu_torch.tools.explorer")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--watch", action="store_true")
    parser.add_argument("--interval", type=float, default=2.0)
    parser.add_argument("--tls-ca", default=None,
                        help="dev-CA directory for an mTLS node plane")
    args = parser.parse_args(argv)
    from ..client.rpc import CordaRPCClient
    import corda_tpu_torch.finance  # noqa: F401 — wire types for deserialization
    explorer = Explorer(CordaRPCClient(args.host, args.port,
                                       tls_ca_directory=args.tls_ca))
    if args.watch:
        try:
            explorer.watch(args.interval)
        except KeyboardInterrupt:
            pass
    else:
        print(explorer.render())
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
