"""HTTP gateway — REST access to a node's RPC surface.

Reference parity: the standalone webserver (webserver/.../NodeWebServer.kt:
31,171-173): a separate process bridging HTTP to the node over RPC, hosting
app APIs and static content. Endpoints:

    GET  /api/status            node identity + flow counts
    GET  /api/network           network map snapshot
    GET  /api/notaries          notary identities
    GET  /api/vault             unconsumed states
    GET  /api/transactions      verified transaction ids
    GET  /api/flows             registered startable flows
    GET  /api/metrics           metric registry snapshot (JSON)
    GET  /metrics               same, Prometheus text exposition format
    GET  /healthz               liveness (200 when the server answers)
    GET  /readyz                readiness checks (200 ready / 503 not)
    GET  /debug/profile         kernel flight-recorder snapshot
    GET  /debug/requests        per-request lifecycle timelines (fleet)
    GET  /debug/critpath        critical-path blame + top-K slow traces
    GET  /debug/raft            consensus observatory: raft groups + shards
    GET  /api/timeseries        retained downsampled consensus time series
    GET  /api/fleet             fleet membership + per-worker load
    GET  /traces                span ring (tracing enabled: spans by trace)
    POST /api/flows/<FlowName>  body: JSON list of args -> run id / result
    GET  /web/<app>/<path>      static app content (staticServeDirs role)

Values render through a JSON-ifier that understands the framework's types
(parties, amounts, hashes, states) — the client/jackson role. Static dirs
come from ``static_dirs={"app-name": "/path/to/dir"}`` (the CordaPluginRegistry
staticServeDirs mapping, CordaPluginRegistry.kt:26).

A copy of the reference's module. Its Prometheus families keep the
reference's ``corda_tpu_`` prefix, so a scrape of either package's node
yields the same series names; ``/debug/profile`` serves this process's
profiler, whose per-kernel ``dispatches`` count the CUDA kernels' launches.
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def _escape_label(value: str) -> str:
    """Prometheus label-value escaping: backslash, double quote, newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _trace_duration_ms(spans) -> float:
    """A trace's headline duration for the /traces min_duration_ms filter:
    its longest single span (the root covers the whole tree on the commit
    path). Malformed spans contribute 0 — the filter never raises."""
    best = 0.0
    for s in spans if isinstance(spans, (list, tuple)) else ():
        d = s.get("duration_s") if isinstance(s, dict) else None
        if isinstance(d, (int, float)) and not isinstance(d, bool):
            best = max(best, float(d))
    return best * 1000.0


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _family(lines: list, name: str, mtype: str, help_text: str,
            samples: list) -> None:
    """Append one metric family: HELP + TYPE headers then its samples.
    Each sample is ``(suffix, labels_or_None, value, exemplar_or_None)``."""
    lines.append(f"# HELP {name} {_escape_help(help_text)}")
    lines.append(f"# TYPE {name} {mtype}")
    for suffix, labels, value, exemplar in samples:
        label_s = "" if not labels else "{" + ",".join(
            f'{k}="{_escape_label(v)}"' for k, v in labels) + "}"
        line = f"{name}{suffix}{label_s} {value}"
        if exemplar is not None:
            # OpenMetrics exemplar: links this bucket to a span in /traces
            tid = _escape_label(exemplar["trace_id"])
            line += (f' # {{trace_id="{tid}"}} '
                     f'{exemplar["value"]} {exemplar["ts"]:.3f}')
        lines.append(line)


def _entry_identity(name: str, fields) -> tuple[str, list]:
    """Snapshot entry → (family name, label pairs). Federated entries
    (observability/federation.py) carry ``family``/``labels`` metadata so
    N workers' copies of one family share a base name and differ only in
    their ``worker="..."`` label; plain entries are their own family with
    no labels."""
    labels: list = []
    family = name
    if isinstance(fields, dict):
        fam = fields.get("family")
        if isinstance(fam, str) and fam:
            family = fam
        lab = fields.get("labels")
        if isinstance(lab, dict):
            labels = sorted((str(k), str(v)) for k, v in lab.items())
    return family, labels


def prometheus_text(snapshot: dict) -> str:
    """Metric snapshot → Prometheus text exposition.

    Type-aware via the snapshot's ``type`` discriminator (utils/metrics
    MetricRegistry.snapshot): meters/timers render their count as a counter
    family plus rate/duration gauges, gauges carry their high-water mark as
    a second ``_max`` sample, histograms render cumulative ``_bucket{le=}``
    series with OpenMetrics exemplars (last traced observation per bucket,
    resolvable against /traces) plus ``_sum``/``_count`` and quantile
    gauges. Label values are escaped; names sanitized + corda_tpu_ prefix.
    Entries without a ``type`` fall back to one untyped sample per numeric
    field (older snapshots, ad-hoc dicts).

    Entries carrying ``family``/``labels`` metadata (worker-federated
    families) are GROUPED: one HELP/TYPE header per derived family, then
    one labeled sample per instance — N workers' ``SigBatcher.Flushes``
    become one ``corda_tpu_sigbatcher_flushes_count`` family with
    ``worker="w0"`` / ``worker="w1"`` samples, never duplicate headers."""
    groups: dict[str, dict] = {}
    for name, fields in snapshot.items():
        family, labels = _entry_identity(name, fields)
        base = "corda_tpu_" + re.sub(r"[^a-zA-Z0-9_]", "_", family).lower()
        g = groups.setdefault(base, {"family": family, "instances": []})
        g["instances"].append((labels, fields))

    lines: list = []
    for base in sorted(groups):
        name = groups[base]["family"]
        instances = sorted(groups[base]["instances"], key=lambda i: i[0])
        mtype = next((f.get("type") for _l, f in instances
                      if isinstance(f, dict) and f.get("type")), None)
        typed = [(labels or None, f) for labels, f in instances
                 if isinstance(f, dict) and f.get("type") == mtype]

        def samples(field, suffix=""):
            return [(suffix, labels, f[field], None) for labels, f in typed]

        if mtype == "meter":
            _family(lines, f"{base}_count", "counter",
                    f"Total events of {name}", samples("count"))
            _family(lines, f"{base}_mean_rate", "gauge",
                    f"Mean event rate of {name} (1/s)",
                    samples("mean_rate"))
        elif mtype == "timer":
            _family(lines, f"{base}_count", "counter",
                    f"Total timed operations of {name}", samples("count"))
            _family(lines, f"{base}_mean_s", "gauge",
                    f"Mean duration of {name} (s)", samples("mean_s"))
            _family(lines, f"{base}_max_s", "gauge",
                    f"Max duration of {name} (s)", samples("max_s"))
        elif mtype == "counter":
            _family(lines, f"{base}_value", "gauge",
                    f"Current value of {name}", samples("value"))
        elif mtype == "gauge":
            _family(lines, f"{base}_value", "gauge",
                    f"Current level of {name}", samples("value"))
            _family(lines, f"{base}_max", "gauge",
                    f"High-water mark of {name}", samples("max"))
        elif mtype == "gauge_fn":
            gauge_samples = [
                ("", labels, f.get("value"), None) for labels, f in typed
                if isinstance(f.get("value"), (int, float))
                and not isinstance(f.get("value"), bool)]
            if gauge_samples:
                _family(lines, f"{base}_value", "gauge",
                        f"Current value of {name}", gauge_samples)
        elif mtype == "histogram":
            hist_samples: list = []
            for labels, f in typed:
                exemplars = f.get("exemplars") or {}
                for le, cum in f.get("buckets", []):
                    hist_samples.append(
                        ("_bucket", (labels or []) + [("le", le)], cum,
                         exemplars.get(le)))
                hist_samples.append(("_sum", labels, f["sum"], None))
                hist_samples.append(("_count", labels, f["count"], None))
            _family(lines, base, "histogram",
                    f"Distribution of {name}", hist_samples)
            for q in ("max", "mean", "p50", "p90", "p99"):
                _family(lines, f"{base}_{q}", "gauge",
                        f"{q} of {name}", samples(q))
        else:
            # legacy/ad-hoc entry: one untyped sample per numeric field
            for labels, fields in instances:
                if not isinstance(fields, dict):
                    continue
                label_s = "" if not labels else "{" + ",".join(
                    f'{k}="{_escape_label(v)}"' for k, v in labels) + "}"
                for k, v in fields.items():
                    if isinstance(v, bool) or not isinstance(v, (int, float)):
                        continue
                    lines.append(f"{base}_{k}{label_s} {v}")
    return "\n".join(lines) + "\n"


class RouteNotFound(Exception):
    """Unknown endpoint — distinct from any KeyError an op might raise."""


def to_jsonable(value):
    """Framework object → JSON-safe structure (JacksonSupport's serializers)."""
    from ..core.contracts.amount import Amount
    from ..core.contracts.structures import StateAndRef, TransactionState
    from ..core.crypto.keys import PublicKey
    from ..core.crypto.secure_hash import SecureHash
    from ..core.identity import AbstractParty, CordaX500Name
    from ..core.transactions.signed import SignedTransaction
    from ..node.services import NodeInfo

    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, bytes):
        return value.hex()
    if isinstance(value, SecureHash):
        return str(value.bytes.hex())
    if isinstance(value, (CordaX500Name,)):
        return str(value)
    if isinstance(value, AbstractParty):
        return {"name": str(getattr(value, "name", None)),
                "owning_key": value.owning_key.to_string_short()}
    if isinstance(value, PublicKey):
        return value.to_string_short()
    if isinstance(value, Amount):
        return {"quantity": value.quantity, "token": str(value.token)}
    if isinstance(value, NodeInfo):
        return {"address": value.address,
                "legal_identity": to_jsonable(value.legal_identity),
                "advertised_services": [s.type for s in value.advertised_services]}
    if isinstance(value, StateAndRef):
        return {"ref": {"txhash": value.ref.txhash.bytes.hex(),
                        "index": value.ref.index},
                "state": to_jsonable(value.state)}
    if isinstance(value, TransactionState):
        return {"data": to_jsonable(value.data),
                "notary": to_jsonable(value.notary)}
    if isinstance(value, SignedTransaction):
        return {"id": value.id.bytes.hex(),
                "signatures": [s.by.to_string_short() for s in value.sigs]}
    if isinstance(value, (list, tuple, set, frozenset)):
        return [to_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {str(k): to_jsonable(v) for k, v in value.items()}
    if hasattr(value, "__dict__"):
        return {k: to_jsonable(v) for k, v in vars(value).items()
                if not k.startswith("_")}
    return repr(value)


class NodeWebServer:
    """Serve a CordaRPCOps (in-process) or CordaRPCClient (remote node)."""

    def __init__(self, ops, host: str = "127.0.0.1", port: int = 0,
                 pump=None, static_dirs: dict | None = None):
        self.ops = ops
        self.pump = pump          # MockNetwork.run_network for in-process use
        self.static_dirs = dict(static_dirs or {})
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply_raw(self, code: int, ctype: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _reply(self, code: int, payload) -> None:
                self._reply_raw(code, "application/json",
                                json.dumps(payload, indent=2).encode())

            def do_GET(self):
                if self.path.startswith("/web/"):
                    served = server.serve_static(self.path)
                    if served is None:
                        self._reply(404, {"error": f"not found: {self.path}"})
                    else:
                        self._reply_raw(200, *served)
                    return
                if self.path == "/healthz":   # liveness: we answered
                    self._reply(200, {"status": "ok"})
                    return
                if self.path == "/readyz":    # readiness: see rpc.health()
                    try:
                        health = server.handle_readyz()
                        self._reply(200 if health.get("ready") else 503,
                                    health)
                    except Exception as e:
                        self._reply(503, {"ready": False,
                                          "error": f"{type(e).__name__}: {e}"})
                    return
                if self.path == "/debug/profile":
                    try:
                        self._reply(200, server.handle_debug_profile())
                    except Exception as e:
                        self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                if (self.path == "/debug/requests"
                        or self.path.startswith("/debug/requests?")):
                    try:
                        self._reply(200, server.handle_debug_requests(
                            self.path))
                    except ValueError as e:
                        self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                    except Exception as e:
                        self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                if self.path == "/metrics":   # Prometheus scrape endpoint
                    try:
                        self._reply_raw(
                            200, "text/plain; version=0.0.4",
                            prometheus_text(server.ops.metrics_snapshot()
                                            ).encode())
                    except Exception as e:
                        self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                if (self.path == "/debug/critpath"
                        or self.path.startswith("/debug/critpath?")):
                    try:
                        self._reply(200, server.handle_debug_critpath(
                            self.path))
                    except ValueError as e:
                        self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                    except Exception as e:
                        self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                if (self.path == "/debug/raft"
                        or self.path.startswith("/debug/raft?")):
                    try:
                        self._reply(200, server.handle_debug_raft(self.path))
                    except ValueError as e:
                        self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                    except Exception as e:
                        self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                if (self.path == "/debug/soak"
                        or self.path.startswith("/debug/soak?")):
                    try:
                        self._reply(200, server.handle_debug_soak())
                    except Exception as e:
                        self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                if (self.path == "/api/timeseries"
                        or self.path.startswith("/api/timeseries?")):
                    try:
                        self._reply(200, server.handle_api_timeseries(
                            self.path))
                    except ValueError as e:
                        self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                    except Exception as e:
                        self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                if self.path == "/traces" or self.path.startswith("/traces?"):
                    try:
                        ctype, body = server.handle_traces(self.path)
                        self._reply_raw(200, ctype, body)
                    except ValueError as e:
                        self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                    except Exception as e:
                        self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                try:
                    self._reply(200, server.handle_get(self.path))
                except RouteNotFound:
                    self._reply(404, {"error": f"no such endpoint {self.path}"})
                except Exception as e:
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length) if length else b"[]"
                try:
                    args = json.loads(raw or b"[]")
                except ValueError as e:
                    self._reply(400, {"error": f"bad JSON body: {e}"})
                    return
                try:
                    self._reply(200, server.handle_post(self.path, args))
                except RouteNotFound:
                    self._reply(404, {"error": f"no such endpoint {self.path}"})
                except ValueError as e:   # bad arguments (client's fault)
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                except Exception as e:    # server-side failure
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    # -- routing -------------------------------------------------------------
    def handle_get(self, path: str):
        if path == "/api/status":
            info = self.ops.node_identity()
            return {"identity": to_jsonable(info),
                    "flows": len(self.ops.state_machines_snapshot())}
        if path == "/api/network":
            return to_jsonable(self.ops.network_map_snapshot())
        if path == "/api/notaries":
            return to_jsonable(self.ops.notary_identities())
        if path == "/api/vault":
            return to_jsonable(self.ops.vault_snapshot())
        if path == "/api/transactions":
            return [stx.id.bytes.hex()
                    for stx in self.ops.verified_transactions_snapshot()]
        if path == "/api/flows":
            return self.ops.registered_flows()
        if path == "/api/metrics":
            return self.ops.metrics_snapshot()
        if path == "/api/fleet":
            fleet_fn = getattr(self.ops, "fleet_status", None)
            return fleet_fn() if fleet_fn is not None else {}
        raise RouteNotFound(path)

    def handle_readyz(self) -> dict:
        """GET /readyz — the node's readiness checks (rpc.health). An ops
        object without ``health`` (a custom/remote proxy) degrades to ready:
        the probe should not fail a node it cannot introspect."""
        health_fn = getattr(self.ops, "health", None)
        if health_fn is None:
            return {"ready": True, "checks": {}}
        return health_fn()

    def handle_debug_profile(self) -> dict:
        """GET /debug/profile — the kernel flight recorder's snapshot,
        straight from the process profiler when the ops object does not
        expose its own (remote proxies do)."""
        profile_fn = getattr(self.ops, "profile_snapshot", None)
        if profile_fn is not None:
            return profile_fn()
        from ..observability import get_profiler
        return get_profiler().snapshot()

    def handle_debug_requests(self, path: str) -> dict:
        """GET /debug/requests — the newest per-request lifecycle
        timelines (observability/lifecycle.py RequestLog) from the ops
        object, empty for an ops surface without one. ``limit`` caps the
        number of requests returned."""
        from urllib.parse import parse_qs, urlsplit
        q = parse_qs(urlsplit(path).query)
        limit_raw = q.get("limit", [None])[0]
        limit = int(limit_raw) if limit_raw is not None else None
        timelines_fn = getattr(self.ops, "request_timelines", None)
        if timelines_fn is None:
            return {"requests": {}}
        return {"requests": timelines_fn(limit)}

    def handle_debug_critpath(self, path: str) -> dict:
        """GET /debug/critpath — tail forensics: per-flow-class blame
        decomposition and the top-K slowest transactions with annotated
        blocking chains (observability/critpath.py). ``top_k`` caps the
        slow-transaction list. Served from the ops object when it exposes
        ``critpath_report`` (the node RPC surface), straight off the
        process tracer otherwise; always well-formed, empty when tracing
        is off."""
        from urllib.parse import parse_qs, urlsplit
        q = parse_qs(urlsplit(path).query)
        top_raw = q.get("top_k", [None])[0]
        top_k = int(top_raw) if top_raw is not None else 10
        report_fn = getattr(self.ops, "critpath_report", None)
        if report_fn is not None:
            return report_fn(top_k)
        from ..observability import critpath, get_tracer
        return critpath.critpath_report(get_tracer().traces(), top_k=top_k)

    def handle_debug_raft(self, path: str) -> dict:
        """GET /debug/raft — the consensus observatory: per-raft-group
        introspection (leader, term, log length, election episodes,
        commit-path attribution percentiles) plus shard heat/skew when
        the node notarises over a sharded uniqueness provider. Served
        from the ops object when it exposes ``raft_report`` (the node
        RPC surface); an ops surface without one answers with empty
        groups — scraping any node is safe."""
        report_fn = getattr(self.ops, "raft_report", None)
        if report_fn is None:
            return {"groups": {}}
        return report_fn()

    def handle_debug_soak(self) -> dict:
        """GET /debug/soak — the soak observatory's live view: every
        structure registered with the resource accounting plane (size,
        declared kind, leak verdict over its retained ``Resource.*``
        series) plus the subsystem CPU-attribution snapshot when a
        profiler is running (observability/soak.py). Served from the ops
        object when it exposes ``soak_report``, straight off the process
        globals otherwise; well-formed and empty on a node with no
        registered probes — scraping any node is safe."""
        report_fn = getattr(self.ops, "soak_report", None)
        if report_fn is not None:
            return report_fn()
        from ..observability.soak import soak_report
        return soak_report()

    def handle_api_timeseries(self, path: str) -> dict:
        """GET /api/timeseries — the retained time-series plane:
        downsampled multi-resolution history of the consensus gauges
        (observability/timeseries.py). ``names`` (comma-separated)
        filters to specific series; ``limit`` caps rows returned per
        resolution ring. Served from the ops object when it exposes
        ``timeseries_snapshot``, straight off the process store
        otherwise; well-formed and empty when nothing was recorded."""
        from urllib.parse import parse_qs, urlsplit
        q = parse_qs(urlsplit(path).query)
        names_raw = q.get("names", [None])[0]
        names = [n for n in names_raw.split(",") if n] \
            if names_raw is not None else None
        limit_raw = q.get("limit", [None])[0]
        limit = int(limit_raw) if limit_raw is not None else None
        if limit is not None and limit < 1:
            raise ValueError(f"limit must be >= 1, got {limit}")
        # incremental-poll filters (soak observatory): ``since`` drops
        # buckets starting before that absolute epoch time, ``resolution``
        # keeps only the ring with that bucket width (e.g. 60 for the
        # coarse leak-fit ring)
        since_raw = q.get("since", [None])[0]
        since = float(since_raw) if since_raw is not None else None
        res_raw = q.get("resolution", [None])[0]
        resolution = float(res_raw) if res_raw is not None else None
        if resolution is not None and resolution <= 0:
            raise ValueError(f"resolution must be > 0, got {resolution}")
        snap_fn = getattr(self.ops, "timeseries_snapshot", None)
        if snap_fn is not None:
            try:
                return snap_fn(names, limit, since, resolution)
            except TypeError:
                # ops surface predating the soak filters: serve unfiltered
                # rather than 500 — the poller just gets more data
                return snap_fn(names, limit)
        from ..observability import get_timeseries
        return get_timeseries().snapshot(names=names, limit=limit,
                                         since=since, resolution=resolution)

    def handle_traces(self, path: str) -> tuple[str, bytes]:
        """GET /traces — spans from the live tracer's ring buffer.

        Query params: ``trace_id`` filters to one trace; ``limit`` caps
        returned spans (newest kept); ``min_duration_ms`` keeps only
        traces whose longest span is at least that long (the pull handle
        for a slow transaction surfaced by /debug/critpath's top-K);
        ``format=jsonl`` streams one span per line (the export format)
        instead of the grouped-JSON default. With tracing disabled (the
        no-op default) the answer is well-formed and empty — scraping is
        always safe."""
        from urllib.parse import parse_qs, urlsplit
        from ..observability import get_tracer
        q = parse_qs(urlsplit(path).query)
        trace_id = q.get("trace_id", [None])[0]
        limit_raw = q.get("limit", [None])[0]
        limit = int(limit_raw) if limit_raw is not None else None
        min_raw = q.get("min_duration_ms", [None])[0]
        min_ms = float(min_raw) if min_raw is not None else None
        fmt = q.get("format", ["json"])[0]
        tracer = get_tracer()
        if fmt == "jsonl":
            ring = getattr(tracer, "ring", None)
            body = ring.to_jsonl(trace_id=trace_id, limit=limit) if ring \
                else ""
            return "application/x-ndjson", body.encode()
        if trace_id is not None:
            spans = tracer.trace(trace_id)
            if limit is not None:
                spans = spans[-limit:]
            payload = {"enabled": tracer.enabled, "trace_id": trace_id,
                       "spans": spans}
        else:
            traces = tracer.traces(limit_spans=limit)
            if min_ms is not None:
                traces = {tid: spans for tid, spans in traces.items()
                          if _trace_duration_ms(spans) >= min_ms}
            payload = {"enabled": tracer.enabled, "traces": traces}
        return "application/json", json.dumps(payload, indent=2).encode()

    def handle_post(self, path: str, args):
        prefix = "/api/flows/"
        if path.startswith(prefix):
            flow_name = path[len(prefix):]
            parsed = [self._parse_arg(a) for a in args]
            fsm = self.ops.start_flow_dynamic(flow_name, *parsed)
            if self.pump is not None:
                self.pump()
            done = fsm.result_future.done()
            out = {"run_id": fsm.run_id, "done": done}
            if done:
                try:
                    out["result"] = to_jsonable(fsm.result_future.result())
                except Exception as e:
                    out["error"] = f"{type(e).__name__}: {e}"
            return out
        raise RouteNotFound(path)

    def serve_static(self, path: str):
        """/web/<app>/<file...> → (content type, bytes) from the app's
        registered static dir, or None. Query strings are stripped, percent
        escapes decoded, and the REAL resolved path (symlinks followed) must
        stay inside the registered directory — traversal-safe even against a
        symlink planted in the app dir."""
        import mimetypes
        import os
        from urllib.parse import unquote, urlsplit
        path = unquote(urlsplit(path).path)
        parts = path[len("/web/"):].split("/", 1)
        app = parts[0]
        rel = parts[1] if len(parts) > 1 and parts[1] else "index.html"
        root = self.static_dirs.get(app)
        if root is None:
            return None
        root = os.path.realpath(root)
        full = os.path.realpath(os.path.join(root, rel))
        if not full.startswith(root + os.sep) or not os.path.isfile(full):
            return None
        ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
        with open(full, "rb") as f:
            return ctype, f.read()

    def _parse_arg(self, arg):
        """JSON arg → framework value: {"amount": n, "currency": "USD"},
        {"party": "O=..."}, {"hex": "0a0b"}, or plain JSON scalars."""
        from ..core.contracts.amount import Amount, currency
        if isinstance(arg, dict):
            if "amount" in arg:
                return Amount(arg["amount"], currency(arg.get("currency", "USD")))
            if "party" in arg:
                party = self.ops.well_known_party_from_x500_name(arg["party"])
                if party is None:
                    raise ValueError(f"unknown party {arg['party']!r}")
                return party
            if "hex" in arg:
                return bytes.fromhex(arg["hex"])
        return arg

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "NodeWebServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
