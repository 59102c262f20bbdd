"""Standalone verifier worker process — ``python -m corda_tpu_torch.verifier``.

Reference parity: Verifier.main (verifier/src/main/.../Verifier.kt:42-79) —
a leaf process that attaches to a node's verification queue, consumes
requests, verifies, replies. Stateless: run N copies against one queue;
killing one redistributes its outstanding work (the node's redelivery
timeout or Goodbye handling, VerifierTests.kt:73+).

The worker runs the signature EC math through its own ``SignatureBatcher``
on the port's CUDA kernels — consecutive requests' signatures coalesce into
one device batch, so N worker processes = N cards of cross-transaction
batched verification behind one competing-consumer queue.

Prints ``VERIFIER READY <host>:<port>`` on stdout once attached (the driver
DSL's readiness handshake, like the node's NODE READY line). On SIGTERM it
writes batcher metrics to ``--stats-file`` (if given) so tests can assert
device-verified work happened in this process, then exits cleanly.

A copy of the reference's module. The worker runs on the card unless asked
otherwise: ``--device`` (default "cuda"; "cpu" runs the plain kernels) is
the device its batcher's kernels run on, and ``--no-device`` keeps the
reference's meaning, the host route. ``--mesh-devices N`` shards over a
``parallel.make_mesh`` of N devices; ``--num-shards`` / ``--shard-index``
take one group of ``parallel.shard_devices``: a mesh of it when it holds
several devices, a ``device=`` pin when it holds one. The kernels build once
into ``corda_tpu_torch/_build/`` (no compile cache to configure). The stats
file also carries ``launches``: this process's launches of the three
batcher kernels (B2, B3, B4).
"""
from __future__ import annotations

import argparse
import importlib
import json
import signal
import sys
import threading


def _literal_resolve(name: str):
    """Workers address peers only as literal "host:port" strings."""
    host, _, port = name.rpartition(":")
    try:
        return host, int(port)
    except ValueError:
        return None


def _queue_resolver(queue_address: str):
    """A worker serves one node's queue: a literal "host:port" resolves as
    itself, and any other name (a Node's out-of-process service replies
    under its legal name) is that node, at the queue's address."""
    queue = _literal_resolve(queue_address)

    def resolve(name: str):
        return _literal_resolve(name) or queue
    return resolve


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="corda_tpu_torch.verifier")
    parser.add_argument("--queue-address", required=True,
                        help="host:port of the node whose queue to consume")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--no-device", action="store_true",
                        help="host-only verification (no kernels)")
    parser.add_argument("--device", default="cuda",
                        help="device of the batcher's kernels (default "
                             "cuda, the card; cpu runs the plain kernels)")
    parser.add_argument("--host-crossover", type=int, default=None,
                        help="batches below this run on host (default: "
                             "the batcher's measured crossover)")
    parser.add_argument("--mesh-devices", type=int, default=None,
                        help="shard device batches over the first N local "
                             "CUDA devices (a parallel.Mesh; Verifier.kt's "
                             "scale-out seam, one process instead of N)")
    parser.add_argument("--num-shards", type=int, default=None,
                        help="fleet mode: split the visible devices into N "
                             "contiguous shards; this worker takes shard "
                             "--shard-index (run N workers, one per shard)")
    parser.add_argument("--shard-index", type=int, default=0,
                        help="which device shard this worker owns "
                             "(with --num-shards)")
    parser.add_argument("--capacity", type=int, default=None,
                        help="advertised relative capacity (default: the "
                             "shard's device count; the node router "
                             "normalizes load estimates by it)")
    parser.add_argument("--load-report-interval", type=float, default=0.5,
                        help="seconds between WorkerLoadReports to the node "
                             "router (0 disables)")
    parser.add_argument("--stats-file",
                        help="write batcher metrics JSON here on shutdown")
    parser.add_argument("--cordapp", action="append", default=None,
                        help="modules to import so contract/state types "
                             "deserialize (default: corda_tpu_torch.finance + "
                             "corda_tpu_torch.testing.dummy)")
    args = parser.parse_args(argv)

    for module in (args.cordapp if args.cordapp is not None
                   else ["corda_tpu_torch.finance", "corda_tpu_torch.testing.dummy"]):
        importlib.import_module(module)

    import torch

    from ..network.tcp import TcpMessagingService
    from .batcher import SignatureBatcher
    from .out_of_process import VerifierWorker

    messaging = TcpMessagingService("verifier-worker", args.host, args.port,
                                    _queue_resolver(args.queue_address))
    # the worker's reachable address IS its identity: the node replies and
    # deals work to exactly this host:port (no network-map registration,
    # same as the reference worker attaching straight to the broker)
    messaging._name = f"{args.host}:{messaging.port}"

    batcher_kwargs = {"use_device": not args.no_device}
    if args.host_crossover is not None:
        batcher_kwargs["host_crossover"] = args.host_crossover
    device_shard: tuple = ()
    if args.mesh_devices is not None and args.num_shards is not None:
        parser.error("--mesh-devices and --num-shards are exclusive: a "
                     "fleet worker owns a device shard, not the whole mesh")
    device = torch.device(args.device)
    # on the card the visible CUDA devices; elsewhere shards of the one
    # device asked for
    pool = (None if device.type == "cuda"
            else [device] * max(args.mesh_devices or 1, args.num_shards or 1))
    if args.mesh_devices is not None:
        from ..parallel import make_mesh
        batcher_kwargs["mesh"] = make_mesh(args.mesh_devices, devices=pool)
    elif args.num_shards is not None and not args.no_device:
        # fleet mode: this worker owns one contiguous shard of the visible
        # devices — a private mesh when the shard has several cards, a
        # plain device pin (no sharding overhead) when it has one
        from ..parallel import shard_devices
        shard = shard_devices(args.num_shards, devices=pool)[args.shard_index]
        device_shard = tuple(d.index for d in shard if d.index is not None)
        if len(shard) > 1:
            from ..parallel import make_mesh
            batcher_kwargs["mesh"] = make_mesh(devices=shard)
        else:
            batcher_kwargs["device"] = shard[0]
    else:
        batcher_kwargs["device"] = device
    batcher = SignatureBatcher(**batcher_kwargs)
    worker = VerifierWorker(
        messaging, args.queue_address, batcher=batcher,
        use_device=not args.no_device,
        hello_interval_s=3.0,
        device_shard=device_shard, capacity=args.capacity,
        load_report_interval_s=(args.load_report_interval
                                if args.load_report_interval > 0 else None))

    print(f"VERIFIER READY {args.host}:{messaging.port}", flush=True)

    done = threading.Event()

    def _shutdown(signum, frame):
        done.set()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)
    done.wait()

    if args.stats_file:
        from ..ops import ed25519, weierstrass
        snap = batcher.metrics.snapshot()
        with open(args.stats_file, "w") as f:
            json.dump({"verified_count": worker.verified_count,
                       "processed_sig_count": worker.processed_sig_count,
                       "device_shard": list(worker.device_shard),
                       "metrics": snap,
                       "launches": {
                           "ed25519_split_verify":
                               ed25519.verify_core_split.launches,
                           "secp256k1_hybrid_verify":
                               weierstrass.verify_core_hybrid_wide.launches,
                           "secp256r1_split_verify":
                               weierstrass.verify_core_r1_split.launches}}, f)
    worker.stop()
    messaging.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
