"""Node CLI entry: ``python -m corda_tpu_torch.node --config node.json`` or flags.

Reference parity: NodeStartup.main (node/internal/NodeStartup.kt:1-326) —
parse config, print the banner, start the node, run until interrupted.

A copy of the reference's module with two flags of the port's own.
``--device`` is the device of the node's own device work and its Tpu
verifier: "cuda" (the card) unless given, or unless a ``--config`` file
names another; without CUDA a node on "cuda" raises at boot, with no
fallback to the CPU. ``--host-crossover`` (``--verifier-type Tpu`` only)
sets the batcher's crossover, as the worker's flag of that name does:
batches below it verify on the host.
"""
from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from .node import Node, NodeConfiguration

BANNER = r"""
   ____ ___  ____  ____  _        _____ ____  _   _
  / ___/ _ \|  _ \|  _ \/ \      |_   _|  _ \| | | |
 | |  | | | | |_) | | | | |  _____ | | | |_) | | | |
 | |__| |_| |  _ <| |_| | |_|_____|| | |  __/| |_| |
  \____\___/|_| \_\____/|_____|    |_| |_|    \___/
  distributed ledger, on PyTorch and CUDA
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="corda_tpu_torch.node")
    parser.add_argument("--config", help="JSON NodeConfiguration file")
    parser.add_argument("--name", help="legal name (O=..., L=..., C=..)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--base-dir", default=".")
    parser.add_argument("--network-map-name")
    parser.add_argument("--network-map-address")
    parser.add_argument("--notary", choices=["simple", "validating"])
    parser.add_argument("--verifier-type", default="InMemory")
    parser.add_argument("--mesh-devices", type=int, default=None,
                        help="with --verifier-type Tpu: shard device "
                             "batches over the first N local CUDA "
                             "devices")
    parser.add_argument("--device", default=None,
                        help="device of the node's device work and its Tpu "
                             "verifier (default: the --config file's, else "
                             "cuda, the card; cpu runs the plain kernels)")
    parser.add_argument("--host-crossover", type=int, default=None,
                        help="with --verifier-type Tpu: batches below this "
                             "run on the host (default: the batcher's "
                             "measured crossover)")
    parser.add_argument("--cordapp", action="append", default=None,
                        help="extra module to load as a cordapp (repeatable)")
    parser.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO if not args.quiet else logging.WARN,
                        format="%(asctime)s %(levelname)-5s %(name)s: %(message)s")
    if args.config:
        config = NodeConfiguration.load(args.config)
    else:
        if not args.name:
            parser.error("--name or --config is required")
        config = NodeConfiguration(
            my_legal_name=args.name, host=args.host, port=args.port,
            base_directory=args.base_dir,
            network_map_name=args.network_map_name,
            network_map_address=args.network_map_address,
            notary=args.notary, verifier_type=args.verifier_type,
            mesh_devices=args.mesh_devices)
        if args.cordapp:
            config.cordapps = config.cordapps + args.cordapp
    if args.device is not None:
        config.device = args.device
    if args.host_crossover is not None and config.verifier_type != "Tpu":
        parser.error("--host-crossover requires --verifier-type Tpu")

    if not args.quiet:
        print(BANNER)
    node = Node(config)
    if args.host_crossover is not None:
        node.services.verifier_service.batcher.host_crossover = \
            args.host_crossover
    node.start()
    # the driver greps for this line to know the node is ready
    print(f"NODE READY {node.party.name} {config.host}:{node.messaging.port}",
          flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    node.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
