"""The port's graft entry points: a single-card kernel call and the
multi-device dry run.

The twin of the repository's ``__graft_entry__.py`` (``entry``,
``dryrun_multichip``, ``_dryrun_service_seam``, ``_dryrun_config_mesh_node``,
``_dryrun_fleet``) on the port's devices: a mesh is a
``corda_tpu_torch.parallel.Mesh`` of ``torch.device``s, by default the
visible CUDA devices. Asking for more devices than the cards present gives
shards of one card (one CUDA stream a shard), as the sharded path does; the
node built from configuration (``mesh_devices``) takes one shard a distinct
device, as a node's configuration does.

    python -m corda_tpu_torch.graft_entry [N_DEVICES]

runs ``dryrun_multichip(N_DEVICES)`` (default 2) on the card; its last line
of standard output is ``fleet_bench``'s one-line JSON.
"""
from __future__ import annotations

import functools
import hashlib
import json
import sys

import numpy as np

#: The reference's sizes: the service seam's burst of signature checks, and
#: the fleet stage's groups a worker and group size (group_size == the
#: batcher's ladder floor and max_inflight_groups == 2 bound the coalesced
#: batch shapes to two rungs, 256 and 512).
SERVICE_BATCH = 8192
FLEET_GROUPS_PER_WORKER, FLEET_GROUP_SIZE = 16, 256
#: The configuration-built node's signature burst (the reference's 2048:
#: above the batcher's host crossover, so its own routing takes the mesh).
CONFIG_NODE_BURST = 2048


def _example_ed25519_items(n: int):
    from .core.crypto import ecmath

    rng = np.random.default_rng(0)
    items = []
    for _ in range(n):
        seed = rng.bytes(32)
        pub = ecmath.ed25519_public_key(seed)
        msg = rng.bytes(32)
        sig = ecmath.ed25519_sign(seed, msg)
        items.append((pub, sig, msg))
    return items


def _example_ed25519_batch(n: int):
    """Deterministic (pub, sig, msg) triples → the Shamir kernel's wire
    arrays (the combined multi-device step's layout)."""
    from .ops import ed25519 as ed_ops

    s_bits, k_bits, neg_a, r_affine, _ = ed_ops.prepare_batch(
        _example_ed25519_items(n))
    return s_bits, k_bits, neg_a, r_affine


def entry(device="cuda"):
    """(fn, example_args): a batch of 8 Ed25519 signature verifications on
    the windowed kernel (B7; constant-B Niels table), its tensors on
    ``device``. ``fn(*example_args)`` launches the kernel on the card (the
    plain version for CPU tensors) and returns ok (8,) bool."""
    from .device import resolve_device
    from .ops import ed25519 as ed_ops

    dev = resolve_device(device)
    *head, _ = ed_ops.prepare_batch_windowed(
        _example_ed25519_items(8), ed_ops.B_WINDOW, device_tables=False)
    args = (*ed_ops.b7_to_device(head, dev), *ed_ops.windowed_table(dev))
    return (functools.partial(ed_ops.verify_core_windowed,
                              w=ed_ops.B_WINDOW), args)


def mesh_devices(n_devices: int, devices=None) -> list:
    """``n_devices`` shard devices taken round-robin from ``devices``
    (default: every visible CUDA device, raising without CUDA): more shards
    than cards put several shards on one card."""
    from .parallel.sharded import _visible_devices

    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    pool = list(devices) if devices is not None else _visible_devices()
    return [pool[i % len(pool)] for i in range(n_devices)]


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run the sharded verification step over an ``n_devices`` mesh on tiny
    shapes (Ed25519 checks batch-sharded, Merkle leaves leaf-sharded with
    the root combined on the first device), then the service seam over the
    mesh, then the fleet stage, whose one-line JSON is the last line
    printed. ``devices`` (default: the visible CUDA devices) are the
    devices the mesh's shards are dealt from."""
    from .ops import sha256 as sha_ops
    from .parallel import make_mesh, tx_verify_step

    mesh = make_mesh(devices=mesh_devices(n_devices, devices))
    s_bits, k_bits, neg_a, r_affine = _example_ed25519_batch(2 * n_devices)
    leaves = sha_ops.digests_from_bytes(
        [hashlib.sha256(bytes([i])).digest() for i in range(4 * n_devices)])
    step = tx_verify_step(mesh)
    ok, root = step(s_bits, k_bits, neg_a, r_affine, leaves)
    assert bool(ok.cpu().numpy().all()), "all example signatures must verify"
    assert tuple(root.shape) == (8,)

    _dryrun_service_seam(mesh)
    _dryrun_config_mesh_node(len(set(mesh.devices)),
                             device=mesh.devices[0].type)
    # LAST stdout act: the fleet stage's one-line JSON aggregate
    _dryrun_fleet(n_devices, devices=list(mesh.devices))


def _dryrun_config_mesh_node(n_devices: int, device: str = "cuda") -> None:
    """Multi-device reachable from CONFIGURATION alone: boot a production
    Node with ``verifier_type=Tpu, mesh_devices=N`` on ``device`` (no code
    here constructs a mesh) and attest that a device-scale signature burst
    shards over every device of the configuration-built mesh."""
    import tempfile

    from .core.crypto import ecmath
    from .core.crypto.keys import PublicKey
    from .core.crypto.schemes import EDDSA_ED25519_SHA512
    from .node.node import Node, NodeConfiguration

    with tempfile.TemporaryDirectory() as tmp:
        cfg = NodeConfiguration(
            my_legal_name="O=MeshNode, L=London, C=GB",
            base_directory=tmp, verifier_type="Tpu",
            mesh_devices=n_devices, device=device,
            cordapps=["corda_tpu_torch.finance",
                      "corda_tpu_torch.testing.dummy"])
        node = Node(cfg).start()
        try:
            svc = node.services.verifier_service
            assert svc.batcher.mesh is not None \
                and svc.batcher.mesh.size == n_devices, \
                "config did not build the mesh"
            # device-scale burst (above the host crossover, so the default
            # routing policy itself chooses the sharded device path)
            rng = np.random.default_rng(11)
            unique = []
            for _ in range(16):
                seed = rng.bytes(32)
                pub = ecmath.ed25519_public_key(seed)
                msg = rng.bytes(32)
                sig = ecmath.ed25519_sign(seed, msg)
                unique.append((PublicKey(EDDSA_ED25519_SHA512, pub), sig, msg))
            burst = CONFIG_NODE_BURST
            triples = (unique * (burst // len(unique) + 1))[:burst]
            futures = svc.batcher.submit_many(triples)
            assert all(f.result(timeout=600) for f in futures)
            snap = svc.batcher.metrics.snapshot()
            assert snap["SigBatcher.DeviceChecked"]["count"] >= burst, \
                "burst did not ride the mesh-sharded device path"
        finally:
            node.stop()


def _dryrun_fleet(n_devices: int, devices=None) -> None:
    """Verifier fleet over the mesh's shard devices: one worker per device,
    each with a device-pinned SignatureBatcher, behind the out-of-process
    queue's load-aware router and work stealing (verifier.fleet). Emits ONE
    JSON line — fleet_bench's fields — as the stage's only stdout.
    ``devices`` are the shard devices as given (``dryrun_multichip`` passes
    its mesh's); without them, ``mesh_devices`` deals them."""
    from .verifier.fleet import fleet_bench

    if devices is None:
        devices = mesh_devices(n_devices)
    out = fleet_bench(n_devices, groups=FLEET_GROUPS_PER_WORKER * n_devices,
                      group_size=FLEET_GROUP_SIZE, use_device=True,
                      devices=devices, host_crossover=0)
    assert all(c > 0 for c in out["per_worker_sigs"].values()), \
        "every fleet worker must have verified work"
    print(json.dumps(out), flush=True)


class _IssuanceServices:
    """What verify_signed resolves an issuance against: no input states, no
    attachments."""

    def __init__(self):
        self.attachments = self

    def load_state(self, ref):
        return None

    def open_attachment(self, att_id):
        return None


def _dryrun_service_seam(mesh) -> None:
    """Drive the SERVICE seam over the mesh: a mesh-backed SignatureBatcher
    shards a SERVICE_BATCH-signature burst over every shard, and the
    TpuTransactionVerifierService verifies full SignedTransactions through
    the same batcher."""
    from .core.contracts.structures import Command, TransactionState
    from .core.crypto import ecmath, generate_keypair
    from .core.crypto.keys import PublicKey
    from .core.crypto.schemes import EDDSA_ED25519_SHA512
    from .core.crypto.signatures import Crypto
    from .core.identity import Party
    from .core.transactions.signed import SignedTransaction
    from .core.transactions.wire import WireTransaction
    from .testing.dummy import DummyContract, DummyState
    from .verifier.service import TpuTransactionVerifierService

    service = TpuTransactionVerifierService(mesh=mesh)
    service.batcher.host_crossover = 0      # force the device path
    service.batcher.max_latency_s = 0.05    # coalesce the burst
    batch = SERVICE_BATCH
    try:
        # a few distinct signatures tiled (host Ed25519 signing is Python)
        rng = np.random.default_rng(7)
        unique = []
        for _ in range(min(32, batch)):
            seed = rng.bytes(32)
            pub = ecmath.ed25519_public_key(seed)
            msg = rng.bytes(32)
            sig = ecmath.ed25519_sign(seed, msg)
            unique.append((PublicKey(EDDSA_ED25519_SHA512, pub), sig, msg))
        triples = (unique * (batch // len(unique) + 1))[:batch]
        futures = service.batcher.submit_many(triples)
        assert all(f.result(timeout=600) for f in futures), \
            "sharded service batch must verify"
        snap = service.batcher.metrics.snapshot()
        assert snap["SigBatcher.DeviceChecked"]["count"] >= batch

        # the full service API: SignedTransactions end to end
        notary = Party("O=Dryrun Notary, L=Zurich, C=CH",
                       generate_keypair(entropy=b"\x71" * 32).public)
        kp = generate_keypair(entropy=b"\x72" * 32)
        services = _IssuanceServices()
        stx_futures = []
        for i in range(4):
            wtx = WireTransaction(
                outputs=(TransactionState(
                    DummyState(i, (kp.public,)), notary),),
                commands=(Command(DummyContract.Create(), (kp.public,)),),
                notary=notary, must_sign=(kp.public,))
            stx = SignedTransaction.of(
                wtx, [Crypto.sign_with_key(kp, wtx.id.bytes)])
            stx_futures.append(service.verify_signed(stx, services))
        for f in stx_futures:
            f.result(timeout=600)
    finally:
        service.shutdown()


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
