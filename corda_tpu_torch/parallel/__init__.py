"""Multi-device parallelism: meshes and sharded verification (B9).

Port of corda_tpu/parallel. The reference scales verification by SPMD over
a JAX ``Mesh`` of chips; here a :class:`Mesh` is an ordered list of
``torch.device``s driven by one host thread, each shard on a CUDA stream of
its own: signature batches are cut along the batch axis, Merkle leaf
batches along the leaf axis with the local roots gathered onto the first
device for the top of the tree.
"""
from .sharded import (  # noqa: F401
    Mesh,
    make_mesh,
    make_shard_mesh,
    shard_devices,
    sharded_ecdsa_verify,
    sharded_ecdsa_verify_hybrid,
    sharded_ecdsa_verify_r1_split,
    sharded_ed25519_verify,
    sharded_ed25519_verify_split,
    sharded_ed25519_verify_windowed,
    sharded_merkle_root,
    sharded_verify_batch_ed25519,
    sharded_verify_batch_secp256k1,
    sharded_verify_batch_secp256k1_words,
    sharded_verify_batch_secp256r1_words,
    tx_verify_step,
)
