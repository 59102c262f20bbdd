"""Consensus backends for the clustered notary (reference: Copycat Raft via
RaftUniquenessProvider.kt, BFT-SMaRt via BFTSMaRt.kt)."""
from .raft import RaftNode, RaftState  # noqa: F401
from .raft_uniqueness import RaftUniquenessProvider  # noqa: F401
from .bft import (BFTClient, BFTReplica, BFTUniquenessProvider)  # noqa: F401
