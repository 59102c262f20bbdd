"""Client libraries (the reference's client/rpc, client/jackson layer)."""
from .rpc import CordaRPCClient, RPCException  # noqa: F401
