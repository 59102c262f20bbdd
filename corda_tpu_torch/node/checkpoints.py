"""Checkpoint model + storage for the replay-based flow state machine.

Reference parity: CheckpointStorage (node/services/api/CheckpointStorage.kt:10-28)
and DBCheckpointStorage (persistence/DBCheckpointStorage.kt:18-25). A checkpoint
here is NOT a serialized continuation (no Quasar): it is the *replay record* —
flow class + flow fields + the ordered responses consumed at each yield + the
session table. Resume = re-execute `call()` feeding the log (the flows
module docstring).

`FileCheckpointStorage` adds crash-durable atomic persistence (one file per
checkpoint, write-tmp-then-rename — the node_checkpoints table analog).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..core.serialization import deserialize, serialize


@dataclass
class SessionSnapshot:
    """Persisted session state (statemachine session table row)."""

    peer_name: str
    our_session_id: int
    peer_session_id: int | None
    state: str
    received: list
    pending_out: list
    group: int = 0  # session group (sub-flow keying, statemachine)


@dataclass
class Checkpoint:
    run_id: str
    flow_class: str           # importable "module.QualName"
    flow_fields: dict         # flow __dict__ minus injected attrs
    response_log: list        # ordered responses consumed at yields
    sessions: list = field(default_factory=list)  # SessionSnapshot list

    @property
    def id(self) -> str:
        return self.run_id


class CheckpointStorage:
    """In-memory checkpoint store (reference CheckpointStorage SPI)."""

    def __init__(self):
        self._checkpoints: dict[str, Checkpoint] = {}

    def add_checkpoint(self, cp: Checkpoint) -> None:
        self._checkpoints[cp.id] = cp

    def remove_checkpoint(self, cp_or_id) -> None:
        cp_id = cp_or_id if isinstance(cp_or_id, str) else cp_or_id.id
        self._checkpoints.pop(cp_id, None)

    def get_all_checkpoints(self) -> list[Checkpoint]:
        return list(self._checkpoints.values())


class FileCheckpointStorage(CheckpointStorage):
    """Durable variant: canonical-codec blobs, atomic replace per checkpoint."""

    def __init__(self, directory: str):
        super().__init__()
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        for name in os.listdir(directory):
            if name.endswith(".ckpt"):
                with open(os.path.join(directory, name), "rb") as f:
                    cp = _checkpoint_from_bytes(f.read())
                self._checkpoints[cp.id] = cp

    def _path(self, cp_id: str) -> str:
        return os.path.join(self.directory, f"{cp_id}.ckpt")

    def add_checkpoint(self, cp: Checkpoint) -> None:
        super().add_checkpoint(cp)
        tmp = self._path(cp.id) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_checkpoint_to_bytes(cp))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(cp.id))

    def remove_checkpoint(self, cp_or_id) -> None:
        cp_id = cp_or_id if isinstance(cp_or_id, str) else cp_or_id.id
        super().remove_checkpoint(cp_id)
        try:
            os.remove(self._path(cp_id))
        except FileNotFoundError:
            pass


class KvCheckpointStorage(CheckpointStorage):
    """Checkpoints on the native kvlog engine (the storage package): synced
    crc-framed appends with torn-tail recovery — the DBCheckpointStorage
    durability class without an embedded SQL database."""

    def __init__(self, path: str, use_native: bool | None = None):
        super().__init__()
        from ..storage import KvStore
        self._kv = KvStore(path, use_native=use_native)
        for key, blob in self._kv.items():
            cp = _checkpoint_from_bytes(blob)
            self._checkpoints[cp.id] = cp

    def add_checkpoint(self, cp: Checkpoint) -> None:
        super().add_checkpoint(cp)
        self._kv[cp.id.encode()] = _checkpoint_to_bytes(cp)

    def remove_checkpoint(self, cp_or_id) -> None:
        cp_id = cp_or_id if isinstance(cp_or_id, str) else cp_or_id.id
        super().remove_checkpoint(cp_id)
        key = cp_id.encode()
        if key in self._kv:
            del self._kv[key]

    def close(self) -> None:
        self._kv.close()


def _checkpoint_to_bytes(cp: Checkpoint) -> bytes:
    return serialize([
        cp.run_id, cp.flow_class, cp.flow_fields, cp.response_log,
        [[s.peer_name, s.our_session_id, s.peer_session_id, s.state,
          s.received, s.pending_out, s.group] for s in cp.sessions]])


def _checkpoint_from_bytes(data: bytes) -> Checkpoint:
    run_id, flow_class, fields, log, sessions = deserialize(data)
    return Checkpoint(run_id, flow_class, fields, log,
                      [SessionSnapshot(*s) for s in sessions])
