"""Pluggable node-process runners: local subprocesses or SSH-managed hosts.

Reference parity: the loadtest drives a REMOTE cluster over SSH with
disruption injection (LoadTest.kt:1-211 connectToNodes, NodeConnection.kt's
ssh session + process control, Disruption.kt:17-105 kill/hang via remote
shell commands).  Here process control (spawn / terminate / kill / SIGSTOP
/ SIGCONT / log capture) is abstracted behind :class:`NodeRunner`, so the
driver DSL, the disruption library and the conservation checks run
UNCHANGED over either runner:

- :class:`LocalRunner` — subprocess.Popen (the default; what CI runs).
- :class:`SSHRunner` — the same lifecycle over an SSH transport: the
  remote command is wrapped so its PID is reported on the first stdout
  line, stdout/stderr stream back over the SSH channel (log capture), and
  signals are delivered by follow-up ``kill`` commands through the same
  transport.  The transport argv is injectable, which makes the command
  layer unit-testable without a live remote (tests/test_runner.py runs it
  through ``bash -c``) — live multi-host execution needs only real
  ``ssh`` in PATH and key-based auth (docs/DEPLOYMENT.md).
"""
from __future__ import annotations

import os
import shlex
import signal
import subprocess
import time


class ProcessHandle:
    """Uniform process-control surface over a spawned node (duck-compatible
    with the subset of subprocess.Popen the driver/loadtest already used,
    plus suspend/resume for the hang disruption)."""

    pid: int | None
    stdout = None

    def poll(self):  # pragma: no cover - interface
        raise NotImplementedError

    def wait(self, timeout: float | None = None):  # pragma: no cover
        raise NotImplementedError

    def terminate(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def kill(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def suspend(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def resume(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class LocalProcessHandle(ProcessHandle):
    """A subprocess.Popen with suspend/resume (SIGSTOP/SIGCONT)."""

    def __init__(self, proc: subprocess.Popen):
        self._proc = proc
        self.pid = proc.pid
        self.stdout = proc.stdout

    def poll(self):
        return self._proc.poll()

    def wait(self, timeout: float | None = None):
        return self._proc.wait(timeout=timeout)

    def terminate(self) -> None:
        self._proc.terminate()

    def kill(self) -> None:
        self._proc.kill()

    def suspend(self) -> None:
        os.kill(self.pid, signal.SIGSTOP)

    def resume(self) -> None:
        os.kill(self.pid, signal.SIGCONT)


class NodeRunner:
    """Spawns node/verifier processes somewhere and hands back handles."""

    def spawn(self, cmd: list[str], env: dict | None = None,
              cwd: str | None = None) -> ProcessHandle:  # pragma: no cover
        raise NotImplementedError

    def prepare_dir(self, path: str) -> None:  # pragma: no cover
        raise NotImplementedError


class LocalRunner(NodeRunner):
    def spawn(self, cmd: list[str], env: dict | None = None,
              cwd: str | None = None) -> LocalProcessHandle:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                env=env, cwd=cwd)
        return LocalProcessHandle(proc)

    def prepare_dir(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)


_PID_MARKER = "__CORDA_TPU_PID__"


class SSHProcessHandle(ProcessHandle):
    """A remote process: the local ssh client streams its output; signals
    travel as separate ``kill`` invocations over the same transport."""

    def __init__(self, runner: "SSHRunner", proc: subprocess.Popen,
                 pid_timeout_s: float = 30.0):
        self._runner = runner
        self._proc = proc
        self.pid = self._read_pid(pid_timeout_s)
        self.stdout = proc.stdout

    def _read_pid(self, timeout_s: float) -> int:
        """The wrapper prints '<marker> <pid>' as its first line; consume
        lines until it appears (sshd banners may precede it). select(2)
        gates each read so a transport that connects but never produces
        output (hung sshd, half-open firewall) trips the timeout instead
        of blocking readline forever."""
        import select
        deadline = time.monotonic() + timeout_s
        fd = self._proc.stdout.fileno()
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._proc.kill()
                raise TimeoutError("remote process did not report its PID")
            ready, _, _ = select.select([fd], [], [], min(remaining, 1.0))
            if not ready:
                continue
            line = self._proc.stdout.readline()
            if not line:
                raise RuntimeError("remote process exited before "
                                   "reporting its PID")
            if line.startswith(_PID_MARKER):
                return int(line.split()[1])

    def poll(self):
        return self._proc.poll()

    def wait(self, timeout: float | None = None):
        return self._proc.wait(timeout=timeout)

    def _signal(self, sig: str) -> None:
        self._runner.run(f"kill -{sig} {self.pid}", check=False)

    def terminate(self) -> None:
        self._signal("TERM")

    def kill(self) -> None:
        self._signal("KILL")
        # reap the local ssh client once the remote side dies (EOF)
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()

    def suspend(self) -> None:
        self._signal("STOP")

    def resume(self) -> None:
        self._signal("CONT")


class SSHRunner(NodeRunner):
    """Runs node processes on a remote host over SSH.

    ``transport`` is the argv prefix that executes one shell command
    string on the remote (default: ``ssh -o BatchMode=yes <host>``);
    injecting ``["bash", "-c"]`` turns the whole command layer into a
    locally-testable fake remote."""

    def __init__(self, host: str, user: str | None = None,
                 transport: list[str] | None = None):
        self.host = host
        self.user = user
        target = f"{user}@{host}" if user else host
        self.transport = (list(transport) if transport is not None
                          else ["ssh", "-o", "BatchMode=yes", target])

    # -- command layer -------------------------------------------------------
    def remote_command(self, cmd: list[str], env: dict | None = None,
                       cwd: str | None = None) -> str:
        """The exact shell string executed on the remote for ``spawn``:
        report the shell's PID (which ``exec`` then BECOMES — signals hit
        the node itself, not a wrapper), then exec the node under its env."""
        parts = []
        if cwd:
            parts.append(f"cd {shlex.quote(cwd)}")
        parts.append(f"echo {_PID_MARKER} $$")
        envs = "".join(f"{k}={shlex.quote(str(v))} "
                       for k, v in sorted((env or {}).items()))
        # `exec env K=V argv...`: exec replaces the PID-reporting shell (so
        # signals hit the node itself) and env(1) carries the assignments
        parts.append("exec " + ("env " + envs if envs else "")
                     + " ".join(shlex.quote(c) for c in cmd) + " 2>&1")
        return "; ".join(parts)

    def argv(self, shell_command: str) -> list[str]:
        return self.transport + [shell_command]

    def run(self, shell_command: str, check: bool = True,
            timeout: float = 30.0) -> subprocess.CompletedProcess:
        """One-shot remote command (mkdir, kill, pgrep...)."""
        out = subprocess.run(self.argv(shell_command), capture_output=True,
                             text=True, timeout=timeout)
        if check and out.returncode != 0:
            raise RuntimeError(
                f"remote command failed ({out.returncode}): "
                f"{shell_command}\n{out.stdout}{out.stderr}")
        return out

    # -- runner surface ------------------------------------------------------
    def spawn(self, cmd: list[str], env: dict | None = None,
              cwd: str | None = None) -> SSHProcessHandle:
        shell_command = self.remote_command(cmd, env, cwd)
        proc = subprocess.Popen(self.argv(shell_command),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return SSHProcessHandle(self, proc)

    def prepare_dir(self, path: str) -> None:
        self.run(f"mkdir -p {shlex.quote(path)}")
