"""Local multi-process launch harness: the CLI's ``num_devices`` ranks, the
multi-rank tests and ``chip_smoke.py``'s sharded phase.

Counterpart of ``pcgnn_tpu/utils/multiproc.py``.  Workers coordinate
through ``torch.distributed`` collectives, so they are *interdependent*:
one worker blocking makes every other worker block.  Two consequences
shape this harness:

  * stdout/stderr go to temp FILES, never ``subprocess.PIPE`` — a worker
    that logs more than the pipe buffer before reaching its first
    collective would stall, deadlocking the whole gang until timeout.
  * on timeout or failure every worker is killed, not just reaped — an
    orphaned survivor would hold the coordinator port (and its card)
    indefinitely.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Sequence

# the directory that holds the package: workers import it from there
_ROOT = str(Path(__file__).resolve().parents[2])


def free_port() -> int:
    """Pick a currently-free localhost port.

    TOCTOU caveat: the port is released before the rank-0 worker binds it,
    so a concurrent process can steal it in between and the gang fails with
    a bind error.  Call sites that can rebuild their worker args should go
    through :func:`gang_with_fresh_port`, which retries once with a new
    port on exactly that failure signature.
    """
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# failure substrings that identify a bind loss of the free_port race
# (torch.distributed TCPStore wording)
_BIND_ERROR_MARKERS = ("Address already in use", "EADDRINUSE",
                       "Failed to bind", "bind failed", "errno: 98")


def gang_with_fresh_port(launch, attempts: int = 2):
    """Run ``launch(port)`` with a fresh free port, retrying on bind races.

    ``launch`` builds the per-worker args around the port and calls
    :func:`run_workers`; any RuntimeError whose text matches a bind failure
    triggers one retry with a new port (other failures propagate
    immediately).
    """
    for attempt in range(attempts):
        port = free_port()
        try:
            return launch(port)
        except RuntimeError as e:
            if (attempt + 1 < attempts
                    and any(m in str(e) for m in _BIND_ERROR_MARKERS)):
                continue
            raise


def worker_env(**extra) -> dict:
    """Environment for worker processes: this one's, with the package's
    directory first on ``PYTHONPATH`` (a worker script outside the
    checkout still imports the package) and ``extra`` set."""
    env = dict(os.environ)
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = _ROOT + (os.pathsep + path if path else "")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def run_workers(worker: str | Sequence[str],
                per_worker_args: Sequence[Sequence[str]],
                *, env: dict, timeout: float = 600.0,
                cwd: str | None = None) -> List[str]:
    """Launch one process per args row, wait for ALL, return their logs.

    ``worker`` is a script path, or the leading arguments of the Python
    command (e.g. ``["-m", "pcgnn_tpu_torch.parallel.launch"]``).  Raises
    RuntimeError (with the tail of every log) if any worker exits nonzero
    or the gang times out; all workers are killed on the way out.
    """
    head = [worker] if isinstance(worker, str) else list(worker)
    procs, logs = [], []
    try:
        for args in per_worker_args:
            log = tempfile.NamedTemporaryFile(
                mode="w+", suffix=".log", delete=False)
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, *head, *map(str, args)],
                env=env, cwd=cwd, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        # a failed worker ends the gang at once: the others would wait in
        # their next collective until the timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError
            time.sleep(0.05)
    except TimeoutError:
        _kill(procs)
        raise RuntimeError(
            "worker gang timed out:\n" + _tails(logs)) from None
    except BaseException:
        _kill(procs)
        _read_all(logs)
        raise
    _kill(procs)
    texts = _read_all(logs)
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(
            "worker failed:\n" + "\n---\n".join(
                f"[worker {i} exit {p.returncode}]\n{t[-3000:]}"
                for i, (p, t) in enumerate(zip(procs, texts))))
    return texts


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def _read_all(logs) -> List[str]:
    out = []
    for log in logs:
        log.flush()
        log.seek(0)
        out.append(log.read())
        log.close()
        os.unlink(log.name)
    return out


def _tails(logs) -> str:
    return "\n---\n".join(t[-2000:] for t in _read_all(logs))
