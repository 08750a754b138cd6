"""Start a group of processes that rendezvous through
``cse_tpu_torch.core.mesh.distributed_init_if_needed`` on JAX's variables
(COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID): the port's
multi-process tests on the CPU (gloo) and chip_smoke.py's legs on the card.

* One deadline covers the whole group, counted from its start.
* Each rank writes into a file of its own while the group runs, so no rank
  can block on a full pipe.
* The first rank that exits non-zero ends the group: the others are killed at
  once instead of waiting in the rendezvous or a collective for a peer that
  is gone.
* A failure raises ``RanksFailed``. Its message names the rendezvous address,
  the seconds elapsed and, for each rank, its return code or that it was
  killed, with the tail of its output.
* The group is started once more, on a fresh port, only when rank 0's output
  says that its rendezvous could not bind (EADDRINUSE): that is the
  launcher's fault, not the program's. Any other failure raises at once.
"""

import json
import os
import random
import signal
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Under the whole suite's load on an 8-core CPU (-n 6) no group took more than
# 37.5 s (tests/test_torch_mesh.py's first test, its fixtures included); 300 s
# is 8x that, and a group that hangs still ends well inside the suite's limit.
DEADLINE = 300  # s, for the whole group
TAIL = 6000  # characters of each rank's output in a failure report
PORT_TAKEN = ("eaddrinuse", "address already in use")


class RanksFailed(AssertionError):
    """A rank exited non-zero or the group outlived its deadline."""


def _ephemeral_range() -> tuple[int, int]:
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo, hi = map(int, f.read().split())
    except (OSError, ValueError):
        lo, hi = 32768, 60999  # Linux's default
    return lo, hi


def free_port() -> int:
    """A free localhost port outside the kernel's ephemeral range. A port from
    ``bind(0)`` lies inside it, and any connection opened beside the group
    (the gloo pairs of other tests, say) can take it before rank 0 binds it; a
    port outside it is only ever taken on purpose."""
    lo, hi = _ephemeral_range()
    ports = [p for p in range(10000, 65536) if not lo <= p <= hi] or range(10000, 65536)
    rng = random.Random()
    for _ in range(200):
        port = rng.choice(ports)
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
        return port
    raise RuntimeError("no free localhost port")


def _kill(proc: subprocess.Popen):
    """Kill a rank that is still running and whatever it started (its own
    session). Only a live one: a rank that exited was reaped, and its group
    id may have been reused."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def _start(argv, n: int, env: dict, cwd: str, timeout: float, addr: str):
    """One start of the group: (return codes, outputs, seconds, why it ended).
    A return code is None for a rank that was killed."""
    base = dict(env, COORDINATOR_ADDRESS=addr, JAX_NUM_PROCESSES=str(n))
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+b") for r in range(n)]
        procs, t0 = [], time.monotonic()
        try:
            for r, log in enumerate(logs):
                procs.append(subprocess.Popen(argv, cwd=cwd, env=dict(base, JAX_PROCESS_ID=str(r)), stdout=log,
                                              stderr=subprocess.STDOUT, start_new_session=True))
            while True:
                codes = [p.poll() for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    why = f"rank {failed[0]} exited {codes[failed[0]]}"
                    break
                if all(c == 0 for c in codes):
                    why = None
                    break
                if time.monotonic() - t0 > timeout:
                    why = "the deadline passed"
                    break
                time.sleep(0.05)
        finally:
            killed = [p for p in procs if p.poll() is None]
            for p in killed:
                _kill(p)
            outs = []
            for log in logs:
                log.seek(0)
                outs.append(log.read().decode("utf-8", "replace"))
                log.close()
    return [None if p in killed else p.returncode for p in procs], outs, time.monotonic() - t0, why


def _report(argv, addr: str, timeout: float, codes, outs, secs: float, why: str) -> str:
    lines = [f"{len(codes)} ranks of {' '.join(argv)[:300]!r} on {addr}, {secs:.1f} s after the start "
             f"(deadline {timeout} s): {why}"]
    for r, (c, out) in enumerate(zip(codes, outs)):
        state = f"exited {c}" if c is not None else (
            "killed at the deadline" if why == "the deadline passed" else f"killed when {why}")
        lines.append(f"--- rank {r}: {state}; the last {min(len(out), TAIL)} of {len(out)} characters of its output:")
        lines.append(out[-TAIL:].rstrip("\n"))
    return "\n".join(lines)


def run_group(argv: list[str], n: int, env: dict, cwd: str = REPO, timeout: float = DEADLINE,
              port: int | None = None) -> list[str]:
    """Run ``argv`` in ``n`` processes that rendezvous on JAX's variables at
    ``localhost:<port>`` (default: ``free_port()``); returns their outputs
    (standard output and error together) once all exited 0, and raises
    ``RanksFailed`` otherwise (see the module's docstring)."""
    first = None
    for attempt in range(2):
        addr = f"localhost:{port if port and attempt == 0 else free_port()}"
        codes, outs, secs, why = _start(argv, n, env, cwd, timeout, addr)
        if why is None:
            print(f"{n} ranks on {addr} exited 0 in {secs:.1f} s" + (f" (after {first})" if first else ""))
            return outs
        report = _report(argv, addr, timeout, codes, outs, secs, why)
        if first or not any(s in outs[0].lower() for s in PORT_TAKEN):
            raise RanksFailed(report if first is None else f"{report}\n(a second start, after {first})")
        first = f"rank 0 could not bind {addr}"


def launch(argv: list[str], n: int, timeout: float = DEADLINE, port: int | None = None) -> list[str]:
    """``python argv...`` in ``n`` processes (cwd the repo, the repo on
    PYTHONPATH) through ``run_group``; ``port`` fixes the first start's port."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return run_group([sys.executable, *map(str, argv)], n, env, REPO, timeout, port)


def tagged(outs: list[str]) -> list[dict]:
    """Each process's ``TAG <json>`` lines (an upper-case tag), by tag."""
    res = []
    for out in outs:
        got = {}
        for line in out.splitlines():
            tag, _, rest = line.partition(" ")
            if tag.isupper() and rest[:1] and rest[0] in "[{\"":
                got[tag] = json.loads(rest)
        res.append(got)
    return res
