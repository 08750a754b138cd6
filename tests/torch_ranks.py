"""Start a few processes that rendezvous through
``cse_tpu_torch.core.mesh.distributed_init_if_needed`` on JAX's variables
(COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID), for the port's
multi-process tests on the CPU (gloo)."""

import json
import os
import random
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    """A free port below the kernel's ephemeral range (32768-60999 by
    default). A port from ``bind(0)`` lies inside it, and the gloo
    connections of tests running beside this one can take it before the
    rendezvous binds it; a port below it is only ever taken on purpose."""
    rng = random.Random()
    for _ in range(200):
        port = rng.randrange(20000, 32000)
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
        return port
    raise RuntimeError("no free port in 20000-32000")


def launch(argv: list[str], n: int, timeout: int = 120) -> list[str]:
    """Start ``n`` processes of ``python argv...`` (cwd the repo) that
    rendezvous on JAX's variables; returns their outputs (standard output and
    error together) once all exited 0, waiting at most ``timeout`` s for each."""
    base = dict(os.environ, COORDINATOR_ADDRESS=f"localhost:{_free_port()}", JAX_NUM_PROCESSES=str(n),
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, *map(str, argv)], cwd=REPO, env=dict(base, JAX_PROCESS_ID=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(outs)
    return outs


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
