"""Process grid and data-parallel helpers on ``torch.distributed``.

Port of ``cse_tpu/core/mesh.py``. The reference trains with torchrun + NCCL
DDP and explicit barriers (reference ``train_ContSep.py:114-132,276-280,467``);
the JAX package runs one SPMD program over a (data, model) mesh and lets XLA
insert the collectives. The port runs one process per rank, as the reference
does, and keeps JAX's names:

* :func:`distributed_init_if_needed` is the rendezvous. It honours JAX's
  variables (``COORDINATOR_ADDRESS`` with ``JAX_NUM_PROCESSES`` and
  ``JAX_PROCESS_ID``), so one launch script drives both packages, and
  torchrun's (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
  ``LOCAL_RANK``; ``CSE_MULTIHOST=1`` asks for them). NCCL when the run's
  device is the card, gloo on the CPU; gloo on the card only when the caller
  passes ``backend="gloo"``. The group it joins is destroyed at exit.
* :func:`make_mesh` lays the ranks out as a (data, model) grid, rank =
  data index * n_model + model index (JAX's ``reshape(n_data, n_model)``),
  with one process group per row and per column.
* :func:`shard_batch` keeps each rank's host-local rows on its device: the
  loader has already sharded the file list per rank, and the ranks' batches
  together form one global batch.

The collectives themselves are explicit ``torch.distributed`` calls where
XLA would insert them: the train step's gradient all-reduce
(``train/step.py``) and the tensor-parallel Llama's reductions
(``models/llama.py``). Nothing falls back to gloo or to the CPU when NCCL
fails: the error propagates.
"""

from __future__ import annotations

import atexit
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from cse_tpu_torch.core.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes of the run (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def distributed_init_if_needed(backend: str | None = None, device=None) -> bool:
    """Join the run's process group when the environment names one; returns
    True when this call joined it.

    * ``COORDINATOR_ADDRESS`` (host:port) with ``JAX_NUM_PROCESSES`` and
      ``JAX_PROCESS_ID``: a TCP rendezvous (JAX's contract; torch has no
      cluster auto-detection, so both counts are required);
    * torchrun's ``RANK`` and ``WORLD_SIZE``, or ``CSE_MULTIHOST=1``: the
      ``env://`` rendezvous (``MASTER_ADDR``, ``MASTER_PORT``).

    Otherwise, and on a second call, it does nothing. ``backend`` defaults to
    NCCL when ``device`` (the card unless ``device="cpu"``) is CUDA and gloo
    on the CPU. On the card the process takes ``cuda:LOCAL_RANK`` (without
    ``LOCAL_RANK``: its rank modulo the cards). A failed rendezvous raises:
    swallowing it would train every process as rank 0 on its own. A group
    this call joined is destroyed by an exit hook."""
    if dist.is_initialized():
        return False
    env = os.environ
    addr = env.get("COORDINATOR_ADDRESS")
    if addr:
        missing = [k for k in ("JAX_NUM_PROCESSES", "JAX_PROCESS_ID") if k not in env]
        if missing:
            raise RuntimeError(f"COORDINATOR_ADDRESS={addr} needs {' and '.join(missing)}")
        rank = int(env["JAX_PROCESS_ID"])
        init = dict(init_method=f"tcp://{addr}", world_size=int(env["JAX_NUM_PROCESSES"]), rank=rank)
    elif ("RANK" in env and "WORLD_SIZE" in env) or env.get("CSE_MULTIHOST"):
        rank = int(env.get("RANK", 0))
        init = dict(init_method="env://")
    else:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"), **init)
    atexit.register(_destroy_at_exit)
    return True


def _destroy_at_exit():
    """Destroy the process group before the interpreter tears down. Left to
    the teardown, gloo's threads abort a process that has finished its work
    ("terminate called without an active exception", exit -6): 1 of 60
    four-rank groups on an 8-core CPU, 4 of 160 with four loops side by side
    (tests/rank_teardown.py)."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in the (data, model) grid, its two groups and its
    device. A group is None only in a one-rank mesh without a process group,
    where no collective is needed."""

    n_data: int
    n_model: int
    data_index: int
    model_index: int
    device: torch.device
    data_group: object = None  # the ranks that share this rank's model index
    model_group: object = None  # the ranks that share this rank's data index

    @property
    def data_src(self) -> int:
        """The global rank of data index 0 in this rank's data group."""
        return self.model_index


def make_mesh(n_data: int | None = None, n_model: int = 1, device=None) -> Mesh:
    """The (data, model) grid over every process of the run; by default all
    of them on the data axis. Every rank must call it, in the same order as
    any other group it creates. ``device``: the card unless ``device="cpu"``."""
    world = process_count()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs a world size of {n_data * n_model}; "
                         f"this run has {world} process(es)")
    rank = process_index()
    groups = {DATA_AXIS: None, MODEL_AXIS: None}
    if dist.is_initialized():
        grid = np.arange(world).reshape(n_data, n_model)
        for m in range(n_model):
            g = dist.new_group(grid[:, m].tolist())
            if m == rank % n_model:
                groups[DATA_AXIS] = g
        for d in range(n_data):
            g = dist.new_group(grid[d].tolist())
            if d == rank // n_model:
                groups[MODEL_AXIS] = g
    return Mesh(n_data, n_model, rank // n_model, rank % n_model, resolve_device(device),
                groups[DATA_AXIS], groups[MODEL_AXIS])


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's host-local rows on its device (JAX's multi-host
    ``shard_batch``): each rank passes the batch of its own loader shard, and
    together they form one global batch of ``n_data`` times its rows. Arrays
    become tensors; a tensor already on the device is returned as it is;
    other values pass through."""
    def put(v):
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        return v.to(mesh.device, non_blocking=True) if isinstance(v, torch.Tensor) else v

    return {k: put(v) for k, v in batch.items()}


def barrier():
    """Wait for every process of the run (nothing without a process group)."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def broadcast_tensors(tensors, group, src: int):
    """Overwrite ``tensors`` in place with global rank ``src``'s, over
    ``group``: one flat broadcast per dtype."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, src=src, group=group)
        for t, f in zip(ts, flat.split([t.numel() for t in ts])):
            t.detach().copy_(f.view_as(t))


def min_over_ranks(n: int, device) -> int:
    """The smallest ``n`` over every process of the run (``n`` itself
    without a process group)."""
    if not dist.is_initialized():
        return n
    t = torch.tensor([n], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def from_rank0(x: float, device) -> float:
    """Rank 0's ``x`` on every process (``x`` itself without a process group)."""
    if not dist.is_initialized():
        return x
    t = torch.tensor([x], dtype=torch.float64, device=device)
    dist.broadcast(t, src=0)
    return float(t.item())
