"""The comparison that decides ``correct``, at tiny widths on the CPU: sound
runs pass; the control, put in the program's place a precision below the
cell's, fails a number; and each fault a cell can have, planted under the
timed path while the rest of a run goes as the benchmark drives it, turns
``correct`` false."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench import calibrate, core, run
from perfbench.tests.tiny import SEEDS, run_tiny

CELLS = ["tiny2.train", "tiny3.train", "tiny2.serve", "tiny3.serve_w8a8"]


def _ctx(root, cell, seed, **kw):
    return run.Context(core.load_cell(cell, root), seed, 0.3, False, torch.device("cpu"), t_start=time.perf_counter(),
                       **kw)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_the_control_is_not(root, cell, seed):
    ctx = _ctx(root, cell, seed)
    out = run.execute(ctx)
    assert out["correct"], out["checks"]
    limits = ctx.cell.limits["limits"]
    control = calibrate._control(ctx, out, ctx.cell.limits["control"])
    assert any(control[k] > limits[k] for k in limits), control


@pytest.mark.parametrize("cell,fault", [("tiny2.train", "half"), ("tiny2.train", "frozen"), ("tiny3.train", "half"),
                                        ("tiny2.serve", "half"), ("tiny2.serve", "alter"),
                                        ("tiny3.serve_w8a8", "half"), ("tiny3.serve_w8a8", "alter")])
def test_fault_under_the_timed_path_is_not_correct(root, cell, fault):
    out = run_tiny(root, cell, fault=fault, trace=True)
    assert not out["correct"], out["checks"]
    assert out["metrics"]  # the rest of the run went on: its per-layer readers read


def _rank(rank, world, root, port, fault, q):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    try:
        out = run_tiny(root, "tiny2.train_dp2", rank=rank, world=world, fault=fault)
        after = run_tiny(root, "tiny2.train_dp2", rank=rank, world=world)  # the fault is undone
        if rank == 0:
            q.put((out["correct"], out["numbers"], out["attempted"], after["correct"]))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("fault", [None, "no_exchange", "half"])
def test_data_parallel_on_two_gloo_ranks(root, fault):
    """The sharded step on two CPU ranks checks as the single-rank cell does;
    leaving out the exchange of gradients, or half of the rows, is caught."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    mp.start_processes(_rank, args=(2, root, run._free_port(), fault, q), nprocs=2, start_method="spawn")
    correct, numbers, attempted, sound_after = q.get(timeout=60)
    assert correct == (fault is None), numbers
    assert sound_after
    assert attempted >= 1
    if fault is None:
        single = run_tiny(root, "tiny2.train")
        assert numbers["loss_gap_db"] == pytest.approx(single["numbers"]["loss_gap_db"], abs=1e-3)
