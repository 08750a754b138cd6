"""What the benchmark's processes load, and that it gives no result without
a card or without the program."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from perfbench import core

HARNESS = ["perfbench.run", "perfbench.core", "perfbench.calibrate", "perfbench.drivers.train",
           "perfbench.drivers.serve", "perfbench.program", "perfbench.trace", "perfbench.weights",
           "perfbench.metrics.sepformer_work", "perfbench.reference.sepformer"]


def _loaded(code: str, cwd=core.ROOT) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
                         cwd=cwd, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_readers_load_no_jax():
    readers = "".join(f"core.reader({m['name']!r})\n" for m in json.loads(
        (core.ROOT / "BENCHMARK.json").read_text())["per_layer"])
    top = _loaded("import importlib\nfrom perfbench import core\n"
                  + "".join(f"importlib.import_module({m!r})\n" for m in HARNESS) + readers)
    assert not top & set(core.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    top = _loaded("import perfbench.reference.sepformer, perfbench.weights")
    assert not top & (set(core.FORBIDDEN) | {"cse_tpu_torch"})


def test_a_run_loads_no_jax(root):
    """A whole tiny run, set-up to the comparison, in a fresh process."""
    top = _loaded("import torch\ntorch.set_num_threads(2)\nfrom pathlib import Path\n"
                  "from perfbench.tests.tiny import run_tiny\n"
                  f"assert run_tiny(Path({str(root)!r}), 'tiny3.serve_w8a8')['correct']\n"
                  f"assert run_tiny(Path({str(root)!r}), 'tiny2.train')['correct']")
    assert "cse_tpu_torch" in top and not top & set(core.FORBIDDEN)


def _cli(cwd):
    return subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "context2.train_fused", "--seed",
                           str(2**31 + 7), "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_result_without_a_card():
    import torch

    res = _cli(core.ROOT)
    if not torch.cuda.is_available():
        assert res.returncode != 0 and res.stdout == ""
        assert "needs 1 CUDA card" in res.stderr


def test_no_result_with_the_benchmark_alone(tmp_path):
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(core.ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    res = _cli(tmp_path)
    assert res.returncode != 0 and res.stdout == ""


def rank_process(root: str, rank: int, port: int, plant: int | None) -> int:
    """One rank of the tiny two-rank cell as ``perfbench.run`` drives it on
    the CPU: rank 0 starts rank 1, each runs its window over gloo, and
    ``plant``'s rank then holds a module named ``jax``. Rank 0 prints
    ``RESULT`` where the run would print its line."""
    import types
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from perfbench import run
    from perfbench.tests.tiny import run_tiny

    torch.set_num_threads(1)
    children = []
    if rank == 0:
        children = [subprocess.Popen([sys.executable, "-c", _rank_code(root, 1, port, plant)], cwd=core.ROOT)]
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
        out = run_tiny(Path(root), "tiny2.train_dp2", rank=rank, world=2)
        dist.destroy_process_group()
        if rank == plant:
            sys.modules["jax"] = types.ModuleType("jax")
        code = run.finish_rank(out, children)
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
            c.wait()
    if code is None:
        print("RESULT", flush=True)
    return code or 0


def _rank_code(root, rank, port, plant) -> str:
    return ("import sys\nfrom perfbench.tests.test_perfbench_isolation import rank_process\n"
            f"sys.exit(rank_process({str(root)!r}, {rank}, {port}, {plant!r}))")


@pytest.mark.parametrize("plant", [None, 0, 1])
def test_every_rank_refuses_a_result_that_loaded_jax(root, plant):
    """Two gloo ranks of a data-parallel cell: whichever rank holds a module
    named ``jax`` after its window, rank 0 prints no result."""
    from perfbench import run

    res = subprocess.run([sys.executable, "-c", _rank_code(root, 0, run._free_port(), plant)], cwd=core.ROOT,
                         capture_output=True, text=True, timeout=300)
    if plant is None:
        assert res.returncode == 0 and "RESULT" in res.stdout, res.stderr[-2000:]
    else:
        assert res.returncode != 0 and "RESULT" not in res.stdout
        assert "loaded jax" in res.stderr
