"""Run one cell of the port's benchmark once and print its result line.

    python -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``,
``perfbench/`` and the program, ``cse_tpu_torch``. It needs the cards the
cell asks for and never falls back to the CPU: without them (or without the
program) it exits non-zero and prints no result. It prints the card's name,
count and power limit on standard error first, the numbers compared beside
their limits last, and the result as the last line of standard output:
``--trace 0`` the cell's end-to-end metrics, ``--trace 1`` its per-layer
metrics, the device's busy seconds over a short profiled sub-window and a
breakdown of it.

A cell on several cards runs one process a card: this process is rank 0,
starts the others (the same command with ``--rank``), joins them over NCCL
at a free port on localhost, prints the one line and waits for them all.

The kernels are built on a checkout's first run into ``cse_tpu_torch/_build/``
inside the checkout; later runs find them there.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # noqa: E402 -- set-up is counted from here

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import datetime  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# a library that would load JAX or Flax by itself is kept from it
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
os.environ.setdefault("USE_TF", "0")

from perfbench import core  # noqa: E402

CHILD_TIMEOUT_S = 120  # how long rank 0 waits for the other ranks after its own work
GROUP_TIMEOUT_S = 300  # a collective that waits longer for a rank that died ends the run


@dataclasses.dataclass
class Context:
    cell: core.Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    rank: int = 0
    world: int = 1
    fault: str | None = None
    t_start: float = T_START


def execute(ctx: Context) -> dict | None:
    """Drive the cell and judge it: rank 0 gets the result line's fields,
    with ``checks``; other ranks None."""
    out = core.driver(ctx.cell.traffic["kind"]).drive(ctx)
    if out is None:
        return None
    limits = ctx.cell.limits["limits"]
    missing = sorted(set(limits) - set(out["numbers"]))
    if missing:
        raise SystemExit(f"perfbench: {ctx.cell.name} has limits for numbers it does not read: {missing}")
    checks = [core.check(k, out["numbers"][k], limits[k]) for k in sorted(limits)]
    out["unchecked"] = {k: v for k, v in out["numbers"].items() if k not in limits}
    if ctx.trace:
        metrics = core.read_per_layer(ctx.cell, out["record"])
    else:
        e2e = dict(out["e2e"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in ctx.cell.end_to_end}
    out.update(checks=checks, metrics=metrics, correct=core.judge(checks) and out["failed"] == 0)
    return out


def finish_rank(out: dict | None, children: list) -> int | None:
    """After a rank's window: a rank that loaded JAX, Flax or the JAX package
    exits non-zero; any other rank but 0 exits 0; rank 0 then waits for the
    others and gives no result if one exited non-zero. None: rank 0 prints."""
    found = core.forbidden_modules()
    if found:
        print(f"perfbench: the process loaded {', '.join(found)}; no result.", file=sys.stderr)
        return 4
    if out is None:
        return 0
    codes = [c.wait(timeout=CHILD_TIMEOUT_S) for c in children]
    if any(codes):
        print(f"perfbench: ranks exited with {codes}. No result.", file=sys.stderr)
        return 1
    return None


def _device_block(ctx: Context, out: dict) -> tuple[dict, dict | None]:
    import torch

    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": ctx.world,
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    breakdown = None
    if ctx.trace:
        profiles = out["record"]["profile"]
        dev["busy_s"] = sum(p["busy_s"] for p in profiles) / len(profiles)
        dev["window_s"] = profiles[0]["window_s"]
        breakdown = {"device_ops": profiles[0]["device_ops"], "idle_gaps": profiles[0]["idle_gaps"]}
    return dev, breakdown


def _card_report(chips: int):
    import torch

    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired) as e:
        limit = f"nvidia-smi unavailable ({e})"
    print(f"perfbench: {torch.cuda.device_count()} card(s), {chips} used: {torch.cuda.get_device_name(0)}; "
          f"name, power.limit: {limit}", file=sys.stderr, flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_group(rank: int, world: int, port: int):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        import cse_tpu_torch  # noqa: F401 -- the program under test
    except ImportError as e:
        print(f"perfbench: the program cse_tpu_torch is not importable here ({e})", file=sys.stderr)
        return 2
    import torch

    cell = core.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA card(s); this machine has {n}. No result.",
              file=sys.stderr)
        return 3
    world, children = cell.chips, []
    if args.rank == 0:
        _card_report(world)
    try:
        if world > 1:
            port = args.port or _free_port()
            if args.rank == 0:
                base = [sys.executable, "-m", "perfbench.run", "--workload", args.workload, "--seed", str(args.seed),
                        "--seconds", str(args.seconds), "--trace", str(args.trace), "--port", str(port)]
                children = [subprocess.Popen(base + ["--rank", str(r)], stdout=sys.stderr) for r in range(1, world)]
            _init_group(args.rank, world, port)
        dev = torch.device("cuda", args.rank)
        torch.cuda.set_device(dev)
        ctx = Context(cell, args.seed, args.seconds, bool(args.trace), dev, args.rank, world)
        out = execute(ctx)
        if world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()
        code = finish_rank(out, children)
        if code is not None:
            return code
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
            c.wait()
    device, breakdown = _device_block(ctx, out)
    from perfbench import program

    print(f"perfbench: kernel launches {program.launch_counts()}; phases {out['phases']}; read, not compared "
          f"(PERF.md) {out['unchecked']}", file=sys.stderr)
    core.print_checks(out["checks"])
    print(core.result_line(out["correct"], out["attempted"], out["failed"], out["metrics"], device,
                           out["checks"], breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
