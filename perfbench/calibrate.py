"""Readings that a cell's limits are set from: sound runs, the control, the faults.

    python -m perfbench.calibrate --workload <cell> --seeds 11 12 ... [--seconds 3]
        [--control [--controls program:w8a8 reference:fp8]] [--faults half alter ...] [--special-seeds 3]

For each seed it runs the cell as ``perfbench.run`` does (set-up, a short
window, the comparison with the plain reference) and prints the numbers
compared as one JSON line. With ``--control``, on the first
``--special-seeds`` seeds it also reads the control, put in the program's
place on the same inputs: the reference computed a precision below the
cell's (``limits/<cell>.json``'s ``control``: ``reference:fp8``,
``reference:int4``) or the program's own lower-precision path
(``program:w8a8``). Each fault of ``--faults`` breaks the timed path
underneath on those seeds (``perfbench/drivers``: train ``half``,
``frozen``, ``no_exchange``; serve ``half``, ``alter``). The last line sums
up: per number, the sound runs' largest reading (the lower end of a limit)
and each control's and fault's smallest (the upper end).

A cell on several cards starts one process a card here (NCCL over
localhost); rank 0 prints. Needs the cards, like the benchmark.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from perfbench import core, run


def _control(ctx, out, control: str) -> dict:
    kind, _, what = control.partition(":")
    drv = core.driver(ctx.cell.traffic["kind"])
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    if kind == "program":  # the program's own lower-precision path on the same seed
        cell = dataclasses.replace(ctx.cell, traffic=dict(tr, quant=what))
        return drv.drive(dataclasses.replace(ctx, cell=cell, t_start=time.perf_counter()))["numbers"]
    if tr["kind"] == "train":
        pool = drv.make_pool(cfg, tr, ctx.seed, ctx.device)
        low = drv._reference(cfg, tr, ctx.seed, pool[:tr["checked_steps"]], ctx.device, prec=what)
        return drv.compare(low, out["ref"])
    mix_pool, ctx_pool = drv.make_pools(cfg, tr, ctx.seed, ctx.device)
    items = [(mix_pool, ctx_pool, p, T, tr["batch"]) for _, T, p in out["checked"]]
    low = drv.reference_outputs(cfg, ctx.seed, items, ctx.device, prec=what)
    return drv.compare(low, out["ref"])


def _worst_leaves(out, n=3) -> dict:
    """Training: the leaves farthest off in change and in first gradient,
    each as [program change, reference change, program gradient, reference
    gradient] (the look behind the ``*_worst_leaf`` numbers)."""
    import statistics

    prog, ref = out["prog"], out["ref"]
    gmed = statistics.median(ref["grads"].values())
    dmed = statistics.median(ref["deltas"][0].values())
    dgap = {k: abs(prog["deltas"][0][k] - r) / max(r, dmed) for k, r in ref["deltas"][0].items()}
    ggap = {k: abs(prog["grads"][k] - r) / max(r, gmed) for k, r in ref["grads"].items()}
    top = sorted(dgap, key=lambda k: -dgap[k])[:n] + sorted(ggap, key=lambda k: -ggap[k])[:n]
    return {k: [prog["deltas"][0][k], ref["deltas"][0][k], prog["grads"][k], ref["grads"][k]] for k in top}


def calibrate(args, rank=0, world=1):
    cell = core.load_cell(args.workload)
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    controls = args.controls if args.controls is not None else [cell.limits["control"]]
    sound, special = {}, {}
    for i, seed in enumerate(args.seeds):
        ctx = run.Context(cell, seed, args.seconds, False, dev, rank, world, t_start=time.perf_counter())
        drv = core.driver(cell.traffic["kind"])
        out = drv.drive(ctx)
        if out is not None:
            sound[seed] = out["numbers"]
            line = {"seed": seed, "numbers": out["numbers"], "phases": out["phases"]}
            if cell.traffic["kind"] == "train":
                line["worst_leaves"] = _worst_leaves(out)
            print(json.dumps(line), flush=True)
        if i >= args.special_seeds:
            continue
        runs = [("control " + c, c) for c in controls if args.control] + [(f, None) for f in args.faults]
        for label, control in runs:
            fault = None if control else label
            if control:
                nums = _control(ctx, out, control) if rank == 0 else None
            else:
                fo = drv.drive(dataclasses.replace(ctx, fault=fault, t_start=time.perf_counter()))
                nums = fo["numbers"] if fo is not None else None
            if nums is not None:
                special.setdefault(label, {})[seed] = nums
                print(json.dumps({"seed": seed, label: nums}), flush=True)
    if rank == 0:
        names = sorted(next(iter(sound.values())))
        summary = {"lower": {k: max(v[k] for v in sound.values()) for k in names},
                   **{label: {k: min(v[k] for v in by_seed.values()) for k in names if k in next(iter(by_seed.values()))}
                      for label, by_seed in special.items()}}
        print(json.dumps({"summary": summary, "sound_seeds": len(sound)}), flush=True)


def _rank_main(rank, world, port, args):
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    try:
        calibrate(args, rank, world)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--controls", nargs="+", default=None, help="instead of the limits file's control")
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--special-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.calibrate: needs CUDA cards", file=sys.stderr)
        return 3
    chips = core.load_cell(args.workload).chips
    if chips == 1:
        calibrate(args)
    else:
        import torch.multiprocessing as mp

        mp.start_processes(_rank_main, args=(chips, run._free_port(), args), nprocs=chips, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
