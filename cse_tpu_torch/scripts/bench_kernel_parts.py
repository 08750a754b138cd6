"""Where does a fused layer's time go: matrix products, softmax or LayerNorm?

    python -m cse_tpu_torch.scripts.bench_kernel_parts [--iters 10 --G 1008 --Lp 256 --D 256 --layers 2]

The port's counterpart of ``scripts/bench_kernel_parts.py``: it times the
stripped forward of :mod:`cse_tpu_torch.ops.kernel_parts` (2 layers, 8 heads
at the defaults, the intra shape) in mode ``combined_x2`` (row sums as
hi + lo matrix products with a ones matrix) and in mode ``full`` (plain
reductions), and prints ``mode: ms (TF/s)`` for each, the tool's flop count
over the time. Inputs come from numpy
``default_rng(0)`` at the tool's scales; times are CUDA-event means over
``--iters`` calls after two warm-ups. Runs on the card and raises without one.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cse_tpu_torch.core.device import resolve_device
from cse_tpu_torch.ops import kernel_parts as kp

DEFAULT_MODES = ("combined_x2", "full")


def make_inputs(G, Lp, D, n_layers, cd=torch.bfloat16, device="cuda"):
    """The tool's inputs: x fp32 * 0.1; w, f1, f2 * 0.05 in cd; jmat = 1 / D."""
    rng = np.random.default_rng(0)

    def t(*shape, scale):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * np.float32(scale)).to(device)

    x = t(G, Lp, D, scale=0.1)
    w = t(n_layers, D, 3 * D, scale=0.05).to(cd)
    f1 = t(n_layers, D, 4 * D, scale=0.05).to(cd)
    f2 = t(n_layers, 4 * D, D, scale=0.05).to(cd)
    jmat = torch.full((D, 128), 1.0 / D, device=device).to(cd)
    return x, w, f1, f2, jmat


def flop_count(G, Lp, D, n_layers) -> int:
    """The tool's count: 12 D^2 Lp multiply-adds of products and 2 Lp^2 D of attention per layer."""
    return G * n_layers * (2 * D * D * Lp * 12 + 2 * Lp * Lp * D * 2)


def bench(mode, G, Lp, D, n_layers, nhead, iters, args=None) -> float:
    """Mean ms of one call of ``kernel_parts_apply`` in ``mode`` on the card."""
    resolve_device("cuda")
    args = make_inputs(G, Lp, D, n_layers) if args is None else args
    for _ in range(2):
        kp.kernel_parts_apply(*args, mode, nhead)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        kp.kernel_parts_apply(*args, mode, nhead)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--G", type=int, default=1008)
    ap.add_argument("--Lp", type=int, default=256)
    ap.add_argument("--D", type=int, default=256)
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args(argv)
    resolve_device("cuda")
    flops = flop_count(args.G, args.Lp, args.D, args.layers)
    inputs = make_inputs(args.G, args.Lp, args.D, args.layers)
    times = {}
    with torch.no_grad():
        for mode in DEFAULT_MODES:
            ms = bench(mode, args.G, args.Lp, args.D, args.layers, 8, args.iters, inputs)
            times[mode] = ms
            print(f"{mode:16s}: {ms:7.1f} ms   ({flops / ms / 1e9:6.1f} TF/s)", flush=True)
    return times


if __name__ == "__main__":
    main()
