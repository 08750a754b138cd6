"""Time the fused training backward's two largest kernels, the stack and the step, on the card.

    python cse_tpu_torch/scripts/time_train_backward.py [--other PATH] [--reps 10]

At the fused train step's shapes in bf16 (ContExt full width: D 256, 8 heads
of width 32, FFN 1024; intra G=2016 L=251, inter G=4000 L=127) it times, by
CUDA events after two warm-ups: a layer's four weight gradients
(``ops.fused_train.weight_grad`` at (K, N) = (256, 768), (256, 256),
(256, 1024), (1024, 256)), the attention backward
(``ops.fused_train.attention_backward``), one 8-layer stack's forward and
backward through ``fused_stack_train``, and the bench recipe's train step
(``make_train_step(fused=True)``, B=16, T=125000). Each checkout runs in a
process of its own with its own ``cse_tpu_torch`` (built into its own
``_build/``); with ``--other PATH`` the checkout at PATH runs too, in the
order other, this, this, other, so that both are read on one card in turns.
Inputs come from ``torch.Generator`` seed 0. Prints one JSON line per run,
with the card's name and power limit. Raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

SHAPES = {"intra": (2016, 251), "inter": (4000, 127)}
WSHAPES = ((256, 768), (256, 256), (256, 1024), (1024, 256))


def measure(reps: int) -> dict:
    """The timings of the ``cse_tpu_torch`` that this process imports."""
    import torch

    from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig, TransformerStack
    from cse_tpu_torch.ops import fused_stack as fs
    from cse_tpu_torch.ops import fused_train as ft
    from cse_tpu_torch.ops.buckets import aligned_bucket
    from cse_tpu_torch.train.optimizer import build_optimizer
    from cse_tpu_torch.train.schedules import cosine_warmup_schedule
    from cse_tpu_torch.train.step import TrainConfig, make_train_step

    if not torch.cuda.is_available():
        raise RuntimeError("time_train_backward needs an NVIDIA GPU")

    def ms(fn, n=reps):
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    cd, H, D = torch.bfloat16, 8, 256
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"package": str(Path(ft.__file__).resolve().parents[2]), "card": torch.cuda.get_device_name(0)}
    for name, (G, L) in SHAPES.items():
        M = G * L
        ops_ = [(torch.randn(M, K, device="cuda", generator=gen).to(cd),
                 torch.randn(M, N, device="cuda", generator=gen).to(cd)) for K, N in WSHAPES]
        wgrad = [ms(lambda o=o: ft.weight_grad(*o)) for o in ops_]
        del ops_
        qkv = torch.randn(M, 3 * D, device="cuda", generator=gen)
        stats = torch.empty(2, M, H, device="cuda")
        fs.attention(qkv, L, H, cd, stats)
        dattn = torch.randn(M, D, device="cuda", generator=gen)
        att_bwd = ms(lambda: ft.attention_backward(qkv, dattn, stats, L, H, cd))
        del qkv, stats, dattn
        stack = TransformerStack(SepformerConfig(num_tf_layers=8)).cuda()
        x = torch.randn(G, L, D, device="cuda", generator=gen)
        gy = torch.randn(G, L, D, device="cuda", generator=gen)

        def stack_step():
            with torch.enable_grad():
                xg = x.detach().requires_grad_(True)
                ft.fused_stack_train(xg, stack, nhead=H, compute_dtype=cd).backward(gy)

        stack_ms = ms(stack_step, n=3)
        del stack, x, gy
        torch.cuda.empty_cache()
        out[name] = {"weight_grad_ms": wgrad, "weight_grad_sum_ms": sum(wgrad), "attention_backward_ms": att_bwd,
                     "stack_fwd_bwd_ms": stack_ms}
    B, T = 16, aligned_bucket(128000)
    model = Sepformer(SepformerConfig(variant="context", num_spks=2, compute_dtype=cd),
                      generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, build_optimizer(cosine_warmup_schedule(1.5e-4, 500000, 10000)),
                           TrainConfig(variant="context"), fused=True)
    batch = {"mixed": torch.randn(B, T, device="cuda", generator=gen),
             "gt": torch.randn(B, T, device="cuda", generator=gen),
             "ctx_feat": torch.randn(B, 1, 4096, device="cuda", generator=gen)}
    out["train_step_ms"] = ms(lambda: step(batch), n=5)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another checkout of the repository, timed in turns with this one")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", action="store_true", help="time the cse_tpu_torch on PYTHONPATH, in this process")
    args = ap.parse_args(argv)
    if args.only:
        print(json.dumps(measure(args.reps)), flush=True)
        return 0
    here = Path(__file__).resolve().parents[2]
    roots = [here] if args.other is None else [Path(args.other).resolve(), here, here, Path(args.other).resolve()]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    for root in roots:
        env = {**os.environ, "PYTHONPATH": str(root)}
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--only", "--reps", str(args.reps)],
                       cwd=root, env=env, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
