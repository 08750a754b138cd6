"""Time the port's main paths on the card, for this checkout and another in turns.

    python cse_tpu_torch/scripts/time_paths.py [--other PATH] [--reps 10]

At the main path's shapes in bf16 (ContExt full width: D 256, 8 heads of
width 32, FFN 1024, 8 layers, 2 blocks; intra G=2016 L=251, inter G=4000
L=127; B=16, T=125000), by CUDA events after two warm-ups:

- training: a layer's four weight gradients (``ops.fused_train.weight_grad``
  at (K, N) = (256, 768), (256, 256), (256, 1024), (1024, 256)), the
  attention backward (``ops.fused_train.attention_backward``), the LayerNorm
  backward (``ops.fused_train.layer_norm_backward``, g_in bf16 or fp32, g_out
  fp32 and bf16), one 8-layer stack's forward and backward through
  ``fused_stack_train``, and the bench recipe's train step
  (``make_train_step(fused=True)``);
- the flash path: ``ops.attention.flash_bwd`` and the layer-by-layer train step
  (``make_train_step(fused=False)``, ``use_flash_attention=True``,
  ``remat='layer'``);
- w8a8 serving: a layer's four int8 GEMMs (``ops.fused_stack_w8a8.linear_w8a8``
  with the QKV, out-proj, FFN1 and FFN2 epilogues), ``ServingEngine(quant=
  "w8a8")``'s forward, and the card's own memory rates beside them: a write
  of an fp32 [M, 1024] tensor (``fill_``) and a copy of one (``copy_``);
- bf16 serving: ``ServingEngine``'s forward;
- the kernel-parts tool at its defaults (G=1008, Lp=D=256, 2 layers): its
  LayerNorm in each of the five modes (``ops.kernel_parts.kp_layer_norm``,
  x [258048, 256] fp32 -> bf16) and the whole forward in modes
  ``combined_x2``, ``ln_matmul`` and ``full``.

Each checkout runs in a process of its own with its own ``cse_tpu_torch``
(built into its own ``_build/``); with ``--other PATH`` the checkout at PATH
runs too, in the order other, this, this, other, so that both are read on
one card in turns. Inputs come from ``torch.Generator`` seed 0. Prints one
JSON line per run, after the card's name and power limit. Raises without a
card.
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
W8A8_EPILOGUES = ("bias", "residual", "relu", "residual")  # QKV, out-proj, FFN1, FFN2


def measure(reps: int) -> dict:
    """The timings of the ``cse_tpu_torch`` that this process imports."""
    import torch

    from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig, TransformerStack
    from cse_tpu_torch.ops import attention as at
    from cse_tpu_torch.ops import fused_stack as fs
    from cse_tpu_torch.ops import fused_stack_w8a8 as w8
    from cse_tpu_torch.ops import fused_train as ft
    from cse_tpu_torch.ops import kernel_parts as kp
    from cse_tpu_torch.ops.buckets import aligned_bucket
    from cse_tpu_torch.scripts.bench_kernel_parts import make_inputs
    from cse_tpu_torch.serving import ServingEngine
    from cse_tpu_torch.train.optimizer import build_optimizer
    from cse_tpu_torch.train.schedules import cosine_warmup_schedule
    from cse_tpu_torch.train.step import TrainConfig, make_train_step

    if not torch.cuda.is_available():
        raise RuntimeError("time_paths needs an NVIDIA GPU")

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

    cd, H, D, hd = torch.bfloat16, 8, 256, 32
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"package": str(Path(ft.__file__).resolve().parents[2]), "card": torch.cuda.get_device_name(0)}
    B, T = 16, aligned_bucket(128000)
    batch = {"mixed": torch.randn(B, T, device="cuda", generator=gen),
             "gt": torch.randn(B, T, device="cuda", generator=gen),
             "ctx_feat": torch.randn(B, 1, 4096, device="cuda", generator=gen)}
    for name, (G, L) in SHAPES.items():
        M, o = G * L, {}
        ops_ = [(torch.randn(M, K, device="cuda", generator=gen).to(cd),
                 torch.randn(M, N, device="cuda", generator=gen).to(cd)) for K, N in WSHAPES]
        o["weight_grad_ms"] = [ms(lambda a=a: ft.weight_grad(*a)) for a in ops_]
        o["weight_grad_sum_ms"] = sum(o["weight_grad_ms"])
        del ops_
        qkv = torch.randn(M, 3 * D, device="cuda", generator=gen)
        stats = torch.empty(2, M, H, device="cuda")
        fs.attention(qkv, L, H, cd, stats)
        dattn = torch.randn(M, D, device="cuda", generator=gen)
        o["attention_backward_ms"] = ms(lambda: ft.attention_backward(qkv, dattn, stats, L, H, cd))
        del qkv, stats, dattn
        x, dh = (torch.randn(M, D, device="cuda", generator=gen) for _ in range(2))
        sc, out32 = torch.ones(D, device="cuda"), torch.empty(M, D, device="cuda")
        g = torch.randn(M, D, device="cuda", generator=gen)
        gb = g.to(cd)
        o["layer_norm_backward_ms"] = ms(lambda: ft.layer_norm_backward(dh, x, sc, gb, out32, cd))
        o["layer_norm_backward_g32_ms"] = ms(lambda: ft.layer_norm_backward(dh, x, sc, g, out32, cd))
        del x, dh, sc, out32, g, gb
        stack = TransformerStack(SepformerConfig(num_tf_layers=8)).cuda()
        x = torch.randn(G, L, D, device="cuda", generator=gen)
        gy = torch.randn(G, L, D, device="cuda", generator=gen)

        def stack_step():
            with torch.enable_grad():
                xg = x.detach().requires_grad_(True)
                ft.fused_stack_train(xg, stack, nhead=H, compute_dtype=cd).backward(gy)

        o["stack_fwd_bwd_ms"] = ms(stack_step, n=3)
        del stack, x, gy
        q, k, v, do = (torch.randn(G, H, L, hd, device="cuda", generator=gen).to(cd) for _ in range(4))
        fo, lse = at.flash_fwd(q, k, v)
        o["flash_bwd_ms"] = ms(lambda: at.flash_bwd(q, k, v, fo, lse, do))
        del q, k, v, do, fo, lse
        parts = []
        for (K, N), epi in zip(WSHAPES, W8A8_EPILOGUES):
            hq, sa = w8.quantize_rows(torch.randn(M, K, device="cuda", generator=gen))
            wq, s = fs.quantize_stacked(torch.randn(1, K, N, device="cuda", generator=gen))
            # the layout stack_weights keeps (K-major where the package has fs.k_major)
            wq = fs.k_major(wq) if hasattr(fs, "k_major") else wq
            res = torch.zeros(M, N, device="cuda") if epi == "residual" else None
            b = torch.zeros(N, device="cuda")
            parts.append(ms(lambda: w8.linear_w8a8(hq, sa, wq[0], s[0], b, epi, res)))
            del hq, sa, res
        o["linear_w8a8_ms"], o["linear_w8a8_sum_ms"] = parts, sum(parts)
        big = torch.empty(M, 1024, device="cuda")
        o["fill_tb_s"] = big.numel() * 4 / ms(lambda: big.fill_(1.0)) / 1e9
        other = torch.empty_like(big)
        o["copy_tb_s"] = 2 * big.numel() * 4 / ms(lambda: other.copy_(big)) / 1e9
        del big, other
        torch.cuda.empty_cache()
        out[name] = o

    G, Lp = 1008, 256
    args = make_inputs(G, Lp, D, 2)
    r = args[0].reshape(G * Lp, D)
    out["kp_layer_norm_ms"] = {m: ms(lambda m=m: kp.kp_layer_norm(r, args[4], m, cd)) for m in kp.LN_MODES}
    out["kernel_parts_ms"] = {m: ms(lambda m=m: kp.kernel_parts_apply(*args, m, H))
                              for m in ("combined_x2", "ln_matmul", "full")}
    del args, r
    torch.cuda.empty_cache()

    serve_cfg = SepformerConfig(variant="context", num_spks=2, compute_dtype=cd)
    for key, quant in (("serve_bf16_forward_ms", None), ("serve_w8a8_forward_ms", "w8a8")):
        engine = ServingEngine(serve_cfg, Sepformer(serve_cfg, generator=torch.Generator().manual_seed(0)),
                               quant=quant)
        out[key] = ms(lambda: engine(batch["mixed"], batch["ctx_feat"]), n=5)
        del engine
        torch.cuda.empty_cache()
    for key, flags, fused in (("train_step_ms", {}, True),
                              ("layer_train_step_ms", {"use_flash_attention": True, "remat": "layer"}, False)):
        model = Sepformer(SepformerConfig(variant="context", num_spks=2, compute_dtype=cd, **flags),
                          generator=torch.Generator().manual_seed(0))
        step = make_train_step(model, build_optimizer(cosine_warmup_schedule(1.5e-4, 500000, 10000)),
                               TrainConfig(variant="context"), fused=fused)
        out[key] = ms(lambda: step(batch), n=5)
        del step, model
        torch.cuda.empty_cache()
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
