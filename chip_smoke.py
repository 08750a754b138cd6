"""Smoke run of the cse_tpu_torch serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels of cse_tpu_torch/csrc from the checkout;
  3. hold each kernel (LayerNorm, GEMM with its three epilogues, attention)
     and the whole fused stack against its plain PyTorch version at the
     serving shapes (intra G=2016 L=251, inter G=4000 L=127) in fp32 and bf16;
  4. the slice: ServingEngine, variant 'context', full width (D 256, 8 heads,
     FFN 1024, 8 layers, 2 blocks, llm_dim 4096), B=16, T=aligned_bucket(128000),
     seeded random weights, in fp32 and in bf16, held against the plain
     layer-by-layer Sepformer on the card; the launch counts of the bf16 run;
     the median forward time and realtime factor;
  5. each kernel's time beside its plain version, a library call that computes
     the same function (timed only; the port never calls it) and its bound.
The second-to-last lines are the kernels' JSON line and the card; the last line
is {"ok": true, "device": {...}}.

Imports nothing of JAX or of cse_tpu; needs CUDA (exits 1 without it).
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# Tolerances, with their reasons.
# fp32: kernel and plain version compute the same fp32 arithmetic; only the
# summation order differs -> max|err| / max|ref| <= 1e-4.
TOL_FP32 = 1e-4
# bf16: the same values are rounded to bf16 at the same places; a different
# fp32 accumulation order flips a few roundings -> relative L2 <= 1e-2.
TOL_BF16 = 1e-2
# Serving in fp32 against the plain fp32 Sepformer: the same model, only the
# summation order differs, through 32 transformer layers -> relative L2 <= 1e-4.
TOL_SERVE_FP32 = 1e-4
# Serving in bf16 against the plain fp32 Sepformer: bf16 rounding of
# activations and weights through 32 layers; the bar is the repo's bf16-order
# serving bar (tests/test_serving.py::test_w8a8_engine_close_to_exact) ->
# relative L2 <= 5e-2.
TOL_SERVE_BF16 = 5e-2

# NVIDIA H100 SXM data sheet (dense): bf16 tensor cores, fp32 CUDA cores, HBM3.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
HBM_BYTES_S = 3.35e12

INTRA = (2016, 251)  # B*S sequences of K + 1 tokens at B=16, T=125000
INTER = (4000, 127)  # B*K sequences of S + 1 tokens
REPLACES = "cse_tpu/ops/fused_stack.py:79"  # _stack_kernel
SOURCE = "cse_tpu_torch/csrc/fused_stack.cu"


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def errs(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float, float]:
    """(max abs err, max abs err / max |ref|, relative L2)."""
    g, r = got.float(), ref.float()
    d = (g - r).abs().max().item()
    return d, d / max(r.abs().max().item(), 1e-30), (
        torch.linalg.vector_norm(g - r) / torch.linalg.vector_norm(r).clamp_min(1e-30)
    ).item()


def check(name: str, got: torch.Tensor, ref: torch.Tensor, cd: torch.dtype, failures: list) -> float:
    if not torch.isfinite(got.float()).all():
        failures.append(f"{name}: non-finite output")
    mx, rmax, rl2 = errs(got, ref)
    ok = rmax <= TOL_FP32 if cd == torch.float32 else rl2 <= TOL_BF16
    log(f"  {name:<44s} max_abs {mx:.3e}  max_rel {rmax:.3e}  rel_l2 {rl2:.3e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(name)
    return mx


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_stack(D, F_, n_layers, cd, gen):
    """Stacked weights as ``stack_weights`` makes them, from ``gen``."""
    def r(*s, scale=1.0):
        return torch.randn(*s, device="cuda", generator=gen) * scale
    mats = {"qkv_w": (D, 3 * D), "out_w": (D, D), "f1_w": (D, F_), "f2_w": (F_, D)}
    w = {k: r(n_layers, *s, scale=1 / math.sqrt(s[0])).to(cd).contiguous() for k, s in mats.items()}
    for k, n in (("qkv_b", 3 * D), ("out_b", D), ("f1_b", F_), ("f2_b", D), ("ln1_b", D), ("ln2_b", D)):
        w[k] = (0.1 * r(n_layers, n)).to(cd).float().contiguous()
    for k in ("ln1_s", "ln2_s"):
        w[k] = (1 + 0.1 * r(n_layers, D)).to(cd).float().contiguous()
    w["fn_s"] = (1 + 0.1 * r(D)).to(cd).float().contiguous()
    w["fn_b"] = (0.1 * r(D)).to(cd).float().contiguous()
    return w


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    t_start = time.time()
    torch.set_grad_enabled(False)
    from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig
    from cse_tpu_torch.ops import _build
    from cse_tpu_torch.ops import fused_stack as fs
    from cse_tpu_torch.ops.buckets import aligned_bucket
    from cse_tpu_torch.serving import ServingEngine

    # the plain versions are the oracle: full fp32 everywhere, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build
    t0 = time.time()
    _build.build(verbose=True)
    _build.library()
    log(f"[2] kernels built in {time.time() - t0:.1f} s -> {_build.library_path().name}")

    failures: list[str] = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    D, H, F_, NL = 256, 8, 1024, 8

    # ---- 3. each kernel and the whole stack against the plain versions
    log("[3] kernels vs plain versions (fp32: max_rel <= %.0e; bf16: rel_l2 <= %.0e)" % (TOL_FP32, TOL_BF16))
    max_err = {"layer_norm": 0.0, "linear": 0.0, "attention": 0.0}
    for cd in (torch.float32, torch.bfloat16):
        tag = "fp32" if cd == torch.float32 else "bf16"
        for shape_name, (G, L) in (("intra", INTRA), ("inter", INTER)):
            M = G * L
            x = 3 * torch.randn(M, D, device="cuda", generator=gen)
            s = 1 + 0.1 * torch.randn(D, device="cuda", generator=gen)
            b = 0.1 * torch.randn(D, device="cuda", generator=gen)
            e = check(f"layer_norm {tag} {shape_name} [{M},{D}]",
                      fs.layer_norm(x, s, b, cd), fs.layer_norm_plain(x, s, b, cd), cd, failures)
            max_err["layer_norm"] = max(max_err["layer_norm"], e)
            del x
            for K, N, epi in ((D, 3 * D, "bias"), (D, D, "residual"), (D, F_, "relu"), (F_, D, "residual")):
                a = torch.randn(M, K, device="cuda", generator=gen).to(cd)
                w = (torch.randn(K, N, device="cuda", generator=gen) / math.sqrt(K)).to(cd)
                bias = 0.1 * torch.randn(N, device="cuda", generator=gen)
                res = torch.randn(M, N, device="cuda", generator=gen) if epi == "residual" else None
                got = fs.linear(a, w, bias, epi, None if res is None else res.clone())
                ref = fs.linear_plain(a, w, bias, epi, res)
                e = check(f"linear {tag} {shape_name} [{M},{K}]x[{K},{N}] {epi}", got, ref, cd, failures)
                max_err["linear"] = max(max_err["linear"], e)
                del a, got, ref, res
            qkv = 2 * torch.randn(M, 3 * D, device="cuda", generator=gen)
            e = check(f"attention {tag} {shape_name} G={G} L={L}",
                      fs.attention(qkv, L, H, cd), fs.attention_plain(qkv, L, H, cd), cd, failures)
            max_err["attention"] = max(max_err["attention"], e)
            del qkv
            if shape_name == "intra":  # L > 256: the attention's two-tile path
                qkv = 2 * torch.randn(64 * 300, 3 * D, device="cuda", generator=gen)
                e = check(f"attention {tag} G=64 L=300 (two key tiles)",
                          fs.attention(qkv, 300, H, cd), fs.attention_plain(qkv, 300, H, cd), cd, failures)
                max_err["attention"] = max(max_err["attention"], e)
                del qkv
            w = random_stack(D, F_, NL, cd, gen)
            xs = torch.randn(G, L, D, device="cuda", generator=gen).to(cd)
            check(f"fused stack {tag} {shape_name} [{G},{L},{D}]",
                  fs.fused_stack_apply(xs, w, H, cd), fs.fused_stack_reference(xs, w, H, cd), cd, failures)
            del w, xs
            torch.cuda.empty_cache()
    if failures:
        fail(f"kernel checks failed: {failures}")

    # ---- 4. the slice: ServingEngine, ContExt, full width
    B, T = 16, aligned_bucket(128000)
    log(f"[4] ServingEngine variant=context full width, B={B}, T={T}")
    outs = {}
    mix = torch.randn(B, T, device="cuda", generator=gen)
    ctx = torch.randn(B, 1, 4096, device="cuda", generator=gen)
    for cd in (torch.float32, torch.bfloat16):
        cfg = SepformerConfig(variant="context", num_spks=2, compute_dtype=cd)
        model = Sepformer(cfg, generator=torch.Generator().manual_seed(0)).to("cuda").eval()
        engine = ServingEngine(cfg, model)
        outs["plain_" + ("fp32" if cd == torch.float32 else "bf16")] = model(mix, ctx)
        fs.reset_launches()
        out = engine(mix, ctx)
        torch.cuda.synchronize()
        counts = fs.launch_counts()
        outs["serve_" + ("fp32" if cd == torch.float32 else "bf16")] = out
        if tuple(out.shape) != (B, T, 1) or not torch.isfinite(out).all():
            fail(f"serving output {tuple(out.shape)} (want {(B, T, 1)}) or non-finite")
        if cd == torch.bfloat16:
            main_counts = counts
            per_stack = fs.launches_per_stack(cfg.num_tf_layers)
            n_stacks = 2 * cfg.num_dp_layers
            want = {k: v * n_stacks for k, v in per_stack.items()}
            log(f"  launches in one bf16 forward: {counts} (want {want}, total {sum(want.values())})")
            if counts != want:
                fail(f"launch counts {counts} != {want}")
            fwd_times = []
            for i in range(7):
                t_s, t_e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t_s.record()
                engine(mix, ctx)
                t_e.record()
                torch.cuda.synchronize()
                if i >= 2:  # two warmups
                    fwd_times.append(t_s.elapsed_time(t_e))
            fwd_ms = statistics.median(fwd_times)
            plain_fwd_ms = time_ms(lambda: model(mix, ctx), reps=3, warmup=1)
        del engine, model
        torch.cuda.empty_cache()
    for name, tol in (("serve_fp32", TOL_SERVE_FP32), ("serve_bf16", TOL_SERVE_BF16), ("plain_bf16", None)):
        mx, _, rl2 = errs(outs[name], outs["plain_fp32"])
        ok = tol is None or rl2 <= tol
        log(f"  {name} vs plain fp32 Sepformer: max_abs {mx:.3e} rel_l2 {rl2:.3e}"
            + ("" if tol is None else f" (tol {tol:.0e}) {'ok' if ok else 'FAIL'}"))
        if not ok:
            failures.append(name)
    if failures:
        fail(f"serving checks failed: {failures}")
    audio_s = B * T / 8000
    log(f"  bf16 forward: median {fwd_ms:.3f} ms over {len(fwd_times)} runs ({fwd_times}); "
        f"plain bf16 Sepformer {plain_fwd_ms:.3f} ms; {audio_s:.1f} s of audio -> "
        f"realtime factor {audio_s / (fwd_ms / 1e3):.1f}x  [{card}]")
    del outs

    # ---- 5. per-kernel times (bf16, the serving dtype)
    log(f"[5] kernel times, bf16 [{card}]")
    cd = torch.bfloat16
    times = {}
    for shape_name, (G, L) in (("intra", INTRA), ("inter", INTER)):
        M = G * L
        x = torch.randn(M, D, device="cuda", generator=gen)
        s, b = torch.ones(D, device="cuda"), torch.zeros(D, device="cuda")
        ln = dict(
            ms=time_ms(lambda: fs.layer_norm(x, s, b, cd)),
            plain_ms=time_ms(lambda: fs.layer_norm_plain(x, s, b, cd)),
            library_ms=time_ms(lambda: F.layer_norm(x, (D,), s, b, 1e-6)),
            bound_ms=1e3 * (M * D * (4 + 2) + 2 * D * 4) / HBM_BYTES_S, bound_by="bytes",
        )
        del x
        shapes = ((D, 3 * D, "bias"), (D, D, "residual"), (D, F_, "relu"), (F_, D, "residual"))
        ops_ = []
        for K, N, epi in shapes:
            a = torch.randn(M, K, device="cuda", generator=gen).to(cd)
            w = (torch.randn(K, N, device="cuda", generator=gen) / math.sqrt(K)).to(cd)
            bias = torch.zeros(N, device="cuda")
            res = torch.zeros(M, N, device="cuda") if epi == "residual" else None
            ops_.append((a, w, bias, epi, res))
        lin_flops = sum(2 * M * K * N for K, N, _ in shapes)
        lin_bytes = sum(M * K * 2 + K * N * 2 + N * 4 + M * N * (8 if e == "residual" else 4 if e == "bias" else 2)
                        for K, N, e in shapes)
        part_ms = [time_ms(lambda o=o: fs.linear(*o)) for o in ops_]
        for (K, N, epi), ms, o in zip(shapes, part_ms, ops_):
            nbytes = M * K * 2 + K * N * 2 + N * 4 + M * N * (8 if epi == "residual" else 4 if epi == "bias" else 2)
            log(f"  {shape_name} linear [{M},{K}]x[{K},{N}] {epi:<8s} kernel {ms:.4f} ms  "
                f"{nbytes / ms / 1e9:.3f} TB/s  {2 * M * K * N / ms / 1e9:.1f} TFLOP/s  "
                f"library {time_ms(lambda o=o: torch.matmul(o[0], o[1])):.4f} ms")
        lin = dict(
            ms=sum(part_ms),
            plain_ms=time_ms(lambda: [fs.linear_plain(*o) for o in ops_], reps=3),
            library_ms=time_ms(lambda: [torch.matmul(o[0], o[1]) for o in ops_]),
        )
        tb, to = 1e3 * lin_bytes / HBM_BYTES_S, 1e3 * lin_flops / PEAK_BF16
        lin.update(bound_ms=max(tb, to), bound_by="operations" if to >= tb else "bytes")
        del ops_
        qkv = torch.randn(M, 3 * D, device="cuda", generator=gen)
        q, k, v = (t.to(cd) for t in qkv.reshape(G, L, 3, H, D // H).permute(2, 0, 3, 1, 4))
        att_flops = 4 * G * H * L * L * (D // H)
        ab, ao = 1e3 * (M * 3 * D * 4 + M * D * 2) / HBM_BYTES_S, 1e3 * att_flops / PEAK_BF16
        att = dict(
            ms=time_ms(lambda: fs.attention(qkv, L, H, cd)),
            plain_ms=time_ms(lambda: fs.attention_plain(qkv, L, H, cd), reps=3),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
            bound_ms=max(ab, ao), bound_by="operations" if ao >= ab else "bytes",
        )
        del qkv, q, k, v
        w = random_stack(D, F_, NL, cd, gen)
        xs = torch.randn(G, L, D, device="cuda", generator=gen).to(cd)
        stk_flops = NL * (lin_flops + att_flops)
        stk = dict(
            ms=time_ms(lambda: fs.fused_stack_apply(xs, w, H, cd), reps=5),
            plain_ms=time_ms(lambda: fs.fused_stack_reference(xs, w, H, cd), reps=2, warmup=1),
            bound_ms=1e3 * stk_flops / PEAK_BF16, bound_by="operations",
        )
        del w, xs
        torch.cuda.empty_cache()
        times[shape_name] = {"layer_norm": ln, "linear": lin, "attention": att, "fused_stack": stk}
        for kname, t in times[shape_name].items():
            log(f"  {shape_name} G={G} L={L} {kname:<11s} kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
                f"library {t.get('library_ms', float('nan')):.4f} ms  bound {t['bound_ms']:.4f} ms ({t['bound_by']})")

    parts = {"layer_norm": ("_ln (:33), one launch", "layer_norm_kernel"),
             "linear": ("the four projections (:92-110), one layer's 4 launches", "linear_bf16_kernel"),
             "attention": ("_attention (:39), one launch", "attention_bf16_kernel")}
    kernels = []
    for kname, (part, symbol) in parts.items():
        ti, tn = times["intra"][kname], times["inter"][kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE, "symbol": symbol, "replaces": REPLACES,
            "launches": main_counts[kname], "max_abs_err": max_err[kname],
            "ms": ti["ms"], "plain_ms": ti["plain_ms"], "bound_ms": ti["bound_ms"],
            "bound_by": ti["bound_by"], "library_ms": ti["library_ms"],
            "work": f"intra G={INTRA[0]} L={INTRA[1]} bf16, {part}",
            "inter": {k: tn[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        })
    log(f"  whole run {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels,
                      "fused_stack": {k: {kk: vv for kk, vv in v["fused_stack"].items()} for k, v in times.items()},
                      "forward_ms": fwd_ms, "realtime_factor": audio_s / (fwd_ms / 1e3)}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
