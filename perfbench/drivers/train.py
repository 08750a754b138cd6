"""Traffic kind ``train``: training steps back to back on seeded batches.

Parameters (the mix's JSON): ``batch`` (mixtures a rank), ``ranks`` (data
parallel ranks, one card each), ``samples`` (T), ``pool`` (distinct
batches, cycled), ``checked_steps`` (the first steps, which the reference
follows), ``profile_steps`` (the traced sub-window), ``fused``,
``schedule`` (the cosine warmup's ``base_lr``, ``total``, ``warmup``) and
``optimizer`` (``weight_decay``, ``clip_norm``).

Set-up builds one training step (``make_train_step``: model, optimizer
state, with ``ranks`` > 1 the sharded step over a data mesh) and drives it
through its first ``checked_steps`` steps on the pool's first batches; the
same object then runs the window, its batches already on the device, no
host read a step besides the optimizer's own. One chip runs until the
window's seconds have passed; several ranks run the number of steps that
rank 0 reckons from a timed step, so that they agree.

Checked against the plain reference (:mod:`perfbench.reference.sepformer`),
which follows the same first steps from the same weights and batches: each
step's loss, each leaf's first gradient as the optimizer took it (from its
first moment after step 1) and each leaf's change over the checked steps,
on every rank.
"""

from __future__ import annotations

import math
import time

import torch

from perfbench import weights as W
from perfbench.trace import SubWindow

B1 = 0.9  # the optimizer's first-moment decay: mu after step 1 is (1 - B1) g


def make_pool(cfg: dict, tr: dict, seed: int, device) -> list[dict]:
    """``pool`` global batches: each target source N(0, 0.1^2) white noise,
    the mixture the sum of ``num_spks`` sources, a context vector a mixture."""
    g = W.generator(seed, device, 1)
    n, Bg, T, spk = tr["pool"], tr["batch"] * tr["ranks"], tr["samples"], cfg["num_spks"]
    out = []
    for _ in range(n):
        src = 0.1 * torch.randn(Bg, T, spk, generator=g, device=device)
        b = {"mixed": src.sum(-1), "gt": src[..., 0].contiguous(),
             "ctx_feat": torch.randn(Bg, 1, cfg["llm_dim"], generator=g, device=device)}
        if cfg["variant"] == "contsep":
            b["noises"] = src[..., 1:].contiguous()
        out.append(b)
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _barrier(ctx):
    if ctx.world > 1:
        import torch.distributed as dist

        dist.barrier(device_ids=[ctx.device.index] if ctx.device.type == "cuda" else None)


def _gather(ctx, obj):
    if ctx.world == 1:
        return [obj]
    import torch.distributed as dist

    out = [None] * ctx.world
    dist.all_gather_object(out, obj)
    return out


def _reference(cfg, tr, seed, batches, device, prec=None) -> dict:
    """The plain reference's first steps: losses, clipped first gradient and
    change over the steps, each leaf's norm by name."""
    from perfbench.reference import sepformer as ref

    ref.fp32_only()
    P = W.draw_weights(cfg, seed, device)
    P0 = {k: v.clone() for k, v in P.items()}
    s, o = tr["schedule"], tr["optimizer"]
    opt = ref.AdamWAmsgrad(ref.cosine_warmup(s["base_lr"], s["total"], s["warmup"]), o["weight_decay"], o["clip_norm"])
    losses, first = [], {}
    for i, b in enumerate(batches):
        loss, g = ref.loss_and_grads(cfg, cfg.get("train", {}), P, b, prec)
        g = opt.step(P, g)
        losses.append(loss)
        if i == 0:
            first = g if g else {k: torch.zeros_like(v) for k, v in P.items()}
    deltas = {k: float((P[k] - P0[k]).norm()) for k in P}
    return {"losses": losses, "grads": {k: float(v.norm()) for k, v in first.items()}, "deltas": [deltas],
            "first": first}


def compare(prog: dict, refr: dict) -> dict:
    """The numbers: the widest loss gap over the checked steps (dB); for each
    leaf the gap of first-gradient norms, the norm of the first gradients'
    difference (``grad_rel_l2``) and the gap of change norms over the
    checked steps, each over the reference's norm of that leaf or of the
    median leaf, the larger, read by the median leaf (the change on the rank
    farthest off) and by the worst (``*_worst_leaf``).
    Leaves whose reference gradient is under a thousandth of the median
    leaf's (nought to rounding, as a key's bias under softmax) are left out
    of the change. The limits compare the median leaf (PERF.md): the worst
    leaf is one small leaf's noise, the PReLU slope's one-element gradient
    summed over every activation in the first, rounding flips of weights
    near 1 under the schedule's first learning rates (1.5e-8, 3e-8) in the
    second."""
    import statistics

    def gaps(p, r, names):
        med = statistics.median(r[k] for k in names)
        return [abs(p[k] - r[k]) / max(r[k], med) for k in names]

    names = list(refr["grads"])
    grad = gaps(prog["grads"], refr["grads"], names)
    gmed_all = statistics.median(refr["grads"].values())
    diff = [float((prog["first"][k].to(refr["first"][k].device) - refr["first"][k]).norm())
            / max(refr["grads"][k], gmed_all) for k in names]
    gmed = statistics.median(refr["grads"].values())
    moved = [k for k in names if refr["grads"][k] >= 1e-3 * gmed]
    change = [gaps(d, refr["deltas"][0], moved) for d in prog["deltas"]]
    return {"loss_gap_db": max(abs(a - b) for a, b in zip(prog["losses"], refr["losses"])),
            "grad_gap": statistics.median(grad), "grad_gap_worst_leaf": max(grad),
            "grad_rel_l2": statistics.median(diff), "grad_rel_l2_worst_leaf": max(diff),
            "update_gap": max(statistics.median(c) for c in change),
            "update_gap_worst_leaf": max(max(c) for c in change)}


def _patch_fault(ctx, opt):
    """Break the timed path underneath, for the benchmark's own tests and
    the readings of its limits: ``frozen`` (a step that leaves the state as
    it was), ``no_exchange`` (the ranks' gradients not exchanged: each rank
    steps on its own). Returns what undoes it."""
    if ctx.fault == "frozen":
        opt.step = lambda params, grads, state: False
    elif ctx.fault == "no_exchange":  # each rank keeps its own sums, as if every rank held the same
        import cse_tpu_torch.train.step as st

        class _NoExchange:
            def __getattr__(self, name):
                if name == "all_reduce":
                    return lambda t, group=None, **k: t.mul_(ctx.world)
                return getattr(torch.distributed, name)

        st.dist = _NoExchange()
        return lambda: setattr(st, "dist", torch.distributed)
    return lambda: None


def drive(ctx) -> dict | None:
    undo = []
    try:
        return _drive(ctx, undo)
    finally:
        for u in undo:
            u()


def _drive(ctx, undo: list) -> dict | None:
    from cse_tpu_torch.core.mesh import make_mesh
    from cse_tpu_torch.train.optimizer import build_optimizer
    from cse_tpu_torch.train.schedules import cosine_warmup_schedule
    from cse_tpu_torch.train.step import TrainConfig, make_train_step

    from perfbench import program

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    B, n_checked = tr["batch"], tr["checked_steps"]
    pool = make_pool(cfg, tr, ctx.seed, dev)
    rows = slice(ctx.rank * B, (ctx.rank + 1) * B)
    if ctx.fault == "half":  # half of the rows left out, the mean taken over the rest
        rows = slice(ctx.rank * B, ctx.rank * B + B // 2)
    batches = [{k: v[rows] for k, v in b.items()} for b in pool]
    mesh = make_mesh(n_data=ctx.world, device=dev) if ctx.world > 1 else None
    model = program.build_model(cfg, W.draw_weights(cfg, ctx.seed, dev), dev)
    s, o = tr["schedule"], tr["optimizer"]
    opt = build_optimizer(cosine_warmup_schedule(s["base_lr"], s["total"], s["warmup"]),
                          weight_decay=o["weight_decay"], clip_norm=o["clip_norm"])
    train = cfg.get("train", {})
    step = make_train_step(model, opt, TrainConfig(variant=cfg["variant"], num_spks=cfg["num_spks"],
                                                   ctx_weight=train.get("ctx_weight", 1.0),
                                                   use_ce=train.get("use_ce", True)),
                           fused=tr["fused"], device=dev, mesh=mesh)
    undo.append(_patch_fault(ctx, opt))
    names = [n for n, _ in model.named_parameters()]
    params = [p.detach() for p in model.parameters()]
    p0 = [p.clone() for p in params]
    losses, g1, t_step = [], None, None
    for i in range(n_checked):
        _sync(dev)
        t = time.perf_counter()
        m = step.tensors(batches[i])
        losses.append(m["loss"])
        if i == 0:  # the first gradient as the optimizer took it
            g1 = [m / (1 - B1) for m in step.opt_state.mu]
        _sync(dev)
        t_step = time.perf_counter() - t
    delta = torch.stack(torch._foreach_norm([p - q for p, q in zip(params, p0)]))
    del p0
    prog = {"losses": [float(x) for x in losses], "grads": dict(zip(names, torch.stack(torch._foreach_norm(g1)).tolist())),
            "delta": dict(zip(names, delta.tolist()))}

    # the window
    n_fixed = None
    if ctx.world > 1:
        n_fixed = _gather(ctx, max(tr["profile_steps"] + 1, math.ceil(ctx.seconds / t_step)))[0]
    sub = SubWindow(dev) if ctx.trace else None
    prof_at, notfinite0 = None, step.opt_state.total_notfinite
    _sync(dev)
    _barrier(ctx)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    n = 0
    while True:
        if sub is not None and prof_at is None and (
                n == (n_fixed // 3 if n_fixed else -1) or (n_fixed is None and time.perf_counter() - t0 >= ctx.seconds / 3)):
            sub.start()
            prof_at = n
        with torch.profiler.record_function("bench/step"):
            step.tensors(batches[(n_checked + n) % len(batches)])
        n += 1
        if prof_at is not None and sub.summary is None and n - prof_at == tr["profile_steps"]:
            sub.stop()
        profiled = sub is None or sub.summary is not None
        if n_fixed is not None:
            if n >= n_fixed:
                break
        elif time.perf_counter() - t0 >= ctx.seconds and profiled:
            break
    _sync(dev)
    _barrier(ctx)
    elapsed = time.perf_counter() - t0
    failed = step.opt_state.total_notfinite - notfinite0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    record = None
    if ctx.trace:
        record = {"kind": "train", "config": cfg, "batch": B, "samples": tr["samples"], "ranks": ctx.world,
                  "profile": _gather(ctx, sub.summary), "sub_window": {"steps": tr["profile_steps"],
                                                                        "elapsed_s": sub.summary["window_s"]}}
        if ctx.world > 1:
            record["allreduce_ms"] = _time_allreduce(step.reduced_bytes // 4, mesh, dev)
        if ctx.rank == 0:
            record["stack"] = _time_stacks(cfg, model, B, tr["samples"], dev)
        _barrier(ctx)
    prog["deltas"] = [d for d in _gather(ctx, prog["delta"])]
    prog["first"] = dict(zip(names, (g.cpu() for g in g1)))
    del g1
    peaks = _gather(ctx, peak)
    del step, model, params, opt, batches
    if ctx.rank != 0:
        return None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    refr = _reference(cfg, tr, ctx.seed, [pool[i] for i in range(n_checked)], dev)
    return {"attempted": n, "failed": failed, "setup_s": setup_s,
            "e2e": {"train_mixtures_per_s": n * B * ctx.world / elapsed},
            "numbers": compare(prog, refr), "memory_peak_bytes": max(peaks), "record": record, "prog": prog,
            "ref": refr, "phases": {"setup_s": setup_s, "window_s": elapsed, "reference_s": time.perf_counter() - t_ref}}


def _time_allreduce(n: int, mesh, dev, reps: int = 20) -> float | None:
    """The step's gradient all-reduce alone on a buffer of its size over the
    data group: mean ms of ``reps`` after 3, CUDA events."""
    import torch.distributed as dist

    if dev.type != "cuda":
        return None
    flat = torch.zeros(n, dtype=torch.float32, device=dev)
    for _ in range(3):
        dist.all_reduce(flat, group=mesh.data_group)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _sync(dev)
    a.record()
    for _ in range(reps):
        dist.all_reduce(flat, group=mesh.data_group)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _time_stacks(cfg, model, B, T, dev, reps: int = 5) -> dict:
    """The training stack entry (``fused_stack_train`` forward and backward)
    alone at the step's intra and inter shapes: mean ms of ``reps`` after 2."""
    from cse_tpu_torch.ops.fused_train import fused_stack_train

    from perfbench.metrics.sepformer_work import stack_shapes
    from perfbench.program import DTYPES

    if dev.type != "cuda":
        return None
    cd, blk = DTYPES[cfg["precision"]], model.masknet.dual_mdl[0]
    g = torch.Generator(device=dev).manual_seed(0)
    calls = []
    for view, (G, L) in stack_shapes(cfg, B, T).items():
        x = torch.randn(G, L, cfg["d_model"], generator=g, device=dev).to(cd).requires_grad_(True)
        gy = torch.randn(G, L, cfg["d_model"], generator=g, device=dev)
        stack = getattr(blk, f"{view}_mdl")

        def once():
            fused_stack_train(x, stack, nhead=cfg["nhead"], compute_dtype=cd).backward(gy)

        for _ in range(2):
            once()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            once()
        b.record()
        b.synchronize()
        calls.append({"view": view, "G": G, "L": L, "ms": a.elapsed_time(b) / reps})
        del x, gy
    model.zero_grad(set_to_none=True)
    return {"train": True, "quant": None, "calls": calls}
