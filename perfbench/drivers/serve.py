"""Traffic kind ``serve``: batch extraction requests in a closed loop.

Parameters (the mix's JSON): ``batch`` (mixtures a request), ``samples``
(the request lengths T), ``requests`` (how many requests of each length a
block holds: a block serves every length that often, in an order drawn
from ``order_seed``), ``order_seed`` (the blocks' orders are drawn from it
and not from ``--seed``: which lengths run side by side sets the latency
tail, so every seed serves the same work in the same order; the seed draws
the audio, the context and the weights), ``in_flight`` (clients, each
sending its next request when its last one is done), ``pool`` (distinct
input sets in host memory), ``quant`` (the engine's stacks: null or
``"w8a8"``), ``sample`` (finished requests checked against the reference,
besides the first of the longest length) and ``profile_requests`` (the
traced sub-window). A mix whose lengths come from a mixture list names it
in ``lengths_from`` with ``grid_s``; :func:`buckets_from_list` derives
``samples`` and ``requests`` from them.

A request copies its mixtures and context vectors in from pinned host
memory, runs ``ServingEngine.__call__`` and copies its streams (and the
selector's logits) out to pinned host memory; its latency runs from its
submission to the end of that copy. The device runs the requests in the
order they come; with two in flight the next one is queued while the
current one runs. Set-up warms every length the mix uses, in the same loop.
"""

from __future__ import annotations

import math
import re
import time

import numpy as np
import torch

from perfbench import weights as W
from perfbench.trace import SubWindow


def buckets_from_list(path, grid_s: float, batch: int, sample_rate: int) -> tuple[list[int], list[int]]:
    """Request lengths and counts from a mixture list whose file names carry
    each utterance's span in centiseconds (``talk-<start>-<end>.wav``, as
    TED-LIUM's): a mixture is as long as its longest utterance (the mixer
    pads the others), rounded up to ``grid_s``; each length is served in
    requests of ``batch`` mixtures, enough for every mixture of the list
    once. Returns (T in samples, requests of that T)."""
    count: dict[int, int] = {}
    with open(path) as f:
        lines = f.readlines()
    for line in lines:
        spans = [int(b) - int(a) for a, b in re.findall(r"-(\d+)-(\d+)\.wav", line)]
        if spans:
            cells = math.ceil(max(spans) / (100 * grid_s))
            count[cells] = count.get(cells, 0) + 1
    lengths = sorted(count)
    return ([round(n * grid_s * sample_rate) for n in lengths], [math.ceil(count[n] / batch) for n in lengths])


def request_order(requests: list[int], n: int, seed: int) -> list[int]:
    """Indices into ``samples`` for n requests: blocks that hold length i
    ``requests[i]`` times, each block in its own order."""
    rng = np.random.default_rng([seed, 2])
    block = np.repeat(np.arange(len(requests)), requests)
    out = []
    while len(out) < n:
        out += rng.permutation(block).tolist()
    return out[:n]


class _Request:
    def __init__(self, index, T, p, t_submit, outs, event):
        self.index, self.T, self.pool, self.t_submit, self.outs, self.event = index, T, p, t_submit, outs, event

    def wait(self) -> float:
        if self.event is not None:
            self.event.synchronize()
        return time.perf_counter()


class Server:
    """The closed loop's client side over one engine."""

    def __init__(self, engine, cfg, tr, mix_pool, ctx_pool, device, fault=None):
        self.engine, self.cfg, self.tr, self.device, self.fault = engine, cfg, tr, device, fault
        self.mix_pool, self.ctx_pool = mix_pool, ctx_pool

    def inputs(self, p: int, T: int):
        B = self.tr["batch"]
        return self.mix_pool[p, :B * T].view(B, T), self.ctx_pool[p]

    def _run(self, mix, ctx):
        h = mix.shape[0] // 2 if self.fault == "half" else mix.shape[0]  # half of the batch left out
        out = self.engine(mix[:h], ctx[:h])
        outs = out if isinstance(out, tuple) else (out,)
        if h < mix.shape[0]:
            outs = tuple(torch.cat([o, torch.zeros((mix.shape[0] - h, *o.shape[1:]), dtype=o.dtype, device=o.device)])
                         for o in outs)
        if self.fault == "alter":  # an answer altered where it is produced: mixture 0 gets 1's streams
            outs = (torch.cat([outs[0][1:2], outs[0][1:]]),) + outs[1:]
        return outs

    def submit(self, index: int, T: int) -> _Request:
        p = index % self.mix_pool.shape[0]
        t = time.perf_counter()
        with torch.profiler.record_function("bench/request"):
            mix, ctx = self.inputs(p, T)
            mix = mix.to(self.device, non_blocking=True)
            ctx = ctx.to(self.device, non_blocking=True)
            outs = self._run(mix, ctx)
            pin = self.device.type == "cuda"
            host = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=pin) for o in outs)
            for h, o in zip(host, outs):
                h.copy_(o, non_blocking=pin)
            event = None
            if pin:
                event = torch.cuda.Event()
                event.record()
        return _Request(index, T, p, t, host, event)


def closed_loop(server, samples, order, start, seconds=None, count=None, on_done=None):
    """Serve requests ``order[start:]`` with ``in_flight`` clients until
    ``seconds`` have passed (then finish those in flight) or ``count`` are
    done; ``on_done(request, t_done, k)`` after each. Returns
    ``(records, t0, t_end)``: (T, latency s) of each request."""
    inflight, records, i = [], [], start
    t0 = time.perf_counter()
    for _ in range(server.tr["in_flight"]):
        inflight.append(server.submit(i, samples[order[i]]))
        i += 1
    while inflight:
        req = inflight.pop(0)
        t_done = req.wait()
        records.append((req.T, t_done - req.t_submit))
        if on_done is not None:
            on_done(req, t_done, len(records))
        open_ = (count is None or i - start < count) and (seconds is None or t_done - t0 < seconds)
        if open_:
            inflight.append(server.submit(i, samples[order[i]]))
            i += 1
    return records, t0, time.perf_counter()


def make_pools(cfg, tr, seed, device):
    """Inputs in (pinned) host memory, made on the device from the seed:
    ``pool`` sets of ``batch`` mixtures of the longest length, each the sum
    of ``num_spks`` N(0, 0.1^2) sources, and a context vector a mixture."""
    g = W.generator(seed, device, 1)
    n, B, T = tr["pool"], tr["batch"], max(tr["samples"])
    mix = 0.1 * torch.randn(n, B * T, cfg["num_spks"], generator=g, device=device).sum(-1)
    ctx = torch.randn(n, B, 1, cfg["llm_dim"], generator=g, device=device)
    pin = device.type == "cuda"
    return mix.cpu().pin_memory() if pin else mix, ctx.cpu().pin_memory() if pin else ctx


def drive(ctx) -> dict:
    from cse_tpu_torch.serving import ServingEngine

    from perfbench import program

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    samples, B, sr = tr["samples"], tr["batch"], cfg["sample_rate"]
    order = request_order(tr["requests"], 1 << 16, tr["order_seed"])
    mix_pool, ctx_pool = make_pools(cfg, tr, ctx.seed, dev)
    model = program.build_model(cfg, W.draw_weights(cfg, ctx.seed, dev), dev)
    engine = ServingEngine(program.sepformer_config(cfg), model, device=dev, quant=tr["quant"])
    server = Server(engine, cfg, tr, mix_pool, ctx_pool, dev, ctx.fault)
    closed_loop(server, samples, list(range(len(samples))), 0, count=len(samples))  # every length once

    rng = np.random.default_rng([ctx.seed, 3])
    kept, longest, k_sample = [], None, tr["sample"]
    sub = SubWindow(dev) if ctx.trace else None
    prof = {}

    def on_done(req, t_done, k):
        nonlocal longest
        item = (req.index, req.T, req.pool, req.outs)
        if longest is None and req.T == max(samples):
            longest = item
        elif len(kept) < k_sample:
            kept.append(item)
        else:
            j = int(rng.integers(0, k))
            if j < k_sample:
                kept[j] = item
        if sub is None:
            return
        # from one completion to the profile_requests-th after it the device runs just those
        # requests (the next one is already queued): no wait for the device at either end
        if "at" not in prof and t_done - t0_ref[0] >= ctx.seconds / 3:
            sub.start(sync=False)
            prof.update(at=k, T=[])
        elif "at" in prof and sub.summary is None:
            prof["T"].append(req.T)
            if len(prof["T"]) == tr["profile_requests"]:
                sub.stop(sync=False)

    t0_ref = [time.perf_counter()]
    setup_s = t0_ref[0] - ctx.t_start
    records, t0, t_end = closed_loop(server, samples, order, 0, seconds=ctx.seconds, on_done=on_done)
    while sub is not None and sub.summary is None:  # a window too short for its sub-window
        more, _, _ = closed_loop(server, samples, order, len(records), count=tr["profile_requests"],
                                 on_done=lambda r, t, k: on_done(r, t, len(records) + k))
        records += more
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    lat = np.array([r[1] for r in records])
    audio = sum(B * T / sr for T, _ in records)

    record = None
    if ctx.trace:
        record = {"kind": "serve", "config": cfg, "batch": B, "quant": tr["quant"], "profile": [sub.summary],
                  "sub_window": {"samples": prof["T"], "elapsed_s": sub.summary["window_s"]},
                  "stack": _time_stacks(cfg, engine, B, samples, tr["quant"], dev)}
    del engine, model, server
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checked = ([longest] if longest else []) + kept
    prog = [item[3] for item in checked]
    t_ref = time.perf_counter()
    refr = reference_outputs(cfg, ctx.seed, [(mix_pool, ctx_pool, it[2], it[1], B) for it in checked], dev)
    return {"attempted": len(records), "failed": 0, "setup_s": setup_s,
            "e2e": {"serve_audio_s_per_s": audio / (t_end - t0), "serve_p95_ms": 1e3 * float(np.percentile(lat, 95))},
            "numbers": compare(prog, refr), "memory_peak_bytes": peak, "record": record,
            "phases": {"setup_s": setup_s, "window_s": t_end - t0, "reference_s": time.perf_counter() - t_ref},
            "checked": [(it[0], it[1], it[2]) for it in checked], "prog": prog, "ref": refr}


def reference_outputs(cfg, seed, items, device, prec=None) -> list:
    """The plain reference's outputs for each (pools, pool index, T, batch)."""
    from perfbench.reference import sepformer as ref

    ref.fp32_only()
    P = W.draw_weights(cfg, seed, device)
    out = []
    with torch.no_grad():
        for mix_pool, ctx_pool, p, T, B in items:
            mix = mix_pool[p, :B * T].view(B, T).to(device)
            res = ref.forward(cfg, P, mix, ctx_pool[p].to(device), prec, with_head=True)
            if isinstance(res, tuple):  # the selector's logits and their scale
                est, logits, head = res
                res = (est, logits, P["context_selector.weight"].norm() * head.norm(dim=-1) / head.shape[-1] ** 0.5)
            out.append(tuple(t.cpu() for t in (res if isinstance(res, tuple) else (res,))))
    return out


def compare(prog: list, refr: list) -> dict:
    """The widest relative L2 gap of a mixture's streams over the requests
    checked; for a selector, the L2 gap of all their logits together over
    the logits' scale, ||W|| ||h|| / sqrt(D) a mixture for the selector's
    weight W and the reference's input h (D wide): the size W gives an h of
    that norm. Over the logits' own norm the gap swung 6-fold between seeds,
    as the seeded selector's logits happened to be small or not."""
    streams, num, den = 0.0, 0.0, 0.0
    for p, r in zip(prog, refr):
        d = (p[0].float() - r[0]).flatten(1).norm(dim=1) / r[0].flatten(1).norm(dim=1)
        streams = max(streams, float(d.max()))
        if len(r) > 1:
            num += float(((p[1].float() - r[1]) ** 2).sum())
            den += float((r[2] ** 2).sum())
    out = {"stream_rel_l2": streams}
    if den:
        out["logit_gap"] = (num / den) ** 0.5
    return out


def _time_stacks(cfg, engine, B, samples, quant, dev, reps: int = 3) -> dict | None:
    """The serving stack entry (``fused_stack_apply``) alone at every
    request length's intra and inter shapes: mean ms of ``reps`` after 1."""
    from cse_tpu_torch.ops.fused_stack import fused_stack_apply

    from perfbench.metrics.sepformer_work import stack_shapes
    from perfbench.program import DTYPES

    if dev.type != "cuda":
        return None
    cd = DTYPES[cfg["precision"]]
    g = torch.Generator(device=dev).manual_seed(0)
    calls = []
    with torch.inference_mode():
        for T in samples:
            for view, (G, L) in stack_shapes(cfg, B, T).items():
                x = torch.randn(G, L, cfg["d_model"], generator=g, device=dev).to(cd)
                w = engine.stacks[f"0.{view}"]
                fused_stack_apply(x, w, nhead=cfg["nhead"], compute_dtype=cd, quant=quant)
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(reps):
                    fused_stack_apply(x, w, nhead=cfg["nhead"], compute_dtype=cd, quant=quant)
                b.record()
                b.synchronize()
                calls.append({"view": view, "T": T, "G": G, "L": L, "ms": a.elapsed_time(b) / reps})
    return {"train": False, "quant": quant, "calls": calls}
