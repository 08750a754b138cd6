"""Traffic kind ``serve_history``: extraction requests whose context is the dialog history's encoding.

The closed loop of ``drivers/serve.py`` (its parameters, its TED-LIUM
request lengths and order, its audio pool), where each request also carries
its mixtures' histories as token ids: the program encodes them with its
DeepSeek-V2 history encoder and conditions the separator on the last hidden
state, in one ``ServingEngine.__call__(mix, ids=, mask=)``. The cell's
configuration is the checkout's ``config.json`` keys beside the separator's.

A mixture's history is its target's talk transcript up to the target
utterance: the target is the list line's first file, which starts
``start_s`` into its talk, and the history holds ``min(history_cap,
round(rate x tokens_per_word x start_s))`` tokens, ``rate`` the median words
per second of talk time over the ``transcripts`` (words over the end of the
talk's last segment). A request of a given audio length takes the histories
of that length's list lines, ten at a time, cycling, so each length keeps
the histories it has in the list. A request is left-padded to the smallest
of ``widths`` that holds its longest history. The token ids are drawn from
``--seed``, uniform over the vocabulary, ``pool`` sets of ``batch`` rows
``history_cap`` wide: a history of n tokens is the last n of its row. Ids
and mask are copied in from pinned host memory with the audio.

The comparison that decides ``correct`` (after the window, the program's
state freed): the plain reference (``reference/deepseek_v2.py``, fp32)
encodes each history of the checked requests alone and unpadded, and
``reference/sepformer.py`` separates on its vectors. ``ctx_rel_l2`` is the
largest relative L2 gap of a mixture's context vector; ``ctx_rel_l2_routed``
the same gap against the reference made to take the program's experts
(``reference/deepseek_v2.py``'s ``force``; the program's routes of the real
tokens from a second run of the checked requests), so that the routes that
rounding flips near a tie, most of the free gap, leave the mathematics of
the experts to be compared alone; ``route_mismatch`` the share of (token,
layer) routes whose expert set differs from the reference's, which holds
the routing itself (a program that takes another number of experts reads
1); ``stream_rel_l2`` and ``logit_gap`` are ``serve.compare``'s. Read, not
compared: the share of padded tokens (``padded_share``). A control
(``calibrate``) takes the program's place with its own routes.

Set-up runs every request length once on the narrowest histories (the
separator's shapes depend on the length alone), then each width once (the
encoder's, on the width alone).

The traced run keeps ``serve``'s record (``kind``, ``profile``,
``sub_window`` with the histories of the requests it ran) and adds the span
table of its sub-window (``spans``, ``perfbench/spans.py::reduce_spans``)
and ``encoder``: the requests launched inside the sub-window (width and
history lengths), the encoder's counters, read after the window, and its
reads of device values by the host in the sub-window (``host_reads``:
``perfbench/host_reads.py`` over the occurrences of ``cse/ctx.encode``). A
program without the encoder ends the run at once, before any work.
``calibrate --faults`` plants :data:`FAULTS` in the program's encoder.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import re
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import weights as W
from perfbench.drivers import serve as S
from perfbench.host_reads import count_reads
from perfbench.reference import deepseek_v2 as DR
from perfbench.spans import reduce_spans
from perfbench.trace import SubWindow

IDS_STREAM = 4  # the token ids' stream of the run's draws (weights.generator)


def talk_rate(transcripts: Path) -> float:
    """Median words per second of talk time over the talks of a Kaldi-style
    ``segments`` / ``text`` pair: a talk's words over its last segment's end."""
    talk_of, end = {}, collections.defaultdict(float)
    for line in (transcripts / "segments").read_text().splitlines():
        utt, talk, _, stop = line.split()
        talk_of[utt] = talk
        end[talk] = max(end[talk], float(stop))
    words = collections.Counter()
    for line in (transcripts / "text").read_text().splitlines():
        utt, *text = line.split()
        words[talk_of[utt]] += len(text)
    return statistics.median(words[t] / end[t] for t in words)


def history_lines(tr: dict, root: Path, sample_rate: int) -> dict[int, list[int]]:
    """Each request length T (samples) -> the history lengths of its list
    lines in list order (the length as ``serve.buckets_from_list`` gives it)."""
    rate = talk_rate(root / tr["transcripts"])
    out = collections.defaultdict(list)
    for line in (root / tr["lengths_from"]).read_text().splitlines():
        found = re.findall(r"-(\d+)-(\d+)\.wav", line)
        if not found:
            continue
        cells = math.ceil(max(int(b) - int(a) for a, b in found) / (100 * tr["grid_s"]))
        start_s = int(found[0][0]) / 100
        out[round(cells * tr["grid_s"] * sample_rate)].append(
            min(tr["history_cap"], round(rate * tr["tokens_per_word"] * start_s)))
    return dict(out)


def width_of(lengths, widths) -> int:
    return next(w for w in widths if w >= max(lengths))


def mask_of(lengths, width: int, out=None) -> torch.Tensor:
    """The left-padded mask [len(lengths), width] (True on the real tokens)."""
    return torch.ge(torch.arange(width), width - torch.tensor(lengths)[:, None], out=out)


class Plan:
    """Which histories each request carries: request ``i`` of ``order``
    (length ``samples[order[i]]``) is its length's j-th request so far and
    takes that length's list lines ``j B .. j B + B - 1``, cycling."""

    def __init__(self, tr: dict, lines: dict[int, list[int]], samples: list[int], order: list[int]):
        self.B, self.widths, self.lines = tr["batch"], tr["widths"], lines
        self.samples, self.order = samples, order
        self._nth, seen = [], collections.Counter()
        for k in order:
            self._nth.append(seen[k])
            seen[k] += 1

    def spec(self, i: int) -> tuple[int, tuple[int, ...], int]:
        """(T, history lengths, width) of request i."""
        T = self.samples[self.order[i]]
        pool = self.lines[T]
        lengths = tuple(pool[(self._nth[i] * self.B + b) % len(pool)] for b in range(self.B))
        return T, lengths, width_of(lengths, self.widths)


def warm_specs(samples, widths, B) -> list[tuple[int, tuple[int, ...], int]]:
    """Set-up's requests: every length once on histories of the narrowest
    width (the separator's shapes), then every other width once (the
    encoder's)."""
    w0 = widths[0]
    return [(T, (w0,) * B, w0) for T in samples] + [(samples[0], (w,) * B, w) for w in widths[1:]]


class Fixed:
    """A plan of given (T, history lengths, width) specs, request by request."""

    def __init__(self, specs):
        self.specs = specs

    def spec(self, i: int):
        return self.specs[i]


def make_pools(cfg, tr, seed, device):
    """``serve``'s audio pool (the same mixtures a seed gives there) and the
    token ids, ``pool`` x ``batch`` rows ``history_cap`` wide, int32 in
    (pinned) host memory."""
    mix_pool, _ = S.make_pools(dict(cfg, llm_dim=1), tr, seed, device)
    g = W.generator(seed, device, IDS_STREAM)
    ids = torch.randint(0, cfg["vocab_size"], (tr["pool"], tr["batch"], tr["history_cap"]), generator=g,
                        device=device, dtype=torch.int32)
    return mix_pool, (ids.cpu().pin_memory() if device.type == "cuda" else ids)


class Recorder:
    """The program's encoder as the engine calls it, keeping its last output:
    the context vectors the request was conditioned on."""

    def __init__(self, encoder):
        self.encoder, self.last = encoder, None

    def __call__(self, ids, mask):
        self.last = self.encoder(ids, mask)
        return self.last


class Server(S.Server):
    """The closed loop's client side: each request's mixtures, ids and mask
    in, its streams, logits and context vectors out."""

    def __init__(self, engine, cfg, tr, mix_pool, ids_pool, plan, device, fault=None):
        super().__init__(engine, cfg, tr, mix_pool, None, device, fault)
        self.plan, self.launched = plan, None
        self.recorder = engine.context_encoder
        pin = device.type == "cuda"
        cap = tr["history_cap"]
        self.ids = {w: (ids_pool[:, :, cap - w:].contiguous().pin_memory() if pin
                        else ids_pool[:, :, cap - w:].contiguous()) for w in tr["widths"]}
        # masks are written into a ring of pinned buffers a width: a buffer comes round again only
        # after its request's copy in has run (at most in_flight requests are open)
        ring = tr["in_flight"] + 2
        self.masks = {w: [torch.empty(tr["batch"], w, dtype=torch.bool, pin_memory=pin) for _ in range(ring)]
                      for w in tr["widths"]}
        self._sent = 0

    def submit(self, index: int, T: int) -> S._Request:
        _, lengths, width = self.plan.spec(index)
        p = index % self.mix_pool.shape[0]
        B = self.tr["batch"]
        t = time.perf_counter()
        with torch.profiler.record_function("bench/request"):
            mix = self.mix_pool[p, :B * T].view(B, T).to(self.device, non_blocking=True)
            ids = self.ids[width][p].to(self.device, non_blocking=True)
            ring = self.masks[width]
            mask = mask_of(lengths, width, out=ring[self._sent % len(ring)]).to(self.device, non_blocking=True)
            self._sent += 1
            out = self.engine(mix, ids=ids, mask=mask)
            outs = (out if isinstance(out, tuple) else (out,)) + (self.recorder.last,)
            pin = self.device.type == "cuda"
            host = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=pin) for o in outs)
            for h, o in zip(host, outs):
                h.copy_(o, non_blocking=pin)
            event = None
            if pin:
                event = torch.cuda.Event()
                event.record()
        if self.launched is not None:
            self.launched.append([width, list(lengths)])
        return S._Request(index, T, p, t, host, event)


class SpanWindow(SubWindow):
    """``trace.SubWindow`` that also keeps the sub-window's span table and
    the encoder's host reads."""

    def stop(self, sync: bool = True):
        prof = self._prof
        summary = super().stop(sync)
        self.spans = reduce_spans(prof.events(), 1e6 * summary["window_s"])
        self.host_reads = count_reads(prof.events(), "cse/ctx.encode")
        return summary


FAULTS = ("top_k_less_one", "expert_dropped", "no_yarn_mscale")


def plant(fault: str, dv):
    """(name, replacement) in the program's module ``dv`` for a fault of
    :data:`FAULTS`: top-(k-1) routing, expert 0's output dropped, the YaRN
    mscale^2 left out of the softmax scale."""
    route = dv.route
    if fault == "top_k_less_one":
        def fewer(x, router, cfg):
            return route(x, router, dataclasses.replace(cfg, num_experts_per_tok=cfg.num_experts_per_tok - 1))
        return "route", fewer
    if fault == "expert_dropped":
        def dropped(x, router, cfg):
            w, idx = route(x, router, cfg)
            return torch.where(idx == 0, 0.0, w), idx
        return "route", dropped
    if fault == "no_yarn_mscale":
        return "softmax_scale", lambda cfg: cfg.qk_head_dim ** -0.5
    raise SystemExit(f"perfbench: serve_history plants no fault {fault!r} (only {', '.join(FAULTS)})")


def _program():
    """The program's encoder and engine, or a clean exit when it has none."""
    try:
        from cse_tpu_torch.models.deepseek_v2 import (DeepseekV2Config, DeepseekV2ContextEncoder,
                                                      deepseek_v2_forward, params_from_state_dict)
        from cse_tpu_torch.serving import ServingEngine
    except ImportError as e:
        raise SystemExit(f"perfbench: the program has no DeepSeek-V2 history encoder ({e}); no result")
    return DeepseekV2Config, DeepseekV2ContextEncoder, deepseek_v2_forward, params_from_state_dict, ServingEngine


def drive(ctx) -> dict:
    program = _program()
    if ctx.fault is None:
        return _drive(ctx, *program)
    import cse_tpu_torch.models.deepseek_v2 as dv

    name, fn = plant(ctx.fault, dv)
    kept = getattr(dv, name)
    setattr(dv, name, fn)
    try:
        return _drive(ctx, *program)
    finally:
        setattr(dv, name, kept)


def _drive(ctx, Config, Encoder, forward, from_state_dict, ServingEngine) -> dict:
    from perfbench import program

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    samples, B, sr = tr["samples"], tr["batch"], cfg["sample_rate"]
    order = S.request_order(tr["requests"], 1 << 16, tr["order_seed"])
    lines = history_lines(tr, ctx.cell.root, sr)
    plan = Plan(tr, lines, samples, order)
    mix_pool, ids_pool = make_pools(cfg, tr, ctx.seed, dev)

    enc_cfg = Config.from_dict(cfg)
    sd = DR.draw_weights(cfg, ctx.seed, dev)
    encoder = Encoder(params=from_state_dict(sd.pop, enc_cfg, device=dev), cfg=enc_cfg)
    del sd
    model = program.build_model(cfg, W.draw_weights(cfg, ctx.seed, dev), dev)
    engine = ServingEngine(program.sepformer_config(cfg), model, device=dev, quant=tr["quant"],
                           context_encoder=Recorder(encoder))
    server = Server(engine, cfg, tr, mix_pool, ids_pool, plan, dev)

    warm = warm_specs(samples, tr["widths"], B)
    server.plan = Fixed(warm)
    S.closed_loop(server, [s[0] for s in warm], list(range(len(warm))), 0, count=len(warm))
    server.plan = plan

    rng = np.random.default_rng([ctx.seed, 3])
    kept, widest, k_sample = [], None, tr["sample"]
    sub = SpanWindow(dev) if ctx.trace else None
    prof = {}

    def on_done(req, t_done, k):
        nonlocal widest
        item = (req.index, req.T, req.pool, req.outs)
        if widest is None and plan.spec(req.index)[2] == max(tr["widths"]):
            widest = item
        elif len(kept) < k_sample:
            kept.append(item)
        else:
            j = int(rng.integers(0, k))
            if j < k_sample:
                kept[j] = item
        if sub is None:
            return
        if "at" not in prof and t_done - t0_ref[0] >= ctx.seconds / 3:
            sub.start(sync=False)
            server.launched = []
            prof.update(at=k, T=[], histories=[])
        elif "at" in prof and sub.summary is None:
            prof["T"].append(req.T)
            prof["histories"].append(list(plan.spec(req.index)[1]))
            if len(prof["T"]) == tr["profile_requests"]:
                sub.stop(sync=False)
                prof["launched"], server.launched = server.launched, None

    t0_ref = [time.perf_counter()]
    setup_s = t0_ref[0] - ctx.t_start
    records, t0, t_end = S.closed_loop(server, samples, order, 0, seconds=ctx.seconds, on_done=on_done)
    while sub is not None and sub.summary is None:  # a window too short for its sub-window
        more, _, _ = S.closed_loop(server, samples, order, len(records), count=tr["profile_requests"],
                                   on_done=lambda r, t, k: on_done(r, t, len(records) + k))
        records += more
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    lat = np.array([r[1] for r in records])
    audio = sum(B * T / sr for T, _ in records)
    counters = encoder.counters.read()

    checked = ([widest] if widest else []) + kept
    items = [(it[0], it[1], (it[2], plan.spec(it[0])[1])) for it in checked]
    prog = [item[3] for item in checked]
    routes = [_program_routes(forward, encoder, server, plan, it[0]) for it in checked]
    record = None
    if ctx.trace:
        record = {"kind": "serve", "config": cfg, "batch": B, "quant": tr["quant"], "profile": [sub.summary],
                  "sub_window": {"samples": prof["T"], "histories": prof["histories"],
                                 "elapsed_s": sub.summary["window_s"]},
                  "spans": sub.spans, "encoder": {"submitted": prof["launched"], "counters": counters,
                                                  "host_reads": sub.host_reads}}
        print(f"perfbench: span table of the sub-window {json.dumps(sub.spans)}", file=sys.stderr, flush=True)
    del engine, model, server, encoder
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    refr = reference_outputs(cfg, ctx.seed, [(mix_pool, ids_pool, p, T, B) for _, T, p in items], dev,
                             at_routes=routes)
    prog = [p[:-1] + (q, p[-1], r[-1]) for p, q, r in zip(prog, routes, refr)]
    refr = [r[:-1] for r in refr]
    numbers = compare(prog, refr)
    numbers["padded_share"] = counters["tokens_padded"] / (counters["tokens_padded"] + counters["tokens_real"])
    return {"attempted": len(records), "failed": 0, "setup_s": setup_s,
            "e2e": {"serve_audio_s_per_s": audio / (t_end - t0), "serve_p95_ms": 1e3 * float(np.percentile(lat, 95))},
            "numbers": numbers, "memory_peak_bytes": peak, "record": record,
            "phases": {"setup_s": setup_s, "window_s": t_end - t0, "reference_s": time.perf_counter() - t_ref},
            "checked": items, "prog": prog, "ref": refr}


def _program_routes(forward, encoder, server, plan, index: int) -> list[torch.Tensor]:
    """The program's top-k experts of the real tokens of request ``index``,
    per MoE layer (its histories in order, uint8 on the host), from a second
    run."""
    _, lengths, width = plan.spec(index)
    p = index % server.mix_pool.shape[0]
    mask = mask_of(lengths, width).to(server.device)
    routes = []
    with torch.inference_mode():
        forward(encoder.params, server.ids[width][p].to(server.device), mask, encoder.cfg, routes=routes)
    real = mask.reshape(-1)
    return [r[real].to(torch.uint8).cpu() for r in routes]


def _mismatch(prog: list, ref: list) -> float:
    """The share of (token, layer) routes whose expert sets differ, over
    entries of per-layer routes [n, k]."""
    a = [r.sort(dim=-1).values.long() for routes in prog for r in routes]
    b = [r.sort(dim=-1).values.long() for routes in ref for r in routes]
    if not a:
        return 0.0
    a, b = torch.cat(a), torch.cat(b)
    if a.shape != b.shape:  # another number of experts a token: every route differs
        return 1.0
    return float((a != b).any(dim=-1).float().mean())


def reference_outputs(cfg, seed, items, device, prec=None, at_routes=None) -> list:
    """For each (pools, (pool index, history lengths), T, batch): the plain
    reference's streams, logits and logit scale (``serve.reference_outputs``)
    on the reference encoder's context vectors, then the encoder's routes
    (per MoE layer, the experts of the entry's tokens, histories in order),
    those vectors, and the fp32 reference's vectors at ``at_routes`` (such
    routes an entry), else at the encoder's own routes. So each entry stands
    where the program's does in :func:`compare`. ``prec`` lowers one side
    for a control: the encoder's (``fp8_experts``,
    ``reference/deepseek_v2.py``) or the separator's (``fp8``, ``int4``,
    ``reference/sepformer.py``); the other runs fp32."""
    mix_pool, ids_pool = items[0][0], items[0][1]
    cap = ids_pool.shape[-1]
    hist = [ids_pool[p][b, cap - n:] for _, _, (p, lengths), _, _ in items for b, n in enumerate(lengths)]
    DR.fp32_only()
    enc_w = DR.draw_weights(cfg, seed, device)
    enc_prec = prec if prec in DR.PRECISIONS else None
    own = []
    ctx = DR.encode(cfg, enc_w, hist, enc_prec, own)
    if at_routes is not None:
        at = DR.encode(cfg, enc_w, hist, None, force=[torch.cat(layer) for layer in zip(*at_routes)])
    elif enc_prec is not None:
        at = DR.encode(cfg, enc_w, hist, None, force=own)
    else:  # the fp32 reference at its own routes is itself
        at = ctx
    sizes = [sum(lengths) for _, _, (_, lengths), _, _ in items]
    parts = [r.to(torch.uint8).cpu().split(sizes) for r in own]
    own = [[layer[i] for layer in parts] for i in range(len(items))]
    del enc_w
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ctxs = ctx.view(len(items), -1, 1, ctx.shape[-1])
    ats = at.view(len(items), -1, 1, at.shape[-1])
    sep = S.reference_outputs(cfg, seed, [(mix_pool, {p: c}, p, T, B) for (_, _, (p, _), T, B), c in zip(items, ctxs)],
                              device, prec=None if prec in DR.PRECISIONS else prec)
    return [r + (o, c.cpu(), a.cpu()) for r, o, c, a in zip(sep, own, ctxs, ats)]


def _ctx_gap(a: list, b: list) -> float:
    """The widest relative L2 gap of a mixture's context vector, over ``b``'s norm."""
    gap = 0.0
    for p, r in zip(a, b):
        d = (p.float() - r).flatten(1).norm(dim=1) / r.flatten(1).norm(dim=1)
        gap = max(gap, float(d.max()))
    return gap


def compare(prog: list, refr: list) -> dict:
    """``serve.compare``'s numbers, ``ctx_rel_l2``, ``ctx_rel_l2_routed`` and
    ``route_mismatch``. Each of ``prog`` ends in its routes, its context
    vectors and the fp32 reference's at its routes; each of ``refr`` in the
    reference's routes and vectors."""
    out = S.compare([p[:-3] for p in prog], [r[:-2] for r in refr])
    out["ctx_rel_l2"] = _ctx_gap([p[-2] for p in prog], [r[-1] for r in refr])
    out["ctx_rel_l2_routed"] = _ctx_gap([p[-2] for p in prog], [p[-1] for p in prog])
    out["route_mismatch"] = _mismatch([p[-3] for p in prog], [r[-2] for r in refr])
    return out
