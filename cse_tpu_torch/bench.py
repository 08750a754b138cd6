"""Benchmark: training throughput of the CSE separator variants on one GPU.

    python -m cse_tpu_torch.bench                      # ContExt train step, B=16, 16 s
    python -m cse_tpu_torch.bench --variant contsep
    python -m cse_tpu_torch.bench --infer [--serving_quant w8a8]
    python -m cse_tpu_torch.bench --with_llm [--llama_quant w8a8] [--ctx_sim]
    python -m cse_tpu_torch.bench --cascaded [--cascaded_llm]
    python -m cse_tpu_torch.bench --smoke [--infer]    # tiny config on the CPU
    python -m torch.distributed.run --nproc_per_node N -m cse_tpu_torch.bench --mesh_data N

The port's counterpart of the root ``bench.py``, for the flags the port can
serve. Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}, with
the root bench's metric names.

Metric: mixtures/s on one GPU through the whole train step
(``make_train_step(fused=True)``: the fused forward and backward stacks, the
loss, the backward and the AdamW-amsgrad update) at the reference training
shape: 16 s at 8 kHz (``aligned_bucket``: 125000 samples), one context vector
per mixture, bf16, B=16, the ``cosine_warmup_schedule(1.5e-4, 500000,
10000)`` schedule. ``--variant`` selects the recipe: ``context`` (-SI-SNR on
stream 0), ``contsep`` (PIT SI-SNR + the weighted BCE selector loss, 2
decoded streams) or ``hcontext`` (each timed step first crops a random 1-5
s enrollment from a fixed 16 kHz source [B, 2·T] and runs the frozen
ECAPA-TDNN on it: 1024 channels, random weights, 64 under ``--smoke``; then
the step with that embedding and the step's own cue draw). ``--infer``
measures the realtime factor of the fused serving engine instead
(``--variant hcontext`` there too, with a random speaker embedding and cue
0), ``--serving_quant w8a8`` its int8 stacks.

``--with_llm`` puts the frozen Llama-3-8B prefill inside the timed step
(the trainers' path: ``llm_apply`` on ``context_ids`` / ``context_mask``),
on the full 32-layer 8B shape (4096 / 14336, 32 query and 8 key-value heads)
with random weights drawn on the card and no LM head, int8 weight-only
(``--llama_quant w8a8``: int8 activations too), ``--ctx_tokens`` tokens a
row; the batch defaults to 8 there. ``--ctx_sim`` draws each step's
dialog-history lengths from a DailyTalk-like distribution (1-15 turns of
~19 tokens, numpy seed 3) and pads each batch to the smallest of
``--ctx_sim_buckets`` that fits. With ``--smoke`` the Llama is a 2-layer tiny
configuration. Standard error gets the bare prefill's time on the same
weights (a decomposition, not the result).

``--cascaded`` measures the realtime factor of the cascaded pipeline on one
mixture at a time (the reference's batch 1): the base separator through the
fused serving engine (bf16, 2 streams, ``--seconds`` of audio), 8k->16k and
the peak norm, Whisper-base (random weights, fp32, the greedy rung, language
pinned to English, a 224-token budget) under the transcribe policy, then the
selection, scored by the crc32 stand-in or, with ``--cascaded_llm``, by the
8B shape in int8 on random weights drawn on the card (its logits). Random
weights make it a worst case: noise transcripts tend to spend the whole
budget. It keeps PyTorch's default precision settings (cuDNN may run the
convolutions in TF32). With ``--smoke``: the tiny separator, Whisper at
width 64 (2 + 2 layers, the real vocabulary and window), 16 tokens, a
2-layer Llama.

``--mesh_data N`` runs the train step data-parallel over N processes, one
per rank (torchrun, or JAX's ``COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES``
/ ``JAX_PROCESS_ID``; N must be the world size), exactly the trainers'
sharded step: the global batch is ``--batch`` x N, each rank takes its
``--batch`` rows, and the value is mixtures/s per chip (the unit notes
"DP xN (global batch M)"). Only rank 0 prints. ``--infer`` and
``--cascaded`` ignore it, as the root bench does.

It runs on the card, and raises without one; only ``--smoke`` selects the
CPU (gloo under ``--mesh_data``).

vs_baseline: the reference publishes no throughput (BASELINE.md), so the
denominator is the root bench's documented estimate of the 8xA100 recipe's
per-GPU rate: ~0.5 s/iter at per-GPU batch 2 => ~4 mixtures/s per A100,
taken as audio seconds per second at 16 s clips.

Its standard error gets one JSON line too, ``{"launches", "calls"}``: each
kernel wrapper's launches over the warmup and the timed calls (zero counts
left out; on the CPU, where the plain versions run, none), and how many
steps or forwards that was.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from cse_tpu_torch.core.device import resolve_device
from cse_tpu_torch.core.mesh import distributed_init_if_needed, make_mesh, process_count, process_index
from cse_tpu_torch.models import Sepformer, SepformerConfig
from cse_tpu_torch.ops.buckets import aligned_bucket

REF_MIXTURES_PER_SEC_PER_GPU = 4.0  # documented estimate, see module docstring


def _metric_name(args) -> str:
    if args.infer:
        return {
            "context": "inference_rtf_contextual_extraction",
            "contsep": "inference_rtf_contsep",
            "hcontext": "inference_rtf_hcontext",
        }[args.variant]
    if args.cascaded:
        return "cascaded_pipeline_rtf"
    stem = {
        "context": "train_throughput_contextual_extraction",
        "contsep": "train_throughput_contsep",
        "hcontext": "train_throughput_hcontext",
    }[args.variant]
    return stem + ("_with_llm" if args.with_llm else "")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=None,
                    help="mixtures per step (one GPU); default 16, or 8 with --with_llm")
    ap.add_argument("--seconds", type=float, default=16.0, help="mixture length (s)")
    ap.add_argument("--sr", type=int, default=8000)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--smoke", action="store_true", help="tiny config on the CPU (plumbing only)")
    ap.add_argument("--variant", choices=("context", "contsep", "hcontext"), default="context",
                    help="the paper recipe measured: context (ContExt, the default), contsep (PIT + "
                         "selector losses, 2 decoded streams), hcontext (ContExt + the frozen ECAPA "
                         "enrollment cue)")
    ap.add_argument("--infer", action="store_true",
                    help="measure the realtime factor of the fused serving engine instead")
    ap.add_argument("--serving_quant", choices=("w8a8",), default=None,
                    help="with --infer: int8 weights and per-row int8 activations in the stacks")
    ap.add_argument("--with_llm", action="store_true",
                    help="include the frozen Llama-3-8B context prefill in the step (32-layer 8B shape, random "
                         "weights, --llama_quant)")
    ap.add_argument("--ctx_tokens", type=int, default=512, help="context length for --with_llm (left-padded)")
    ap.add_argument("--ctx_sim", action="store_true",
                    help="with --with_llm: DailyTalk-like dialog-history lengths per batch, each batch padded to "
                         "the smallest of --ctx_sim_buckets that fits")
    ap.add_argument("--ctx_sim_buckets", type=str, default="128 256 384 512",
                    help="buckets for --ctx_sim (space-separated)")
    ap.add_argument("--llama_quant", choices=("int8", "w8a8"), default="int8",
                    help="the --with_llm prefill's weights: int8 weight-only (bf16 products) or w8a8 (int8 "
                         "activations too, torch._int_mm)")
    ap.add_argument("--mesh_data", type=int, default=None,
                    help="run the step data-parallel over N processes, one per rank (global batch = --batch x N; "
                         "reports per-chip throughput); N must be the world size")
    ap.add_argument("--cascaded", action="store_true",
                    help="measure the cascaded pipeline's realtime factor (separate, Whisper, select) instead")
    ap.add_argument("--cascaded_llm", action="store_true",
                    help="with --cascaded: score with the 8B-shape Llama in int8 (random weights), not the stand-in")
    args = ap.parse_args(argv)
    if args.batch is None:
        args.batch = 8 if args.with_llm else 16
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device("cpu" if args.smoke else None)
    if args.cascaded:
        line = _bench_cascaded(args, dev)
        print(json.dumps(line), flush=True)
        return line

    model_variant = "contsep" if args.variant == "contsep" else "context"
    vkw = dict(add_se=True) if args.variant == "hcontext" else {}
    if args.smoke:
        cfg = SepformerConfig(
            variant=model_variant, enc_channels=16, enc_kernel=8, enc_stride=4,
            d_model=16, nhead=4, d_ffn=32, num_tf_layers=1, num_dp_layers=1,
            chunk_size=10, llm_dim=64, pe_max_len=256, **vkw,
        )
        B, T = 2, 2000
    else:
        # the fused stacks keep only each chunk's input for the backward: no remat
        cfg = SepformerConfig(variant=model_variant, num_spks=2, compute_dtype=torch.bfloat16, **vkw)
        # the aligned bucket: the largest T <= 16 s whose inter sequence fits 128 rows
        B, T = args.batch, aligned_bucket(int(args.seconds * args.sr))
    model = Sepformer(cfg, generator=torch.Generator().manual_seed(0))
    line = (_bench_infer if args.infer else _bench_train)(args, cfg, model, B, T, dev)
    if process_index() == 0:
        print(json.dumps(line), flush=True)
    return line


def _dtype_name(cfg) -> str:
    return "bf16" if cfg.compute_dtype == torch.bfloat16 else "fp32"


def _bench_train(args, cfg, model, B, T, dev) -> dict:
    from cse_tpu_torch.train.optimizer import build_optimizer
    from cse_tpu_torch.train.schedules import cosine_warmup_schedule
    from cse_tpu_torch.train.step import TrainConfig, make_train_step

    mesh, n_chips = None, 1
    if args.mesh_data:
        # data parallel over one process per rank, exactly the trainers' sharded step
        # (train/step.py): each rank holds its --batch rows, the parameters replicated
        distributed_init_if_needed(device=dev)
        if args.mesh_data != process_count():
            raise SystemExit(f"--mesh_data {args.mesh_data} must be the world size, {process_count()} "
                             "process(es): launch one process per rank (python -m torch.distributed.run "
                             "--nproc_per_node N)")
        n_chips = args.mesh_data
        mesh = make_mesh(n_data=n_chips, device=dev)
    G = B * n_chips  # the global batch; each rank's share stays --batch
    rows = slice(None) if mesh is None else slice(mesh.data_index * B, (mesh.data_index + 1) * B)
    rng = np.random.default_rng(0)
    gt = rng.standard_normal((G, T)).astype(np.float32)
    batch = {
        "mixed": 0.7 * gt + 0.3 * rng.standard_normal((G, T)).astype(np.float32),
        "gt": gt,
    }
    if args.variant == "contsep":
        # PIT targets: gt + 1 interferer (the 2-speaker DailyTalk recipe)
        batch["noises"] = rng.standard_normal((G, T, 1)).astype(np.float32)
    llm = _llm_setup(args, cfg, G, dev, mesh) if args.with_llm else None
    if llm is not None:  # this rank's rows of the full-width context for the bare prefill
        llm["full"] = tuple(t[rows] for t in llm["full"])
    else:
        batch["ctx_feat"] = rng.standard_normal((G, 1, cfg.llm_dim)).astype(np.float32)
    if args.variant == "hcontext":
        batch["gt16k"] = rng.standard_normal((G, 2 * T)).astype(np.float32)  # the 16 kHz source
    batch = {k: torch.from_numpy(v[rows]).to(dev) for k, v in batch.items()}
    gt16k = batch.pop("gt16k", None)
    with_se = _enrollment(args, gt16k, dev) if gt16k is not None else (lambda b: b)
    batches = [batch]
    if llm is not None:
        batches = [dict(batch, context_ids=ids[rows], context_mask=mask[rows]) for ids, mask in llm["contexts"]]

    tcfg = TrainConfig(
        variant=args.variant, num_spks=2,
        # DailyTalk 2-speaker ContSep recipe: ce forced off (BCE), ctx_weight 5.0
        # (reference train_ContSep.py:167-168, README.md:119)
        use_ce=False, ctx_weight=5.0,
    )
    llm_kw = dict(llm_apply=llm["apply"], llm_params=llm["params"]) if llm else {}
    step = make_train_step(model, build_optimizer(cosine_warmup_schedule(1.5e-4, 500000, 10000)), tcfg,
                           fused=not args.smoke, device=dev, mesh=mesh, **llm_kw)
    cue_gen = torch.Generator().manual_seed(0)  # hcontext: the step's cue draws
    _reset_launches()
    # with --ctx_sim: one step at each context width first, as the root bench compiles one program per width
    first = [next(b for b in batches if b["context_ids"].shape[1] == w) for w in llm["widths"]] if llm else []
    for b in first + [batches[0]] * args.warmup:
        m = step.tensors(with_se(b), cue_gen)
    float(m["loss"])  # one read: the device has finished the warmup
    t0 = time.perf_counter()
    for s in range(args.steps):
        m = step.tensors(with_se(batches[s % len(batches)]), cue_gen)
    float(m["loss"])
    dt = time.perf_counter() - t0
    llm_note = _llm_decomposition(args, llm, dt) if llm else ""
    _report_launches(len(first) + args.warmup + args.steps)

    var_note = {"context": "", "contsep": ", PIT+BCE-selector 2-stream",
                "hcontext": ", frozen ECAPA on a 1-5 s enrollment crop in-step"}[args.variant]
    mixtures_per_sec = G * args.steps / dt / n_chips
    audio_s_per_s = mixtures_per_sec * T / args.sr
    ref_audio_s = REF_MIXTURES_PER_SEC_PER_GPU * 16.0  # per A100, 16 s clips
    dp_note = "" if mesh is None else ", DP x%d (global batch %d)" % (n_chips, G)
    return {
        "metric": _metric_name(args),
        "value": mixtures_per_sec,
        "unit": "mixtures/s%s (%.3fs@8kHz, %s, batch %d%s%s; %.1f audio-s/s%s; %s)"
                % ("/GPU" if dev.type == "cuda" else "", T / args.sr, _dtype_name(cfg), B, dp_note, var_note,
                   audio_s_per_s, llm_note, _where(dev)),
        "vs_baseline": audio_s_per_s / ref_audio_s,
    }


def _enrollment(args, gt16k, dev):
    """The H-ContExt recipe's per-step enrollment: ``batch -> batch`` with
    ``se`` from the frozen ECAPA (random weights, seed 0; 64 channels under
    ``--smoke``) on a fresh random 1-5 s crop of ``gt16k``, as the trainer
    prepares each batch (``train/loop.py``)."""
    from cse_tpu_torch.data.pipeline import crop_enrollment, draw_enrollment
    from cse_tpu_torch.models.ecapa import EcapaEncoder, EcapaTDNN

    ecapa = EcapaEncoder(module=EcapaTDNN(channels=64 if args.smoke else 1024,
                                          generator=torch.Generator().manual_seed(0)), device=dev)
    lengths = torch.full((gt16k.shape[0],), gt16k.shape[1], dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)

    def with_se(batch):
        return dict(batch, se=ecapa(*crop_enrollment(gt16k, lengths, *draw_enrollment(gt16k.shape[0], gen))))

    return with_se


def _llm_setup(args, cfg, B, dev, mesh=None) -> dict:
    """The frozen Llama of ``--with_llm``: random weights on ``dev`` (the 8B
    shape; ``--smoke``: 2 tiny layers; sharded over ``mesh``'s model axis),
    its ``apply`` (the last hidden state, fp32, as the ContSep recipe reads
    it) and the steps' (ids, mask) for ``B`` rows: one full ``--ctx_tokens``
    batch (``full``), or with ``--ctx_sim`` one batch a timed step at
    simulated dialog-history lengths."""
    from cse_tpu_torch.models.llama import LlamaConfig, llama_forward, random_llama_params

    if args.smoke:
        lcfg = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2)
    else:
        lcfg = LlamaConfig()
    if lcfg.hidden_size != cfg.llm_dim:
        raise ValueError(f"the Llama's width {lcfg.hidden_size} is not the model's llm_dim {cfg.llm_dim}")
    params = random_llama_params(lcfg, dtype=torch.bfloat16, seed=0, quant=args.llama_quant, with_lm_head=False,
                                 device=dev, mesh=mesh)

    def apply(lp, ids, mask):
        return llama_forward(lp, ids, mask, lcfg, mesh=mesh)[:, -1:].float()

    rng = np.random.default_rng(0)
    full = (torch.from_numpy(rng.integers(0, lcfg.vocab_size, (B, args.ctx_tokens)).astype(np.int32)).to(dev),
            torch.ones(B, args.ctx_tokens, dtype=torch.int32, device=dev))
    contexts, note = [full], ""
    if args.ctx_sim:
        # the root bench's draws (bench.py:323-345): per row 1-15 turns of ~19 tokens with the
        # "Speaker i: " prefix, each batch left-padded to the smallest bucket that fits
        buckets = sorted(int(b) for b in args.ctx_sim_buckets.split())
        simrng = np.random.default_rng(3)
        contexts = []
        for _ in range(args.steps):
            lens = []
            for _ in range(B):
                turns = int(simrng.integers(1, 16))
                per_turn = simrng.normal(19.0, 4.0, turns).clip(6)
                lens.append(int(min(1 + per_turn.sum(), args.ctx_tokens)))
            W = next((b for b in buckets if b >= max(lens)), args.ctx_tokens)
            ids = np.zeros((B, W), np.int32)
            mask = np.zeros((B, W), np.int32)
            for r, n in enumerate(lens):
                ids[r, W - n:] = simrng.integers(1, lcfg.vocab_size, n)
                mask[r, W - n:] = 1
            contexts.append((torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)))
        widths = [c[0].shape[1] for c in contexts]
        note = ", ctx-sim buckets " + "/".join(f"{w}x{widths.count(w)}" for w in sorted(set(widths)))
    return {"params": params, "apply": apply, "full": full, "contexts": contexts, "note": note,
            "widths": sorted({c[0].shape[1] for c in contexts}) if args.ctx_sim else []}


def _llm_decomposition(args, llm, step_s: float) -> str:
    """Time the bare prefill alone on the step's weights at ``--ctx_tokens``
    (standard error: a decomposition, not the result); return the unit's note."""
    ids, mask = llm["full"]
    out = llm["apply"](llm["params"], ids, mask)
    float(out.sum())
    t0 = time.perf_counter()
    for _ in range(args.steps):
        out = llm["apply"](llm["params"], ids, mask)
    float(out.sum())
    prefill_s = (time.perf_counter() - t0) / args.steps
    size = "tiny-smoke" if args.smoke else "8B"
    print("bench decomposition: bare %s %s prefill %.1f ms/step @ %d tokens (integrated step %.1f ms)"
          % (args.llama_quant, size, prefill_s * 1e3, ids.shape[1], step_s / args.steps * 1e3),
          file=sys.stderr, flush=True)
    if args.smoke:
        return ", tiny-smoke llm in-step" + llm["note"]
    return ", %s 8B prefill IN-STEP @ %d tokens%s" % (args.llama_quant, args.ctx_tokens, llm["note"])


def _bench_infer(args, cfg, model, B, T, dev) -> dict:
    """The realtime factor of the fused serving engine. ``--variant``
    composes: contsep serves 2 decoded streams + the selector head; hcontext
    adds the speaker-embedding cue fusion (fixed cue 0, like the eval CLIs'
    ``--cue``)."""
    from cse_tpu_torch.serving import ServingEngine

    rng = np.random.default_rng(0)
    mix = torch.from_numpy(rng.standard_normal((B, T)).astype(np.float32)).to(dev)
    ctx = torch.from_numpy(rng.standard_normal((B, 1, cfg.llm_dim)).astype(np.float32)).to(dev)
    call_kw = {}
    if cfg.add_se:
        se = torch.from_numpy(rng.standard_normal((B, 1, cfg.se_dim)).astype(np.float32)).to(dev)
        call_kw = dict(se=se, cue_index=0)
    engine = ServingEngine(cfg, model, device=dev, quant=args.serving_quant)

    def run():
        out = engine(mix, ctx, **call_kw)
        est = out[0] if isinstance(out, tuple) else out  # contsep: (est, logits)
        return float(est.float().sum())

    _reset_launches()
    run()
    t0 = time.perf_counter()
    for _ in range(args.steps - 1):
        engine(mix, ctx, **call_kw)
    run()
    dt = (time.perf_counter() - t0) / args.steps
    _report_launches(args.steps + 1)
    rtf = (B * T / args.sr) / dt
    qnote = ", %s stacks" % args.serving_quant if args.serving_quant else ""
    return {
        "metric": _metric_name(args),
        "value": rtf,
        "unit": "x realtime (fused serving, batch %d, %.3fs@8kHz, %s%s; %s)"
                % (B, T / args.sr, _dtype_name(cfg), qnote, _where(dev)),
        "vs_baseline": None,
    }


def _bench_cascaded(args, dev) -> dict:
    """The cascaded pipeline's realtime factor (the root bench's
    ``_bench_cascaded``): one warm mixture, then ``--steps`` timed ones on
    the host clock, each ending in the selection's host reads."""
    from cse_tpu_torch.data.tokenizer import ByteTokenizer
    from cse_tpu_torch.eval.cascaded import CascadedSelector
    from cse_tpu_torch.models.llama import LlamaConfig, llama_forward, random_llama_params
    from cse_tpu_torch.models.whisper import WhisperASR, WhisperConfig
    from cse_tpu_torch.serving import ServingEngine

    rng = np.random.default_rng(0)
    if args.smoke:
        scfg = SepformerConfig(variant="base", num_spks=2, enc_channels=16, enc_kernel=8, enc_stride=4, d_model=16,
                               nhead=4, d_ffn=32, num_tf_layers=1, num_dp_layers=1, chunk_size=10, pe_max_len=256)
        wcfg = WhisperConfig(n_audio_state=64, n_audio_head=4, n_audio_layer=2, n_text_state=64, n_text_head=4,
                             n_text_layer=2)
        lcfg = LlamaConfig(vocab_size=320, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2)
        T, max_tokens = 2000, 16  # 0.25 s: the inter sequence stays inside pe_max_len
    else:
        scfg = SepformerConfig(variant="base", num_spks=2, compute_dtype=torch.bfloat16)
        wcfg, lcfg = WhisperConfig(), LlamaConfig()  # Whisper-base, the 8B shape
        T, max_tokens = int(args.seconds * args.sr), 224
    engine = ServingEngine(scfg, Sepformer(scfg, generator=torch.Generator().manual_seed(0)), device=dev)
    mix = torch.from_numpy(rng.standard_normal((1, T)).astype(np.float32)).to(dev)
    asr = WhisperASR(cfg=wcfg, temperatures=(0.0,), language="en", device=dev)
    scorer = None
    if args.cascaded_llm:
        lparams = random_llama_params(lcfg, dtype=torch.bfloat16, seed=0, quant="int8", device=dev)

        def scorer(ids, mask):
            return llama_forward(lparams, ids, mask, lcfg, return_logits=True)

    sel = CascadedSelector(asr, scorer, ByteTokenizer(), sr=args.sr, asr_max_tokens=max_tokens)
    context = "Speaker 0: could you pass the salt please/nSpeaker 1: "

    def one_mixture():
        streams = engine(mix).float()[0].t()  # [spk, T]
        return sel.select(streams, context)

    _reset_launches()
    one_mixture()  # first use of every stage
    t0 = time.perf_counter()
    for _ in range(args.steps):
        one_mixture()
    dt = (time.perf_counter() - t0) / args.steps
    _report_launches(1 + args.steps)
    lm = ("tiny-smoke-int8" if args.smoke else "8B-int8") if args.cascaded_llm else "host-stub"
    prec = "" if dev.type != "cuda" else ", PyTorch's default precision settings"
    return {
        "metric": _metric_name(args),
        "value": (T / args.sr) / dt,
        "unit": "x realtime (cascaded separate+ASR+select, batch 1, %.2fs@8kHz, %d-token ASR budget, LM=%s; "
                "worst-case: random weights decode the full budget%s; %s)"
                % (T / args.sr, max_tokens, lm, prec, _where(dev)),
        "vs_baseline": None,
    }


def _reset_launches():
    from cse_tpu_torch.ops import attention, fused_stack_w8a8, fused_train

    fused_train.reset_launches()  # and fused_stack's
    fused_stack_w8a8.reset_launches()
    attention.reset_launches()


def _report_launches(calls: int):
    """Every kernel wrapper's launches since :func:`_reset_launches`, as one
    JSON line on standard error (standard output holds the result alone)."""
    from cse_tpu_torch.ops import attention, fused_stack_w8a8, fused_train

    counts = {**fused_train.launch_counts(), **fused_stack_w8a8.launch_counts(), **attention.launch_counts()}
    if process_index() != 0:
        return
    print(json.dumps({"launches": {k: v for k, v in counts.items() if v}, "calls": calls}),
          file=sys.stderr, flush=True)


def _where(dev) -> str:
    """The card's name; a CPU run says it measures plumbing, not a device."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU smoke: plumbing only, no device time"


if __name__ == "__main__":
    main()
