"""Shared CLI flag definitions with reference parity.

One flag module replaces the ~45 argparse flags duplicated across the six
reference entry scripts (``train_ContSep.py:33-102`` etc.). Flag names and
defaults match the reference so run recipes port verbatim; the extensions of ``cse_tpu`` are
grouped at the bottom (and are all optional). This is the port's copy of
``cse_tpu/core/flags.py``: the same flags, so the JAX package's run recipes
carry over; ``--platform cpu`` selects the CPU, no ``--platform`` the card.
"""

from __future__ import annotations

import argparse


def str2bool(v) -> bool:
    """Real boolean parsing for flags like ``--ce False``.

    The reference declares ``--ce`` as ``default=True`` with no type
    (``train_ContSep.py:57``), so ``--ce False`` silently yields the truthy
    string ``"False"`` — a footgun we fix while keeping the flag name/default.
    """
    if isinstance(v, bool):
        return v
    if str(v).lower() in ("true", "1", "yes", "y", "t"):
        return True
    if str(v).lower() in ("false", "0", "no", "n", "f"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def add_data_flags(p: argparse.ArgumentParser):
    p.add_argument("--dailytalk_data_path", default="dir_to/DailyTalk_processed")
    p.add_argument("--spokenwoz_data_path", default="dir_to/SpokenWoz_processed")
    p.add_argument("--tedlium_data_path", default="dir_to/TEDLIUM_processed")
    p.add_argument("--acoustic_noise_path", default="dir_to/DEMAND")
    p.add_argument("--llama_path", default="meta-llama/Meta-Llama-3-8B")
    p.add_argument("--llama_auth_token", default="")
    p.add_argument("--ecapa_path", default="",
                   help="released speechbrain ECAPA embedding_model.ckpt (H-ContExt's "
                        "enrollment cue; empty: the spectral stand-in)")
    p.add_argument("--max_sp_len", type=int, default=16, help="max length in sec")
    p.add_argument("--sr", type=int, default=8000)
    p.add_argument("--context_length", type=int, default=0,
                   help="eval dialog turns; 0=full history, -1=none")
    p.add_argument("--ctx_length", type=int, default=1,
                   help="how many LLM output positions are consumed")
    p.add_argument("--num_max_mix", type=int, default=2)
    p.add_argument("--num_test_mix", type=int, default=2)
    p.add_argument("--augmentation", default=False, action="store_true")
    p.add_argument("--speed_perturb_ratio", type=str, default="0.9 1.0 1.1")
    p.add_argument("--shift_prob", type=float, default=0.4)
    p.add_argument("--max_shift_sec", type=float, default=0.5)
    p.add_argument("--max_context_train", type=int, default=100)
    p.add_argument("--noise_add", default=False, action="store_true")
    p.add_argument("--train_data", type=str, default="spokenwoz",
                   help="dailytalk or spokenwoz or tedlium")
    p.add_argument("--lists_root", type=str, default="./data",
                   help="root of the static split/mixture list files")


def add_train_flags(p: argparse.ArgumentParser):
    p.add_argument("--ctx_weight", type=float, default=1)
    p.add_argument("--ce", type=str2bool, default=True)
    p.add_argument("--from_ckpt", default=False, action="store_true")
    p.add_argument("--temp_dir", type=str, default="")
    p.add_argument("--checkpoint_dir", type=str, default="./data/checkpoints/Sepformer")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--resume", default=False, action="store_true")
    p.add_argument("--project", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--update_frequency", type=int, default=1)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--tot_iters", type=int, default=500000)
    p.add_argument("--lr", type=float, default=0.0001)
    p.add_argument("--warmup", default=False, action="store_true")
    p.add_argument("--warmup_iteration", type=int, default=10000)
    p.add_argument("--plateau", default=False, action="store_true")
    p.add_argument("--no_reduce", type=int, default=100000)
    p.add_argument("--weight_decay", type=float, default=0.000001)
    p.add_argument("--workers", type=int, default=9)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--eval_step", type=int, default=5000)
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--start_step", type=int, default=0)
    p.add_argument("--mode", type=str, default="train")
    p.add_argument("--reset_optimizer", default=False, action="store_true",
                   help="with --from_ckpt: keep step/epoch but re-init optimizer moments")
    p.add_argument("--fp16", default=False, action="store_true")
    p.add_argument("--bf16", default=False, action="store_true")
    p.add_argument("--generate_speech", default=False, action="store_true")
    p.add_argument("--generate_step", type=int, default=1000)
    p.add_argument("--num_gen_speech", type=int, default=20)
    p.add_argument("--distributed", default=False, action="store_true")
    p.add_argument("--torchrun", default=False, action="store_true")
    p.add_argument("--masterport", type=str, default="1234")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--gpu", type=str, default="0")


def add_test_flags(p: argparse.ArgumentParser):
    p.add_argument("--test_model", type=str, default="ContExt")
    p.add_argument("--test_dataset", type=str, default="dailytalk")
    p.add_argument("--save_dir", type=str, default="./data/test_results")
    p.add_argument("--cue", type=str, default="joint",
                   help="joint | history | voice (H-ContExt ablation)")
    p.add_argument("--one_sec", default=False, action="store_true")
    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--whisper_path", type=str, default=None,
                   help="local OpenAI whisper base.pt (cascaded pipeline)")
    p.add_argument("--fused_eval", "--fused", dest="fused_eval",
                   default=False, action="store_true",
                   help="evaluate through the fused-kernel serving path "
                        "(fp32-parity-tested against the plain model)")
    p.add_argument("--asr_temperature", type=str, default=None,
                   help="comma list of whisper decode temperatures "
                        "(whisper.transcribe's `temperature` option; default "
                        "the full 0,0.2,..,1.0 fallback ladder; '0' pins "
                        "greedy-only, used by smoke tests)")
    p.add_argument("--asr_best_of", type=int, default=None,
                   help="whisper.transcribe's `best_of` option: sampled "
                        "candidates per t>0 fallback rung. Default 1 — the "
                        "PROGRAMMATIC default an option-free transcribe() "
                        "call resolves to (n_group = beam_size or best_of "
                        "or 1), which is what the reference runs; the "
                        "whisper CLI's 5 is available by passing 5")
    p.add_argument("--metric_workers", type=int, default=None,
                   help="worker processes for host eval metrics (PESQ/SDR); "
                        "default min(cpu_count, 8). 0 = synchronous in-process")
    p.add_argument("--no_prev_cache", dest="prev_cache", default=True,
                   action="store_false",
                   help="disable the mixture-side (prev) metric cache "
                        "({save_dir}/prev_metrics_cache, keyed by the exact "
                        "eval row set)")


def add_tpu_flags(p: argparse.ArgumentParser):
    """cse_tpu's extensions (all optional; absent from the reference)."""
    p.add_argument("--synthetic_smoke", default=False, action="store_true",
                   help="build a tiny synthetic corpus and run end-to-end")
    p.add_argument("--synthetic_dialogs", type=int, default=4,
                   help="with --synthetic_smoke: dialogs in the generated "
                        "corpus (raise for sustained-throughput runs so the "
                        "host pipeline decodes fresh files every batch)")
    p.add_argument("--synthetic_turns", type=int, default=8,
                   help="with --synthetic_smoke: turns per dialog")
    p.add_argument("--synthetic_seconds", type=float, nargs=2,
                   default=(1.0, 3.0), metavar=("LO", "HI"),
                   help="with --synthetic_smoke: utterance length range (s); "
                        "use realistic lengths (e.g. 3 13) when measuring "
                        "host-pipeline cost")
    p.add_argument("--mesh_data", type=int, default=None,
                   help="data-parallel mesh size (the world size: one process per rank)")
    p.add_argument("--remat", type=str, default="layer",
                   choices=["none", "block", "layer", "nested"])
    p.add_argument("--flash_attention", default=False, action="store_true")
    p.add_argument("--fused_train", default=None, action="store_true",
                   help="force the fused forward and backward transformer "
                        "stacks (hand-written CUDA kernels; the DEFAULT on "
                        "the card)")
    p.add_argument("--no_fused_train", dest="fused_train", action="store_false",
                   help="force the layer-by-layer train path (the default on the CPU)")
    p.add_argument("--no_aligned_buckets", dest="aligned_buckets",
                   default=True, action="store_false",
                   help="disable aligned train buckets (exact reference cap)")
    p.add_argument("--max_ctx_tokens", type=int, default=512)
    p.add_argument("--ctx_buckets", type=str, default="128 256 384 512",
                   help="space-separated context-token buckets: each batch "
                        "tokenizes to the smallest bucket holding its longest "
                        "dialog history (capped at --max_ctx_tokens), so "
                        "short histories skip most of the frozen-LLM prefill "
                        "cost. 'none' pins every batch to "
                        "the fixed --max_ctx_tokens width")
    p.add_argument("--platform", type=str, default=None,
                   help="'cpu' runs on the CPU (local smoke); default: the card")
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--debug_tiny_model", default=False, action="store_true",
                   help="scaled-down model (fast CI/smoke; NOT ckpt-compatible)")
    p.add_argument("--allow_stub_nets", default=False, action="store_true",
                   help="permit TRAINING with stub external nets (hash LLM / "
                        "spectral speaker encoder / byte tokenizer); without "
                        "this (or --synthetic_smoke) training refuses stubs")
    p.add_argument("--llama_int8", default=False, action="store_true",
                   help="load the frozen Llama with int8 weight-only "
                        "quantization (bf16 products on the int8 payload; "
                        "<1e-2 hidden-state error, the encoder is frozen)")
    p.add_argument("--llama_w8a8", default=False, action="store_true",
                   help="like --llama_int8 but activations also quantize to "
                        "int8 per token: the prefill products run int8 x int8 "
                        "-> int32 (torch._int_mm); adds activation error, opt-in")


def parse_train_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    add_data_flags(p)
    add_train_flags(p)
    add_tpu_flags(p)
    args = p.parse_args(argv)
    args.speed_perturb_ratio = tuple(
        float(r) for r in args.speed_perturb_ratio.split()
    )
    args.ctx_buckets = _parse_ctx_buckets(args)
    return args


def _parse_ctx_buckets(args) -> tuple:
    raw = getattr(args, "ctx_buckets", "") or ""
    if isinstance(raw, tuple):
        return raw
    if raw.strip().lower() in ("none", ""):
        return ()
    buckets = tuple(sorted(int(b) for b in raw.split()))
    return tuple(b for b in buckets if b <= args.max_ctx_tokens) or ()


def parse_test_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    add_data_flags(p)
    add_train_flags(p)
    add_test_flags(p)
    add_tpu_flags(p)
    p.add_argument("--synthetic_eval", type=int, default=6,
                   help="with --synthetic_smoke: premixed mixtures in the "
                        "test set (and the val set); raise it to measure "
                        "eval throughput")
    p.set_defaults(mode="test", workers=5, max_shift_sec=1.0)
    args = p.parse_args(argv)
    args.speed_perturb_ratio = tuple(
        float(r) for r in args.speed_perturb_ratio.split()
    )
    args.ctx_buckets = _parse_ctx_buckets(args)
    return args
