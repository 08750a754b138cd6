"""Plumbing the trainer and eval entry points share: the corpus paths and the
device from the parsed flags, the ``--synthetic_smoke`` corpus and the
``--debug_tiny_model`` widths.

Imports nothing heavy at module level: ``cse_tpu_torch.test`` is the
``__main__`` its spawned metric workers import, and they load no torch.
"""

from __future__ import annotations

TAG = "[cse_tpu_torch]"

# --debug_tiny_model's widths (the trainer's and the eval entry point's)
TINY_MODEL = dict(
    enc_channels=32, enc_kernel=8, enc_stride=4, d_model=32, nhead=4,
    d_ffn=64, num_tf_layers=2, num_dp_layers=1, chunk_size=50,
    # stride 4 at 16 s/8 kHz gives ~1300 inter-chunk positions;
    # cover them (the full-size model's 2500 covers its own worst case)
    pe_max_len=2048,
)


def corpus_paths(args):
    """The ``CorpusPaths`` the flags name."""
    from cse_tpu_torch.data import datasets as ds

    return ds.CorpusPaths(
        dailytalk=args.dailytalk_data_path,
        spokenwoz=args.spokenwoz_data_path,
        tedlium=args.tedlium_data_path,
        demand=args.acoustic_noise_path,
        lists_root=getattr(args, "lists_root", "./data"),
    )


def device_of(args):
    """``--platform``'s device: the card when it is absent (raising without one)."""
    from cse_tpu_torch.core.device import resolve_device

    platform = getattr(args, "platform", None)
    return resolve_device({None: None, "gpu": "cuda"}.get(platform, platform))


def setup_synthetic(args):
    """--synthetic_smoke: build a tiny corpus and retarget the flags at it."""
    import tempfile

    from cse_tpu_torch.data.synthetic import make_synthetic_corpus

    assert args.train_data in ("dailytalk", "spokenwoz", "tedlium"), (
        f"--train_data {args.train_data!r}: unknown corpus"
    )
    root = tempfile.mkdtemp(prefix="cse_synth_")
    info = make_synthetic_corpus(
        root, num_test_mix=args.num_test_mix, corpus=args.train_data,
        n_dialogs=getattr(args, "synthetic_dialogs", 4),
        turns_per_dialog=getattr(args, "synthetic_turns", 8),
        n_eval=getattr(args, "synthetic_eval", 6),
        seconds=tuple(getattr(args, "synthetic_seconds", (1.0, 3.0))),
    )
    corpus = args.train_data
    setattr(args, f"{corpus}_data_path", info[f"{corpus}_data_path"])
    args.acoustic_noise_path = info["acoustic_noise_path"]
    args.lists_root = info["lists_root"]
    args.llama_path = "__none__"  # force the stub encoder
    print(f"{TAG} synthetic corpus at {root}")
    return args
