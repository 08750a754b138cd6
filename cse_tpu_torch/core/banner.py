"""Startup real-vs-stub asset banner, shared by every CLI entrypoint.

The framework deliberately stays runnable without the released external
assets (Llama-3, ECAPA, Whisper, the HF tokenizer) by swapping in
deterministic stand-ins — but a mistyped ``--llama_path``/``--ecapa_path``
must never SILENTLY train on stubs. Every entrypoint therefore prints one
line naming each external net as real or stub, and training refuses to
proceed on stubs unless ``--synthetic_smoke`` or ``--allow_stub_nets`` is
set. The reference has no stub concept
— it hard-requires its assets (e.g. ``train_ContSep.py:163-165``) — so the
refusal restores the reference's fail-loudly behavior.
"""

from __future__ import annotations


def asset_status(
    tokenizer=None,
    llm=None,
    ecapa_path: str | None = "__unused__",
    whisper=None,
) -> tuple[str, list[str]]:
    """One-line status string + the list of nets that are stubs.

    Pass only the nets the entrypoint actually uses; omitted ones are left
    out of the line. ``ecapa_path`` is the CLI flag value (the spectral
    stand-in is selected exactly when it is empty,
    ``models/speaker_encoder.py::build_speaker_encoder``).
    """
    parts: list[str] = []
    stubs: list[str] = []

    def add(name: str, real: bool) -> None:
        parts.append(f"{name}={'real' if real else 'STUB'}")
        if not real:
            stubs.append(name)

    if tokenizer is not None:
        add("tokenizer", not getattr(tokenizer, "is_fallback", False))
    if llm is not None:
        add("llm", not getattr(llm, "is_stub", False))
    if ecapa_path != "__unused__":
        add("ecapa", bool(ecapa_path))
    if whisper is not None:
        add("whisper", not getattr(whisper, "is_stub", False))
    return ", ".join(parts), stubs


def announce_assets(mode: str, args, **nets) -> None:
    """Print the banner; in train mode, refuse stubs without an override."""
    line, stubs = asset_status(**nets)
    print(f"[cse_tpu_torch] external nets: {line}")
    if mode == "train" and stubs:
        allowed = getattr(args, "synthetic_smoke", False) or getattr(
            args, "allow_stub_nets", False
        )
        if not allowed:
            raise SystemExit(
                f"[cse_tpu_torch] refusing to TRAIN with stub nets ({', '.join(stubs)}): "
                "a run conditioned on stand-ins is not comparable to the "
                "reference and cannot consume/produce released checkpoints. "
                "Fix the asset paths (--llama_path/--ecapa_path), or pass "
                "--synthetic_smoke / --allow_stub_nets to proceed knowingly."
            )
