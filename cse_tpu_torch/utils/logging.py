"""Observability: metric logging (stdout + TensorBoard + optional wandb).

Mirrors the reference's logging surface (``train_ContSep.py:289-325,437-456``):
per-step scalars (loss / snr_loss / ctx_loss / SI-SNR / ctx_acc / lr), val
scalars, rank-0-only writes. TensorBoard comes via torch's bundled writer;
wandb is used only when installed AND ``--project`` is set (both optional in
this image).
"""

from __future__ import annotations

import os
import time


class MetricLogger:
    def __init__(self, checkpoint_dir: str, project: str | None = None,
                 enabled: bool = True, config: dict | None = None):
        self.enabled = enabled
        self.tb = None
        self.wandb = None
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(
                comment=os.path.split(checkpoint_dir or ".")[-1]
            )
        except Exception:
            self.tb = None
        if project:
            try:
                import wandb

                # resume the previous run id by globbing the wandb dir
                # (reference train_ContSep.py:292-297,732-738)
                run_id = _resumed_wandb_id(checkpoint_dir)
                self.wandb = wandb.init(
                    project="CSE", name=project, dir=checkpoint_dir,
                    config=config or {},
                    **({"id": run_id, "resume": "allow"} if run_id else {}),
                )
            except Exception:
                self.wandb = None

    def scalar(self, tag: str, value: float, step: int):
        if not self.enabled:
            return
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)
        if self.wandb is not None:
            self.wandb.log({tag: value}, step=step)

    def scalars(self, values: dict, step: int, prefix: str = ""):
        for k, v in values.items():
            try:
                self.scalar(prefix + k, float(v), step)
            except (TypeError, ValueError):
                pass

    def audio(self, tag: str, wav, sr: int, step: int, caption: str = ""):
        """wandb.Audio artifact for generated speech (reference
        train_ContSep.py:540-552,706-710). No-op without wandb."""
        if not self.enabled or self.wandb is None:
            return
        try:
            import wandb

            self.wandb.log({tag: wandb.Audio(wav, sample_rate=sr,
                                             caption=caption)}, step=step)
        except Exception:
            pass

    def close(self):
        if self.tb is not None:
            self.tb.flush()


def _resumed_wandb_id(checkpoint_dir: str) -> str | None:
    """Parse the run id out of ``wandb/latest-run/run-*.wandb``."""
    import glob

    hits = glob.glob(
        os.path.join(checkpoint_dir or ".", "wandb", "latest-run", "run-*.wandb")
    )
    if not hits:
        return None
    base = os.path.basename(hits[0])
    return base[len("run-"):-len(".wandb")] or None


class IterTimer:
    """Wall-clock per-iteration timing (the reference's only perf telemetry,
    ``train_ContSep.py:369-373``)."""

    def __init__(self, every: int = 100):
        self.every = every
        self.prev = time.time()

    def lap(self) -> float:
        now = time.time()
        dt = (now - self.prev) / max(self.every, 1)
        self.prev = now
        return dt
