"""Tiny cells for the harness's CPU tests, added the way a later PR adds a
cell: new files (configuration, mix, limits) and new entries in a copy of
``BENCHMARK.json``, in a temporary copy of the benchmark. No file of
``perfbench/`` is edited."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from perfbench import core

REPO = core.ROOT
TINY = {"enc_channels": 16, "enc_kernel": 8, "enc_stride": 4, "d_model": 32, "nhead": 4, "d_ffn": 64,
        "num_tf_layers": 2, "num_dp_layers": 1, "chunk_size": 10, "llm_dim": 64}
TRAIN = {"batch": 4, "samples": 2000, "pool": 4, "profile_steps": 2}
SERVE = {"batch": 2, "samples": [1600, 2000, 2400], "requests": [1, 2, 1], "pool": 2, "sample": 2,
         "profile_requests": 3}
# the tiny cells' limits, set between CPU readings (bf16 products, two threads) on the seeds SEEDS:
# sound runs read at most loss 0.0181 dB, gradient (median leaf) 0.0107, change 0.0065, streams
# 0.0162, logits 0.0108; on each seed the control (fp8 reference for training and bf16 serving, int4
# reference for w8a8) reads above at least one limit (loss 0.0119-0.985 dB, gradient 0.0038-0.051,
# change 0.0061-0.0245, streams >= 0.0754, logits >= 0.0929)
SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)
TINY_LIMITS = {"train": {"loss_gap_db": 0.03, "grad_gap": 0.02, "update_gap": 0.0075},
               "serve": {"stream_rel_l2": 0.04}, "serve_sel": {"stream_rel_l2": 0.05, "logit_gap": 0.04}}


def make_root(tmp: Path, precision: str = "bf16") -> Path:
    """A copy of the benchmark with tiny cells beside the real ones: ContExt
    (``tiny2``) and 3-speaker ContSep (``tiny3``) at tiny widths, ``*.train``
    (``tiny2.train_dp2`` on two ranks, with ``allreduce_ms.train``), ``*.serve``
    and ``tiny3.serve_w8a8``,
    their products in ``precision``."""
    root = tmp / "checkout"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    pb = root / "perfbench"
    for name, base in (("tiny2", "context2"), ("tiny3", "contsep3")):
        cfg = dict(json.loads((pb / "configs" / f"{base}.json").read_text()), **TINY, name=name, precision=precision,
                   reduced=sorted(TINY))
        (pb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "https://arxiv.org/abs/2503.08798",
                                 "file": f"perfbench/configs/{name}.json", "reduced": sorted(TINY), "why": "CPU tests"})
    mixes = {"tiny_train": dict(json.loads((pb / "traffic" / "train_fused.json").read_text()), **TRAIN),
             "tiny_train_dp2": dict(json.loads((pb / "traffic" / "train_fused.json").read_text()),
                                    **dict(TRAIN, batch=2, ranks=2)),
             "tiny_serve": dict(json.loads((pb / "traffic" / "serve_w8a8.json").read_text()), **SERVE, quant=None),
             "tiny_serve_w8a8": dict(json.loads((pb / "traffic" / "serve_w8a8.json").read_text()), **SERVE)}
    for name, mix in mixes.items():
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    cells = {"tiny2.train": ("tiny2", "tiny_train", "train", 1), "tiny2.train_dp2": ("tiny2", "tiny_train_dp2", "train", 2),
             "tiny3.train": ("tiny3", "tiny_train", "train", 1), "tiny2.serve": ("tiny2", "tiny_serve", "serve", 1),
             "tiny3.serve": ("tiny3", "tiny_serve", "serve_sel", 1),
             "tiny3.serve_w8a8": ("tiny3", "tiny_serve_w8a8", "serve_sel", 1)}
    for cell, (cfg, mix, lim, chips) in cells.items():
        bench["workloads"].append({"name": cell, "config": cfg, "traffic": mix, "chips": chips, "why": "CPU tests"})
        control = "reference:int4" if "w8a8" in cell else "reference:fp8"
        (pb / "limits" / f"{cell}.json").write_text(json.dumps({"limits": TINY_LIMITS[lim], "control": control}))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = "train" if any("train" in w for w in m["workloads"]) else "serve"
            m["workloads"] += [c for c in cells if (kind == "train") == ("train" in c)]
    bench["per_layer"].append({"name": "allreduce_ms.train", "unit": "ms", "better": "lower", "source": "device_trace",
                               "layer": "reduction", "moves": "train_mixtures_per_s", "workloads": ["tiny2.train_dp2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_tiny(root: Path, cell: str, seed: int = SEEDS[0], trace: bool = False, fault=None, seconds: float = 0.5,
             rank: int = 0, world: int = 1):
    """One run of a tiny cell on the CPU through the harness (the look for a
    card is the CLI's; this drives the rest of a run)."""
    from perfbench import run

    torch.manual_seed(0)
    ctx = run.Context(core.load_cell(cell, root), seed, seconds, trace, torch.device("cpu"), rank, world, fault)
    return run.execute(ctx)
