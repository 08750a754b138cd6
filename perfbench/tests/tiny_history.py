"""A tiny ``serve_history`` cell for the CPU tests, added the way a later PR
adds a cell: beside ``tiny.py``'s cells in a temporary copy of the
benchmark, new files alone (a configuration, a mix, limits, a short mixture
list in TED-LIUM's naming and a copy of the transcripts it reads).

``tiny3ds`` is ``tiny3``'s separator (``llm_dim`` 64) with a 3-layer
DeepSeek-V2 encoder at hidden 64: 4 heads, latent 32, rope 16, nope 32,
v 32, 8 experts, top-2, 1 shared, the first layer dense, DeepSeek-V2-Lite's
YaRN, weights drawn at the std that gives each layer the gain 0.02 gives at
hidden 2048. Its histories run 3 to 24 tokens (``tokens_per_word`` 1 on starts of
1 to 15 s), padded to 8, 16 or 24."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench.tests.tiny import REPO, SERVE, make_root

ENCODER = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128, "moe_intermediate_size": 32,
           "num_hidden_layers": 3, "num_attention_heads": 4, "num_key_value_heads": 4, "n_routed_experts": 8,
           "n_shared_experts": 1, "num_experts_per_tok": 2, "first_k_dense_replace": 1, "kv_lora_rank": 32,
           "qk_nope_head_dim": 32, "qk_rope_head_dim": 16, "v_head_dim": 32,
           "initializer_range": 0.113}  # 0.02 x sqrt(2048 / 64): the published width's gain a layer
HISTORY = {"history_cap": 24, "widths": [8, 16, 24], "tokens_per_word": 1.0, "grid_s": 0.05,
           "lengths_from": "data/tiny_mix.txt", "profile_requests": 2}
# (start of the target in its talk, centiseconds; length of the longest utterance, centiseconds)
LINES = [(100, 20), (700, 18), (250, 25), (1500, 22), (400, 24), (1200, 25), (550, 30), (300, 28)]
# limits between CPU readings (bf16 products, two threads) on tiny.SEEDS: sound runs read ctx 0.0107,
# 0.0168, 0.0168, streams <= 0.0159, logits <= 0.0135; the fp8-expert control reads ctx 0.0198,
# 0.0246, 0.0222 (the limit is their geometric middle: at 3 layers bf16's own gap is most of fp8's);
# the faults of test_perfbench_history read ctx >= 0.083. Streams and logits take tiny3.serve_w8a8's
# limits (tiny.py): the same separator, whose int4 control reads streams >= 0.0754, logits >= 0.0929
TINY_LIMITS = {"ctx_rel_l2": 0.0183, "stream_rel_l2": 0.05, "logit_gap": 0.04}


def make_history_root(tmp: Path) -> Path:
    root = make_root(tmp)
    pb = root / "perfbench"
    tiny3 = json.loads((pb / "configs" / "tiny3.json").read_text())
    full = json.loads((REPO / "perfbench" / "configs" / "contsep3_dsv2lite.json").read_text())
    cfg = {**full, **tiny3, **ENCODER, "name": "tiny3ds", "reduced": sorted(set(tiny3["reduced"]) | set(ENCODER))}
    (pb / "configs" / "tiny3ds.json").write_text(json.dumps(cfg))
    mix = {**json.loads((pb / "traffic" / "serve_history.json").read_text()), **SERVE, **HISTORY}
    (pb / "traffic" / "tiny_serve_history.json").write_text(json.dumps(mix))
    (root / "data").mkdir()
    shutil.copytree(REPO / "data" / "TEDLIUM" / "test.orig", root / "data" / "TEDLIUM" / "test.orig")
    (root / "data" / "tiny_mix.txt").write_text("".join(
        f"/Talk{i}/Talk{i}-{s:07d}-{s + n:07d}.wav /O/O-0000000-0000010.wav /P/P-0000000-0000010.wav 0.1 0.2\n"
        for i, (s, n) in enumerate(LINES)))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny3ds", "source": "https://arxiv.org/abs/2503.08798",
                             "file": "perfbench/configs/tiny3ds.json", "reduced": sorted(ENCODER), "why": "CPU tests"})
    cell = "tiny3ds.serve_history"
    bench["workloads"].append({"name": cell, "config": "tiny3ds", "traffic": "tiny_serve_history", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "contsep3_dsv2lite.serve_history" in m.get("workloads", []):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (pb / "limits" / f"{cell}.json").write_text(json.dumps({"limits": TINY_LIMITS, "control": "reference:fp8_experts"}))
    return root
