"""The ``serve_history`` cell: its histories, its yardstick, its readers, and
the comparison that decides ``correct`` at tiny widths on the CPU (sound
runs pass; the fp8-expert control and each fault planted in the program's
encoder under the timed path fail)."""

from __future__ import annotations

import json
import statistics
import time

import pytest
import torch

from perfbench import calibrate, core, run
from perfbench.drivers import serve_history as SH
from perfbench.metrics import deepseek_v2_work as dw
from perfbench.tests.test_perfbench_isolation import _loaded
from perfbench.tests.tiny import SEEDS, run_tiny

CELL = "contsep3_dsv2lite.serve_history"
TINY_CELL = "tiny3ds.serve_history"
NEW_READERS = ["mfu.serve_history", "ctx_share.serve_history", "moe_roofline.serve_history",
               "mla_roofline.serve_history", "ctx_host_reads.serve_history"]


@pytest.fixture(scope="module")
def hroot(tmp_path_factory):
    from perfbench.tests.tiny_history import make_history_root

    return make_history_root(tmp_path_factory.mktemp("history"))


# ---------------------------------------------------------------- the histories


def test_talk_rate_and_history_lengths_from_ted_lium():
    """2.80 words a second (median over test.orig's 11 talks); the histories
    of the 3-speaker list capped at 2048 tokens: median 2022 uncapped, about
    half of them whole."""
    c = core.load_cell(CELL)
    tr = c.traffic
    assert SH.talk_rate(core.ROOT / tr["transcripts"]) == pytest.approx(2.8028, abs=1e-4)
    lines = SH.history_lines(tr, core.ROOT, c.config["sample_rate"])
    assert sorted(lines) == tr["samples"]
    every = [n for v in lines.values() for n in v]
    assert len(every) == 2582 and max(every) == 2048 and min(every) >= 40
    assert 0.45 < sum(n < 2048 for n in every) / len(every) < 0.55
    assert statistics.median(every) == 2022


def test_each_request_keeps_its_lengths_histories():
    c = core.load_cell(CELL)
    tr = c.traffic
    lines = SH.history_lines(tr, core.ROOT, c.config["sample_rate"])
    order = SH.S.request_order(tr["requests"], 1 << 16, tr["order_seed"])
    plan = SH.Plan(tr, lines, tr["samples"], order)
    seen = {}
    for i in range(sum(tr["requests"])):  # one block: every mixture of the list once
        T, lengths, width = plan.spec(i)
        assert T == tr["samples"][order[i]] and len(lengths) == tr["batch"]
        assert width == min(w for w in tr["widths"] if w >= max(lengths))
        assert set(lengths) <= set(lines[T])
        seen.setdefault(T, []).extend(lengths)
    for T, got in seen.items():
        assert sorted(got[:len(lines[T])]) == sorted(lines[T])


# ---------------------------------------------------------------- the yardstick


def test_encoder_work_against_a_hand_count():
    """One history of 2048 tokens at DeepSeek-V2-Lite's widths: per layer the
    MLA's four projections (2 n 13.76 M) and its causal pairs (2 P 16 x 320),
    26 MoE layers of 6 routed + 2 shared SwiGLUs of 1408 (2 n 8 x 8.65 M) and
    the fp32 router (2 n 2048 x 64), one dense layer (2 n 3 x 2048 x 10944)."""
    cfg = core.load_cell(CELL).config
    n = 2048
    proj = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    assert proj == 13_762_560
    attn = 2 * (n * (n + 1) / 2) * 16 * 320
    assert dw.mla_products(cfg, [n])["bf16"] == pytest.approx(2 * n * proj + attn)
    moe = dw.moe_products(cfg, [n])
    assert moe["bf16"] == pytest.approx(2 * n * 8 * 3 * 2048 * 1408) and moe["fp32"] == pytest.approx(2 * n * 2048 * 64)
    total = dw.encoder_products(cfg, [n] * 10)
    hand = 10 * (27 * (2 * n * proj + attn) + 26 * 2 * n * 8 * 3 * 2048 * 1408 + 2 * n * 3 * 2048 * 10944)
    assert total["bf16"] == pytest.approx(hand) and hand == pytest.approx(97.48e12, rel=1e-3)
    assert dw.moe_layers(cfg) == 26
    # a request's ten histories are bound by operations; one history by the 1.14 GB of expert weights
    ten = dw.moe_products(cfg, [n] * 10)
    assert dw.moe_bound_seconds(cfg, [n] * 10) == pytest.approx(ten["bf16"] / 989e12 + ten["fp32"] / 67e12)
    assert dw.moe_bytes(cfg, [n]) == pytest.approx(2 * 3 * 2048 * 1408 * 66 + 4 * 64 * 2048 + 4 * n * 2048)
    assert dw.moe_bound_seconds(cfg, [n]) == pytest.approx(dw.moe_bytes(cfg, [n]) / 3.35e12)


def _record(cfg, spans=True):
    rec = {"kind": "serve", "config": cfg, "batch": 10, "quant": "w8a8",
           "profile": [{"busy_s": 0.9, "window_s": 1.0}],
           "sub_window": {"samples": [64000, 80000], "histories": [[2000] * 10, [1000] * 10], "elapsed_s": 1.0},
           "stack": {"quant": "w8a8", "train": False, "calls": [{"G": 2016, "L": 251, "ms": 500.0}]}}
    if spans:
        rec["spans"] = {"cse/ctx.mla[B=10,T=2048]": {"count": 27, "host_s": 0.1, "device_s": 0.3, "idle_s": 0.0},
                        "cse/ctx.mla[B=10,T=1024]": {"count": 27, "host_s": 0.1, "device_s": 0.1, "idle_s": 0.0},
                        "cse/ctx.moe.route[B=10,T=2048]": {"count": 26, "host_s": 0.0, "device_s": 0.01, "idle_s": 0},
                        "cse/ctx.moe.experts[B=10,T=2048]": {"count": 26, "host_s": 0.0, "device_s": 0.2, "idle_s": 0},
                        "cse/ctx.moe.shared[B=10,T=2048]": {"count": 26, "host_s": 0.0, "device_s": 0.05, "idle_s": 0},
                        "cse/ctx.encode": {"count": 2, "host_s": 0.4, "device_s": 0.04, "idle_s": 0.0},
                        "cse/model.stack.intra[G=1260,L=251]": {"count": 2, "host_s": 0.1, "device_s": 0.1,
                                                                "idle_s": 0.0},
                        "(outside)": {"count": 0, "host_s": 0.0, "device_s": 0.1, "idle_s": 0.1}}
        rec["encoder"] = {"submitted": [[2048, [2000] * 10], [1024, [1000] * 10]],
                          "counters": {"tokens_real": 10, "tokens_padded": 2},
                          "host_reads": {"reads": 0, "occurrences": 2}}
    return rec


def test_new_readers_on_a_made_up_record_and_none_without_their_rows():
    cell = core.load_cell(CELL)
    assert {m["name"] for m in cell.per_layer} == set(NEW_READERS) | {"idle_share.serve"}
    got = core.read_per_layer(cell, _record(cell.config))
    assert set(got) == set(NEW_READERS) | {"idle_share.serve"}
    assert got["ctx_share.serve_history"]["value"] == pytest.approx(100 * 0.7 / 0.9)
    assert got["ctx_host_reads.serve_history"]["value"] == 0.0
    cfg = cell.config
    assert got["mla_roofline.serve_history"]["value"] == pytest.approx(
        100 * 27 * (dw.mla_bound_seconds(cfg, [2000] * 10) + dw.mla_bound_seconds(cfg, [1000] * 10)) / 0.4)
    assert got["moe_roofline.serve_history"]["value"] == pytest.approx(
        100 * 26 * dw.moe_bound_seconds(cfg, [2000] * 10) / 0.26)
    for name in NEW_READERS:
        if name != "ctx_host_reads.serve_history":
            assert 0 < got[name]["value"] <= 100, name
    rec = _record(cell.config)
    rec["encoder"]["host_reads"] = {"reads": 3, "occurrences": 2}
    assert core.reader("ctx_host_reads.serve_history")(rec) == 1.5
    del rec["encoder"]["host_reads"]
    assert core.reader("ctx_host_reads.serve_history")(rec) is None
    bare = core.read_per_layer(cell, _record(cell.config, spans=False))
    assert set(bare) == {"idle_share.serve"}
    train = {"kind": "train", "profile": [{"busy_s": 1.0, "window_s": 1.0}]}
    assert all(core.reader(m)(train) is None for m in NEW_READERS)


# ---------------------------------------------------------------- correct


def _ctx(root, seed, **kw):
    return run.Context(core.load_cell(TINY_CELL, root), seed, 0.3, False, torch.device("cpu"),
                       t_start=time.perf_counter(), **kw)


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct_and_the_fp8_expert_control_is_not(hroot, seed):
    ctx = _ctx(hroot, seed)
    out = run.execute(ctx)
    assert out["correct"], out["checks"]
    assert out["numbers"]["route_mismatch"] < 0.05 and 0 < out["numbers"]["padded_share"] < 1
    assert out["numbers"]["ctx_rel_l2_routed"] <= out["numbers"]["ctx_rel_l2"] * 1.1
    limits = ctx.cell.limits["limits"]
    control = calibrate._control(ctx, out, ctx.cell.limits["control"])
    assert control["ctx_rel_l2"] > limits["ctx_rel_l2"], control


def test_set_up_runs_every_length_and_every_width_once():
    tr = core.load_cell(CELL).traffic
    warm = SH.warm_specs(tr["samples"], tr["widths"], tr["batch"])
    assert [s[0] for s in warm[:len(tr["samples"])]] == tr["samples"]
    assert all(s[2] == 512 and s[1] == (512,) * 10 for s in warm[:len(tr["samples"])])
    assert [s[2] for s in warm[len(tr["samples"]):]] == [1024, 1536, 2048] and len(warm) == 28 + 3


@pytest.mark.parametrize("fault", SH.FAULTS)
def test_fault_in_the_encoder_under_the_timed_path_is_not_correct(hroot, fault):
    """Each fault the driver plants in the program's encoder for
    ``calibrate --faults`` (top-1 for top-2 at this size, as top-5 for top-6
    at the published one; expert 0's output dropped; the YaRN mscale^2 left
    out of the softmax scale) fails ``ctx_rel_l2`` by more than twice its
    limit, and the traced run goes on. The program's module is whole again
    after the run."""
    from cse_tpu_torch.models import deepseek_v2 as dv

    kept = (dv.route, dv.softmax_scale)
    out = run_tiny(hroot, TINY_CELL, trace=True, fault=fault)
    limit = core.load_cell(TINY_CELL, hroot).limits["limits"]["ctx_rel_l2"]
    assert not out["correct"] and out["numbers"]["ctx_rel_l2"] > 2 * limit, out["checks"]
    assert "mfu.serve_history" in out["metrics"]
    assert (dv.route, dv.softmax_scale) == kept
    if fault == "top_k_less_one":  # another number of experts a token: every route differs
        assert out["numbers"]["route_mismatch"] == 1.0


def test_a_host_read_in_the_dispatch_is_counted_a_request(hroot, monkeypatch):
    """A dispatch that sizes its counts on the host (one read a MoE layer,
    two at this size) raises ``ctx_host_reads.serve_history`` by two a
    request. (On the CPU ``torch._grouped_mm``'s fallback reads each
    expert's offset, so the sound run's count is not 0 here; on the card
    it is, ``tests/test_torch_deepseek_v2.py``.)"""
    sound = run_tiny(hroot, TINY_CELL, trace=True)["metrics"]["ctx_host_reads.serve_history"]["value"]
    scatter = torch.Tensor.scatter_add_

    def counted(self, dim, index, src):
        n = int(index.max()) + 1  # the read
        return scatter(self, dim, index, src) if n else self

    monkeypatch.setattr(torch.Tensor, "scatter_add_", counted)
    read = run_tiny(hroot, TINY_CELL, trace=True)["metrics"]["ctx_host_reads.serve_history"]["value"]
    assert read == sound + 2


def test_positions_over_the_padded_width_are_the_same_function(hroot, monkeypatch):
    """Counting positions over the padded width shifts every real token of a
    row by its padding alike, and RoPE's scores depend on differences of
    positions only (pad keys are masked): the same function, so it is no
    fault the comparison can see. Its readings stay the sound run's but for
    the rounding of the bf16 cos and sin tables at other angles."""
    from cse_tpu_torch.models import deepseek_v2 as dv

    sound = run_tiny(hroot, TINY_CELL)
    monkeypatch.setattr(dv, "positions",
                        lambda mask: torch.arange(mask.shape[1], device=mask.device).expand(mask.shape))
    shifted = run_tiny(hroot, TINY_CELL)
    assert shifted["correct"]
    assert shifted["numbers"]["ctx_rel_l2"] < 1.5 * sound["numbers"]["ctx_rel_l2"]


def test_a_program_without_the_encoder_ends_the_run_at_once(hroot, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "cse_tpu_torch.models.deepseek_v2", None)
    t = time.perf_counter()
    with pytest.raises(SystemExit, match="no DeepSeek-V2 history encoder"):
        run_tiny(hroot, TINY_CELL)
    assert time.perf_counter() - t < 5


# ---------------------------------------------------------------- isolation


def test_reference_and_driver_load_nothing_of_the_program_or_transformers():
    top = _loaded("import perfbench.reference.deepseek_v2, perfbench.drivers.serve_history, "
                  "perfbench.metrics.deepseek_v2_work\nfrom perfbench import core\n"
                  + "".join(f"core.reader({m!r})\n" for m in NEW_READERS))
    assert not top & (set(core.FORBIDDEN) | {"cse_tpu_torch", "transformers"})


def test_configuration_holds_the_catalogs_config_unreduced():
    conf = next(c for c in json.loads((core.ROOT / "BENCHMARK.json").read_text())["configs"]
                if c["name"] == "contsep3_dsv2lite")
    cfg = json.loads((core.ROOT / conf["file"]).read_text())
    assert conf["reduced"] == cfg["reduced"] == [] and cfg["source"] == conf["source"]
    assert cfg["model_type"] == "deepseek_v2" and cfg["llm_dim"] == cfg["hidden_size"] == 2048
    assert (cfg["num_hidden_layers"], cfg["n_routed_experts"], cfg["n_shared_experts"],
            cfg["num_experts_per_tok"], cfg["kv_lora_rank"], cfg["q_lora_rank"]) == (27, 64, 2, 6, 512, None)
