"""The port's bench, ``python -m cse_tpu_torch.bench``, on the CPU: ``--smoke``
prints one JSON line with the root bench's metric name (and its launch report
on standard error), also with the frozen Llama in the step (``--with_llm``,
``--ctx_sim``) and for the H-ContExt recipe (``--variant hcontext``), and
the cascaded pipeline's realtime factor (``--cascaded``, also with
``--cascaded_llm``); ``--mesh_data N`` over N processes (one JSON line,
from rank 0) and, in one process, the world-size check; without ``--smoke``
and without a card it raises and prints nothing."""

import argparse
import importlib.util
import json
import math
import re
from pathlib import Path

import pytest
import torch

from cse_tpu_torch import bench
from torch_ranks import launch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("extra", [[], ["--variant", "contsep"], ["--variant", "hcontext"], ["--infer"],
                                   ["--infer", "--variant", "contsep"], ["--infer", "--variant", "hcontext"],
                                   ["--infer", "--serving_quant", "w8a8"]])
def test_smoke_prints_one_line_with_the_root_metric_name(extra, capsys):
    got = bench.main(["--smoke", "--steps", "2", "--warmup", "1"] + extra)
    captured = capsys.readouterr()
    lines = captured.out.splitlines()
    assert len(lines) == 1
    # standard error's report: 3 train steps (1 + 2) or forwards (2 + 1), and
    # no kernel launch, since the CPU runs the plain versions
    assert json.loads(captured.err.splitlines()[-1]) == {"launches": {}, "calls": 3}
    line = json.loads(lines[0])
    assert line == got and set(line) == {"metric", "value", "unit", "vs_baseline"}
    args = bench.parse_args(extra)
    root = argparse.Namespace(infer=args.infer, variant=args.variant, cascaded=False, with_llm=False)
    assert line["metric"] == _root_bench()._metric_name(root)
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert "CPU smoke" in line["unit"]  # a CPU number is never labelled as the GPU's
    assert (line["vs_baseline"] is None) == args.infer


@pytest.mark.parametrize("extra,item", [pytest.param(["--mesh_data", "2"], "must be the world size, 1 process",
                                                     id="extra2-item 5")])
def test_unported_flags_raise(extra, item, capsys):
    # --mesh_data must be the world size: one process cannot hold a data axis of 2
    with pytest.raises(SystemExit, match=item):
        bench.main(["--smoke"] + extra)
    assert capsys.readouterr().out == ""


def test_smoke_mesh_data_over_two_processes():
    """--mesh_data 2 over two gloo processes: rank 0 prints the one JSON
    line (mixtures/s per chip, the root bench's DP note with the global
    batch of 2 x 2) and the launch report; rank 1 prints neither."""
    outs = launch(["-m", "cse_tpu_torch.bench", "--smoke", "--mesh_data", "2", "--steps", "2", "--warmup", "1"], 2)
    lines = [[json.loads(x) for x in out.splitlines() if x.startswith("{")] for out in outs]
    assert len(lines[0]) == 2 and lines[1] == []
    (line,), (report,) = ([x for x in lines[0] if key in x] for key in ("metric", "launches"))
    assert line["metric"] == "train_throughput_contextual_extraction" and line["value"] > 0
    assert "batch 2, DP x2 (global batch 4)" in line["unit"] and "CPU smoke" in line["unit"]
    assert report == {"launches": {}, "calls": 3}


@pytest.mark.parametrize("extra", [["--with_llm"], ["--with_llm", "--ctx_sim"]])
def test_smoke_with_llm_prints_one_line(extra, capsys):
    """The frozen Llama's prefill inside the step (the tiny 2-layer
    configuration on the CPU): one JSON line with the root bench's
    ``_with_llm`` metric name; on standard error the bare prefill's
    decomposition line, then the launch report (none on the CPU) over the
    steps run: with ``--ctx_sim`` one more for each context width hit first."""
    got = bench.main(["--smoke", "--steps", "3", "--warmup", "1"] + extra)
    captured = capsys.readouterr()
    lines = captured.out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == got
    root = argparse.Namespace(infer=False, variant="context", cascaded=False, with_llm=True)
    assert got["metric"] == _root_bench()._metric_name(root) == "train_throughput_contextual_extraction_with_llm"
    assert math.isfinite(got["value"]) and got["value"] > 0 and "CPU smoke" in got["unit"]
    assert "tiny-smoke llm in-step" in got["unit"]
    err = captured.err.splitlines()
    assert err[-2].startswith("bench decomposition: bare int8 tiny-smoke prefill") and "@ 512 tokens" in err[-2]
    report = json.loads(err[-1])
    assert report["launches"] == {}
    if "--ctx_sim" in extra:
        buckets = re.search(r"ctx-sim buckets ([0-9x/]+)", got["unit"]).group(1).split("/")
        assert sum(int(b.split("x")[1]) for b in buckets) == 3
        assert report["calls"] == len(buckets) + 1 + 3
    else:
        assert report["calls"] == 1 + 3
    assert bench.parse_args(extra).batch == 8 and bench.parse_args([]).batch == 16


@pytest.mark.parametrize("extra", [[], ["--cascaded_llm"]])
def test_smoke_cascaded_prints_one_line(extra, capsys):
    """The cascaded pipeline on the CPU (the tiny separator, the stub-width
    Whisper, the stand-in or a 2-layer Llama scorer): one JSON line with the
    root bench's metric name; the launch report over the warm mixture and
    the timed ones (no launch on the CPU)."""
    got = bench.main(["--smoke", "--cascaded", "--steps", "2"] + extra)
    captured = capsys.readouterr()
    lines = captured.out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == got
    root = argparse.Namespace(infer=False, variant="context", cascaded=True, with_llm=False)
    assert got["metric"] == _root_bench()._metric_name(root) == "cascaded_pipeline_rtf"
    assert math.isfinite(got["value"]) and got["value"] > 0 and "CPU smoke" in got["unit"]
    assert ("LM=tiny-smoke-int8" if extra else "LM=host-stub") in got["unit"] and got["vs_baseline"] is None
    assert json.loads(captured.err.splitlines()[-1]) == {"launches": {}, "calls": 3}


def test_without_smoke_and_card_it_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--infer"], ["--with_llm"], ["--cascaded"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            bench.main(extra)
    assert capsys.readouterr().out == ""
