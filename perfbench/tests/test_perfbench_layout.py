"""The benchmark's data: every cell's files exist and agree with BENCHMARK.json,
and a new cell, configuration, mix and metric are found as new files alone."""

from __future__ import annotations

import hashlib
import json
import re

import pytest

from perfbench import core, program, weights

BENCH = json.loads((core.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert e2e == {"train_mixtures_per_s", "serve_audio_s_per_s", "serve_p95_ms", "setup_s"}
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_names_files_that_exist(cell):
    c = core.load_cell(cell)
    assert core.driver(c.traffic["kind"]).drive
    for m in c.per_layer:
        assert callable(core.reader(m["name"]))
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2 and c.per_layer
    assert set(program.MODEL_KEYS) | {"precision", "sample_rate", "source", "reduced"} <= set(c.config)
    assert c.limits["control"].split(":")[0] in ("reference", "program")
    assert all(isinstance(v, float) for v in c.limits["limits"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_every_per_layer_metric_is_read_in_its_cells(cell):
    """Each per-layer metric listed for a cell has a reader that finds its
    record's kind (the traced run's record, here with made-up readings)."""
    c = core.load_cell(cell)
    tr = c.traffic
    prof = [{"busy_s": 0.9, "window_s": 1.0}] * tr.get("ranks", 1)
    stack = {"quant": tr.get("quant"), "calls": [{"G": 2016, "L": 251, "ms": 500.0}]}
    if tr["kind"] == "train":
        rec = {"kind": "train", "config": c.config, "batch": tr["batch"], "samples": tr["samples"], "profile": prof,
               "sub_window": {"steps": 3, "elapsed_s": 3.0}, "stack": dict(stack, train=True), "allreduce_ms": 1.0}
    else:
        rec = {"kind": "serve", "config": c.config, "batch": tr["batch"], "quant": tr["quant"], "profile": prof,
               "sub_window": {"samples": tr["samples"][:3], "elapsed_s": 1.0}, "stack": dict(stack, train=False)}
    got = core.read_per_layer(c, rec)
    assert set(got) == {m["name"] for m in c.per_layer}
    for m in c.per_layer:
        if m["unit"] == "%" and "idle" not in m["name"]:
            assert 0 < got[m["name"]]["value"] <= 100


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_configuration_file_builds_the_program(name):
    """The configuration's weights load into the port's model by name and shape."""
    conf = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = json.loads((core.ROOT / conf["file"]).read_text())
    assert cfg["reduced"] == conf["reduced"] == []
    model = program.build_model(cfg, weights.draw_weights(cfg, 2**31 + 1, "cpu"), "cpu")
    assert sum(p.numel() for p in model.parameters()) == sum(v.numel() for v in weights.draw_weights(
        cfg, 1, "cpu").values())


def _digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "perfbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_config_mix_and_metric_are_new_files(tmp_path):
    """A cell, a configuration, a mix and a per-layer metric added the way a
    later PR adds them: files of their own and entries in BENCHMARK.json. The
    harness finds them, and no file it had was edited."""
    from perfbench.tests.tiny import make_root

    base = _digest(core.ROOT)
    new_root = make_root(tmp_path)
    (new_root / "perfbench" / "metrics" / "launch_free.serve.py").write_text(
        "def read(record):\n    return 1.0 if record.get('kind') == 'serve' else None\n")
    bench = json.loads((new_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "launch_free.serve", "unit": "%", "better": "higher", "source": "program_counter",
                               "layer": "stacks and kernels", "moves": "serve_audio_s_per_s",
                               "workloads": ["tiny2.serve"]})
    (new_root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(new_root)
    assert all(after[k] == v for k, v in base.items()), "an existing file of the benchmark was edited"
    cell = core.load_cell("tiny2.serve", new_root)
    assert cell.config["d_model"] == 32 and cell.traffic["samples"] == [1600, 2000, 2400]
    rec = {"kind": "serve", "config": cell.config, "batch": 2, "quant": None,
           "profile": [{"busy_s": 0.5, "window_s": 1.0}], "sub_window": {"samples": [2000], "elapsed_s": 1.0}}
    assert core.read_per_layer(cell, rec)["launch_free.serve"]["value"] == 1.0


SERVE_MIXES = sorted(p.stem for p in (core.ROOT / "perfbench" / "traffic").glob("*.json")
                     if json.loads(p.read_text())["kind"] == "serve")


@pytest.mark.parametrize("mix", SERVE_MIXES)
def test_request_lengths_are_their_lists(mix):
    """A serving mix's lengths and their counts are what its mixture list
    gives, every mixture of it once a block."""
    from perfbench.drivers.serve import buckets_from_list

    tr = json.loads((core.ROOT / "perfbench" / "traffic" / f"{mix}.json").read_text())
    samples, requests = buckets_from_list(core.ROOT / tr["lengths_from"], tr["grid_s"], tr["batch"], 8000)
    assert (tr["samples"], tr["requests"]) == (samples, requests)
    mixtures = [line for line in (core.ROOT / tr["lengths_from"]).read_text().splitlines() if line.strip()]
    assert sum(requests) * tr["batch"] >= len(mixtures)
