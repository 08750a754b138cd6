"""The port's spans (``cse_tpu_torch/utils/profiling.py::span``), the span
table of a traced sub-window (``perfbench/spans.py``), on the CPU at tiny
widths."""

from __future__ import annotations

import collections
from types import SimpleNamespace as NS

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from cse_tpu_torch.core.mesh import make_mesh
from cse_tpu_torch.models import Sepformer, SepformerConfig
from cse_tpu_torch.serving import ServingEngine
from cse_tpu_torch.train.optimizer import build_optimizer
from cse_tpu_torch.train.step import TrainConfig, make_train_step
from cse_tpu_torch.utils import profiling
from perfbench.metrics.sepformer_work import stack_shapes
from perfbench.spans import CUT, OUTSIDE, UNLINKED, args_of, reduce_spans
from perfbench.trace import reduce_events

TINY = dict(enc_channels=16, enc_kernel=8, enc_stride=4, d_model=32, nhead=4, d_ffn=64, num_tf_layers=2,
            num_dp_layers=2, chunk_size=10, llm_dim=64)
B, T = 2, 800


def _model(variant, spks):
    torch.manual_seed(0)
    return Sepformer(SepformerConfig(variant=variant, num_spks=spks, compute_dtype=torch.float32, **TINY))


def _names(fn):
    """The ``cse/`` ranges one call of ``fn`` records under the profiler, counted."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return collections.Counter(e.name for e in prof.events() if e.name.startswith("cse/"))


def _stacks(variant, n_layers=0):
    """The forward stacks' (and, with ``n_layers``, the fused backward's) ranges at the tiny
    shapes: G and L as the benchmark's yardstick computes them."""
    cfg = dict(TINY, variant=variant)
    out = collections.Counter()
    for view, (G, L) in stack_shapes(cfg, B, T).items():
        out[f"cse/model.stack.{view}[G={G},L={L}]"] = TINY["num_dp_layers"]
        if n_layers:
            out[f"cse/train.stack_backward[G={G},L={L}]"] = TINY["num_dp_layers"] * n_layers
    return out


def test_span_without_a_profiler_is_one_shared_no_op(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called without a profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = profiling.span("train.forward"), profiling.span("model.stack.intra", {"G": 1, "L": 2})
    assert a is b
    with a, b:
        pass


def test_span_names_its_range_with_its_arguments():
    got = _names(lambda: profiling.span("model.stack.inter", {"G": 20, "L": 43}).__enter__().__exit__(None, None, None))
    assert got == {"cse/model.stack.inter[G=20,L=43]": 1}
    assert args_of("cse/model.stack.inter[G=20,L=43]") == {"G": 20, "L": 43} and args_of("cse/serve") == {}


@pytest.mark.parametrize("variant,spks,mesh", [("context", 2, True), ("contsep", 3, False)])
def test_fused_train_step_records_every_span(variant, spks, mesh):
    """One fused step: forward, loss, backward, the optimizer and its two host
    reads once; each stack once a block; the fused backward once a layer and
    stack (from autograd's thread on the card); with a mesh the all-reduce and
    its row read."""
    model = _model(variant, spks)
    step = make_train_step(model, build_optimizer(1e-3), TrainConfig(variant=variant, num_spks=spks), fused=True,
                           device="cpu", mesh=make_mesh(1, device="cpu") if mesh else None)
    g = torch.Generator().manual_seed(1)
    batch = {"mixed": torch.randn(B, T, generator=g), "gt": torch.randn(B, T, generator=g),
             "ctx_feat": torch.randn(B, 1, TINY["llm_dim"], generator=g)}
    if variant == "contsep":
        batch["noises"] = torch.randn(B, T, spks - 1, generator=g)
    step(batch)
    want = collections.Counter({f"cse/{n}": 1 for n in (
        "train.forward", "model.encode", "model.mask_head", "model.decode", "train.loss", "train.backward",
        "train.optimizer", "train.optimizer.read_finite", "train.optimizer.read_clip")})
    want += _stacks(variant, TINY["num_tf_layers"])
    if variant == "contsep":
        want["cse/model.select"] = 1
    if mesh:
        want.update({"cse/train.all_reduce": 1, "cse/train.all_reduce.read_rows": 1})
    assert _names(lambda: step(batch)) == want


@pytest.mark.parametrize("quant", [None, "w8a8"])
def test_serving_request_records_every_span(quant):
    """One request of the three-speaker selector: the whole call, the encoder,
    each stack once a block at its shape, the mask head, the decoder, the
    selector."""
    model = _model("contsep", 3)
    engine = ServingEngine(model.cfg, model, device="cpu", quant=quant)
    g = torch.Generator().manual_seed(2)
    mix, ctx = torch.randn(B, T, generator=g), torch.randn(B, 1, TINY["llm_dim"], generator=g)
    engine(mix, ctx)
    want = collections.Counter({f"cse/{n}": 1 for n in (
        "serve", "model.encode", "model.mask_head", "model.decode", "model.select")}) + _stacks("contsep")
    assert _names(lambda: engine(mix, ctx)) == want


# ------------------------------------------------------------ the span table


def _ev(dev, a, b, name="k", id=0, linked=0, kind=None, thread=1, note=False):
    return NS(device_type=dev, time_range=NS(start=a, end=b), name=name, is_user_annotation=note, id=id,
              linked_correlation_id=linked, activity_type=kind, thread=thread)


def _host(a, b, name, id, thread=1):
    kind = "user_annotation" if name.startswith(("cse/", "bench/")) else "cpu_op"
    return _ev(DeviceType.CPU, a, b, name, id=id, kind=kind, thread=thread, note=kind == "user_annotation")


def _launch(t, id, thread=1):
    return _ev(DeviceType.CPU, t, t + 0.5, "cudaLaunchKernel", id=id, kind="cuda_runtime", thread=thread)


def _kernel(a, b, id, linked=0):
    return _ev(DeviceType.CUDA, a, b, "kern", id=id, linked=linked, kind="kernel")


W = 1000.0  # the sub-window on the profile's clock (µs); its host clock starts at the first operation, 2.0


def _table(events):
    return reduce_spans(events, W)


def _check_sums(events, table):
    busy = reduce_events(events, W)["busy_s"]
    assert sum(r["device_s"] for r in table.values()) == pytest.approx(busy, abs=1e-12)
    assert sum(r["idle_s"] for r in table.values()) == pytest.approx(W / 1e6 - busy, abs=1e-12)


def _bare(events):
    """The events as torch 2.11 gives them: no ``activity_type``, no ``linked_correlation_id``."""
    return [NS(**{k: v for k, v in vars(e).items() if k not in ("activity_type", "linked_correlation_id")})
            for e in events]


@pytest.mark.parametrize("bare", [False, True])
def test_span_table_sends_a_kernel_to_the_innermost_span_at_its_launch_on_any_thread(bare):
    """The backward's span runs on autograd's thread (7) inside the step's
    backward on the loop's thread (1): a kernel launched from thread 7 inside
    it goes to it; one launched from thread 7 after it, to the backward; one
    found through the operator it is linked to, to that operator's span
    (unlinked where the events carry no link, as torch 2.11's)."""
    events = [_host(2.0, 3.0, "bench/step", 1),
              _host(10.0, 400.0, "cse/train.backward", 2),
              _host(20.0, 100.0, "cse/train.stack_backward[G=4,L=9]", 3, thread=7),
              _launch(30.0, 900, thread=7), _kernel(40.0, 140.0, 900),
              _launch(150.0, 901, thread=7), _kernel(160.0, 200.0, 901),
              _host(500.0, 600.0, "cse/model.encode", 4), _host(510.0, 520.0, "aten::conv1d", 5),
              _kernel(530.0, 580.0, 777, linked=5)]
    if bare:
        events = _bare(events)
    t = _table(events)
    assert t["cse/train.stack_backward[G=4,L=9]"] == {"count": 1, "host_s": 80e-6, "device_s": 100e-6,
                                                      "idle_s": pytest.approx(20e-6)}
    assert t["cse/train.backward"]["device_s"] == pytest.approx(40e-6)
    assert t["cse/model.encode"]["device_s"] == pytest.approx(0.0 if bare else 50e-6)
    assert t[UNLINKED]["device_s"] == pytest.approx(50e-6 if bare else 0.0)
    _check_sums(events, t)


def test_span_table_splits_idle_across_nested_and_consecutive_spans():
    """Device idle from 0 to 1000 but for 300-400: 0-10 outside, 10-50 the
    forward, 50-80 the encoder inside it, 80-120 the forward, 120-300 and
    400-600 the optimizer, 600-700 its read inside it, 700-1000 outside."""
    events = [_host(2.0, 3.0, "bench/step", 1),
              _host(10.0, 120.0, "cse/train.forward", 2), _host(50.0, 80.0, "cse/model.encode", 3),
              _host(120.0, 700.0, "cse/train.optimizer", 4), _host(600.0, 700.0, "cse/train.optimizer.read_clip", 5),
              _launch(130.0, 900), _kernel(300.0, 400.0, 900)]
    t = _table(events)
    idle = {k: round(r["idle_s"] * 1e6, 6) for k, r in t.items()}
    assert idle == {OUTSIDE: 310.0, UNLINKED: 0.0, CUT: 0.0, "cse/train.forward": 80.0, "cse/model.encode": 30.0,
                    "cse/train.optimizer": 380.0, "cse/train.optimizer.read_clip": 100.0}
    assert t["cse/train.optimizer"]["device_s"] == pytest.approx(100e-6)
    _check_sums(events, t)


def test_span_table_fills_outside_unlinked_and_cut():
    """Outside: a kernel launched under no span. Unlinked: a kernel whose
    launch was not recorded (queued before the sub-window). Cut: a span that
    crosses the sub-window's end (which is 1000 + 2, the first operation's
    start), and one whose launched work was still running at that end, with
    every span that ends after that launch; overlapping work goes to the
    interval that reached the time first."""
    events = [_host(2.0, 3.0, "bench/request", 1),
              _launch(5.0, 900), _kernel(10.0, 60.0, 900),  # outside
              _kernel(0.0, 30.0, 555), _kernel(0.0, 30.0, 556),  # unlinked, overlap the one above from 10 to 30
              _host(100.0, 200.0, "cse/serve", 2), _launch(110.0, 901), _kernel(120.0, 300.0, 901),
              _host(700.0, 800.0, "cse/serve", 3), _host(710.0, 720.0, "cse/model.encode", 4),
              _launch(715.0, 902), _kernel(900.0, 990.0, 902),
              _host(730.0, 750.0, "cse/model.stack.intra[G=4,L=9]", 5), _launch(740.0, 903),
              _kernel(995.0, 1100.0, 903),  # still running at the end: the stack and the request are cut
              _host(950.0, 1010.0, "cse/serve", 6)]  # crosses the end
    t = _table(events)
    assert t[UNLINKED]["device_s"] == pytest.approx(30e-6) and t[OUTSIDE]["device_s"] == pytest.approx(30e-6)
    assert t["cse/serve"] == {"count": 1, "host_s": pytest.approx(100e-6), "device_s": pytest.approx(180e-6),
                              "idle_s": pytest.approx(20e-6)}
    assert t["cse/model.encode"] == {"count": 1, "host_s": pytest.approx(10e-6), "device_s": pytest.approx(90e-6),
                                     "idle_s": pytest.approx(10e-6)}
    assert t[CUT]["count"] == 3 and t[CUT]["host_s"] == pytest.approx((100 + 20 + 52) * 1e-6)
    assert t[CUT]["device_s"] == pytest.approx(5e-6)
    assert "cse/model.stack.intra[G=4,L=9]" not in t
    _check_sums(events, t)


def test_span_table_of_a_real_profile_counts_every_span_of_a_fused_step():
    """On the installed torch's own events of one fused step (CPU: no device
    work), every span is a row with the count the profiler recorded, its host
    time under the sub-window, and the idle time adds up to the sub-window."""
    model = _model("context", 2)
    step = make_train_step(model, build_optimizer(1e-3), TrainConfig(variant="context", num_spks=2), fused=True,
                           device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"mixed": torch.randn(B, T, generator=g), "gt": torch.randn(B, T, generator=g),
             "ctx_feat": torch.randn(B, 1, TINY["llm_dim"], generator=g)}
    step(batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(batch)
    events = list(prof.events())
    window = max(e.time_range.end for e in events)
    table = reduce_spans(events, window)
    counts = collections.Counter(e.name for e in events if e.name.startswith("cse/"))
    assert {k: r["count"] for k, r in table.items() if k.startswith("cse/")} == counts
    assert table[CUT]["count"] == 0 and all(r["device_s"] == 0.0 for r in table.values())
    assert sum(r["idle_s"] for r in table.values()) == pytest.approx(window / 1e6, abs=1e-12)
    assert table["cse/train.forward"]["host_s"] >= table["cse/model.encode"]["host_s"] > 0.0
