"""The yardstick's operation counts against a hand count at the paper's widths."""

from __future__ import annotations

import json

import pytest

from perfbench import core
from perfbench.metrics import sepformer_work as sw

CFG = json.loads((core.ROOT / "perfbench" / "configs" / "context2.json").read_text())


def test_intra_stack_forward_at_paper_width():
    """One intra stack at B=16, T=125000: G = 16 x 126 chunks, L = 250 + 1.
    A layer: 2 G L (4 D^2 + 2 D F) for the four projections and 4 G L^2 D
    for QK^T and PV; eight layers: 7.41 TFLOP, 7.49 ms at 989 TFLOP/s."""
    G, L = sw.stack_shapes(CFG, 16, 125000)["intra"]
    assert (G, L) == (2016, 251)
    D, F = 256, 1024
    hand = 8 * (2 * G * L * (4 * D * D + 2 * D * F) + 4 * G * L * L * D)
    got = sw.stack_products(CFG, G, L)
    assert got == {"bf16": pytest.approx(hand)} and hand == pytest.approx(7.41e12, rel=1e-3)
    assert sw.ideal_seconds(got) == pytest.approx(7.49e-3, rel=1e-3)
    assert sw.stack_shapes(CFG, 16, 125000)["inter"] == (4000, 127)


def test_w8a8_counts_projections_at_the_int8_peak():
    G, L = 4000, 127
    bf, w8 = sw.stack_products(CFG, G, L), sw.stack_products(CFG, G, L, "w8a8")
    assert sum(w8.values()) == pytest.approx(bf["bf16"])
    assert w8["int8"] == pytest.approx(8 * 2 * G * L * (4 * 256 * 256 + 2 * 256 * 1024))
    assert sw.ideal_seconds(w8) < sw.ideal_seconds(bf)


def test_training_is_three_forwards_and_the_stacks_dominate():
    fwd = sw.forward_products(CFG, 16, 125000)
    stacks = 2 * sum(sw.stack_products(CFG, G, L)["bf16"] for G, L in sw.stack_shapes(CFG, 16, 125000).values())
    assert 0.98 < stacks / fwd["bf16"] < 1.0
    assert sw.train_step_seconds(CFG, 16, 125000) == pytest.approx(3 * fwd["bf16"] / 989e12)
    assert sw.stack_bound_seconds(CFG, 2016, 251, train=True) == pytest.approx(3 * 7.49e-3, rel=1e-3)
