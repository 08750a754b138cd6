"""The plain reference against the port's plain CPU path at tiny widths, in
fp32: ContExt and 3-speaker ContSep, the forward and three updates."""

from __future__ import annotations

import pytest

from perfbench.tests.tiny import run_tiny


@pytest.mark.parametrize("cell", ["tiny2.train", "tiny3.train"])
def test_reference_follows_the_port_through_three_updates(root_fp32, cell):
    out = run_tiny(root_fp32, cell)
    assert out["numbers"]["loss_gap_db"] < 1e-4
    assert out["numbers"]["grad_gap"] < 1e-4
    assert out["numbers"]["update_gap"] < 1e-3
    assert out["correct"]


@pytest.mark.parametrize("cell", ["tiny2.serve", "tiny3.serve"])
def test_reference_forward_matches_the_port(root_fp32, cell):
    out = run_tiny(root_fp32, cell)
    assert out["numbers"]["stream_rel_l2"] < 1e-5
    assert out["numbers"].get("logit_gap", 0.0) < 1e-5
    assert out["correct"]
