"""cse_tpu_torch.ops.kernel_parts against the kernel-parts tool's Pallas body
(``scripts/bench_kernel_parts.py::make_kernel``) in interpret mode on the CPU.

The test builds its own ``pl.pallas_call`` around the body (BlockSpecs without
a memory space; the script is not edited). Tolerances: fp32 max-rel <= 1e-5
(the same fp32 arithmetic in another summation order); relative L2 for the
three modes whose output is D x the softmax; bf16 relative L2 <= 1e-2 (the
same roundings at the same places, a few flipped by the summation order).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cse_tpu_torch.ops import kernel_parts as kp

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "bench_kernel_parts_ref", Path(__file__).resolve().parent.parent / "scripts" / "bench_kernel_parts.py")
ref_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_tool)

QUIRK = ("softmax_matmul", "combined", "combined_x2")  # z = sum(p) / D: D x softmax
JDT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(G, Lp, D, n_layers, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, Lp, D)).astype(np.float32) * 0.1
    w = rng.standard_normal((n_layers, D, 3 * D)).astype(np.float32) * 0.05
    f1 = rng.standard_normal((n_layers, D, 4 * D)).astype(np.float32) * 0.05
    f2 = rng.standard_normal((n_layers, 4 * D, D)).astype(np.float32) * 0.05
    return x, w, f1, f2


def _pallas(mode, x, w, f1, f2, nhead, cd):
    """The tool's body under ``pl.pallas_call(interpret=True)``."""
    G, Lp, D = x.shape
    n_layers = w.shape[0]
    args = (jnp.asarray(x), jnp.asarray(w, cd), jnp.asarray(f1, cd), jnp.asarray(f2, cd),
            jnp.full((D, 128), 1.0 / D, cd))
    xspec = pl.BlockSpec((1, Lp, D), lambda i: (i, 0, 0))
    full = lambda a: pl.BlockSpec(a.shape, lambda i, _n=a.ndim: (0,) * _n)
    f = pl.pallas_call(
        ref_tool.make_kernel(mode, n_layers, nhead, D, cd),
        grid=(G,),
        in_specs=[xspec] + [full(a) for a in args[1:]],
        out_specs=xspec,
        out_shape=jax.ShapeDtypeStruct((G, Lp, D), jnp.float32),
        interpret=True,
    )
    return np.asarray(f(*args))


def _port(mode, x, w, f1, f2, nhead, cd):
    D = x.shape[-1]
    t = lambda a: torch.from_numpy(a).to(cd)
    out = kp.kernel_parts_apply(torch.from_numpy(x), t(w), t(f1), t(f2),
                                torch.full((D, 128), 1.0 / D).to(cd), mode, nhead)
    assert out.dtype == torch.float32 and tuple(out.shape) == x.shape
    return out.numpy()


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _hold(got, want, mode, tag):
    assert np.isfinite(got).all()
    if tag == "bf16":
        assert _rel_l2(got, want) <= 1e-2
    elif mode in QUIRK:
        assert _rel_l2(got, want) <= 1e-5
    else:
        assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5


@pytest.mark.parametrize("tag", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", list(kp.MODES))
def test_mode_matches_pallas_body(mode, tag):
    jcd, tcd = JDT[tag]
    x, w, f1, f2 = _inputs(2, 32, 32, 2)
    _hold(_port(mode, x, w, f1, f2, 4, tcd), _pallas(mode, x, w, f1, f2, 4, jcd), mode, tag)


@pytest.mark.parametrize("mode,tag", [("combined_x2", "bf16"), ("full", "fp32")])
def test_matches_pallas_body_at_64_and_8_heads(mode, tag):
    jcd, tcd = JDT[tag]
    x, w, f1, f2 = _inputs(2, 64, 64, 2, seed=1)
    _hold(_port(mode, x, w, f1, f2, 8, tcd), _pallas(mode, x, w, f1, f2, 8, jcd), mode, tag)


def test_softmax_sum_through_jmat_is_d_times_softmax():
    """The tool's own arithmetic, kept: ``p @ jmat`` is ``sum(p) / D``, so
    ``combined_x2`` differs from ``full`` while ``combined_hp`` (true ones)
    agrees with it; the port and the Pallas body say the same."""
    x, w, f1, f2 = _inputs(2, 32, 32, 2)
    out = {m: _port(m, x, w, f1, f2, 4, torch.float32) for m in ("full", "combined_hp", "combined_x2")}
    assert np.abs(out["combined_hp"] - out["full"]).max() <= 1e-5
    assert np.abs(out["combined_x2"] - out["full"]).max() > 1.0
    ref = {m: _pallas(m, x, w, f1, f2, 4, jnp.float32) for m in ("full", "combined_x2")}
    assert np.abs(ref["combined_x2"] - ref["full"]).max() > 1.0


@pytest.mark.parametrize("tag", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["full", "ln_matmul", "combined_hp", "combined_x2"])
def test_near_constant_row(mode, tag):
    """A constant row and a near-constant row: var = E[x^2] - mu^2 is 0 (or
    within a rounding of it), and rsqrt(var + 1e-6) decides the output."""
    jcd, tcd = JDT[tag]
    x, w, f1, f2 = _inputs(2, 32, 32, 2, seed=2)
    x[0, 0] = 0.5
    x[0, 1] = 0.5 + 1e-4 * np.random.default_rng(3).standard_normal(32).astype(np.float32)
    got, want = _port(mode, x, w, f1, f2, 4, tcd), _pallas(mode, x, w, f1, f2, 4, jcd)
    assert np.isfinite(want).all() and np.isfinite(got).all()
    # the moments of a near-constant row cancel to rounding noise, which
    # rsqrt(var + 1e-6) magnifies by up to 1e3 in that row: hold the run at
    # 10x the modes' bars
    assert _rel_l2(got, want) <= (1e-1 if tag == "bf16" else 1e-4)


def test_layer_norm_of_a_constant_row_is_zero():
    x = torch.full((3, 32), 0.5)
    for cd in (torch.float32, torch.bfloat16):
        j = torch.full((32, 128), 1.0 / 32).to(cd)
        for ln_mode in ("centred", "cd", "exact", "x2"):
            out = kp.kp_layer_norm(x, j, ln_mode, cd)
            assert out.dtype == cd and float(out.float().abs().max()) == 0.0


def test_unknown_mode_and_lp_not_d_raise():
    x, w, f1, f2 = (torch.from_numpy(a) for a in _inputs(1, 16, 32, 1))
    j = torch.full((32, 128), 1.0 / 32)
    with pytest.raises(ValueError, match="unknown mode"):
        kp.kernel_parts_apply(x, w, f1, f2, j, "fastest", 4)
    with pytest.raises(ValueError, match="Lp == 32"):
        kp.kernel_parts_apply(x, w, f1, f2, j, "combined", 4)
    assert kp.kernel_parts_apply(x, w, f1, f2, j, "combined_hp", 4).shape == (1, 16, 32)


def test_launch_formula_and_cpu_counts_nothing():
    kp.reset_launches()
    x, w, f1, f2 = (torch.from_numpy(a) for a in _inputs(1, 32, 32, 2))
    kp.kernel_parts_apply(x, w, f1, f2, torch.full((32, 128), 1.0 / 32), "full", 4)
    assert kp.launch_counts() == {"kp_layer_norm": 0, "kp_attention": 0, "linear": 0}
    assert kp.launches_per_call(2) == {"kp_layer_norm": 4, "kp_attention": 2, "linear": 6}


def test_tool_inputs_and_flop_count():
    from cse_tpu_torch.scripts import bench_kernel_parts as tool

    x, w, f1, f2, j = tool.make_inputs(2, 16, 16, 2, device="cpu")
    rx, rw, _, _ = _inputs(2, 16, 16, 2)
    np.testing.assert_array_equal(x.numpy(), rx)
    np.testing.assert_array_equal(w.float().numpy(), np.asarray(jnp.asarray(rw, jnp.bfloat16).astype(jnp.float32)))
    assert j.dtype == torch.bfloat16 and float(j[0, 0]) == 1 / 16
    assert tool.flop_count(1008, 256, 256, 2) == 1008 * 2 * (2 * 256 * 256 * 256 * 12 + 2 * 256 * 256 * 256 * 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(["--G", "1"])
