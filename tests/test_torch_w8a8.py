"""cse_tpu_torch w8a8 serving against the JAX package's ``_stack_kernel_w8a8``
(Pallas interpret mode on the CPU).

Bars: the quantizer is exact (payload equal, scales to rtol 1e-6); the w8a8
matmul holds tests/test_serving.py's 1e-5 / 1e-7 against ``_qdot`` and the
numpy oracle; a stack or engine holds relative L2 <= 1e-3 against JAX's w8a8
run (a one-ulp difference in an LN output can flip one int8 rounding, which
moves that element by up to 1/127 of its row scale) and the JAX suite's
5e-2 against its exact fp32 run. Inputs are numpy from a seed.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cse_tpu.models import Sepformer as JaxSepformer
from cse_tpu.models import SepformerConfig as JaxConfig
from cse_tpu.ops.fused_stack import _ln, _qdot, _quantize_stacked
from cse_tpu.ops.fused_stack import fused_stack_apply as jax_fused_stack_apply
from cse_tpu.serving import ServingEngine as JaxEngine
from cse_tpu_torch.compat.jax_params import load_jax_params
from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig, TransformerStack
from cse_tpu_torch.ops import fused_stack as fs
from cse_tpu_torch.ops import fused_stack_w8a8 as w8
from cse_tpu_torch.serving import ServingEngine, sepformer_fused_forward

torch.set_num_threads(1)

G, L, D, H, FFN, NL = 6, 11, 16, 4, 32, 2
TINY = dict(enc_channels=16, enc_kernel=8, enc_stride=4, d_model=16, nhead=4, d_ffn=32,
            num_tf_layers=2, num_dp_layers=2, chunk_size=10, llm_dim=24, se_dim=12, pe_max_len=256)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def test_quantize_stacked_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 8, 5)).astype(np.float32)
    w[1, :, 2] = 0  # an all-zero channel takes the 1e-12 floor
    q, s = fs.quantize_stacked(torch.from_numpy(w))
    jq, js = (np.asarray(a) for a in _quantize_stacked(jnp.asarray(w)))
    assert q.dtype == torch.int8 and q.shape == (3, 8, 5) and s.shape == (3, 1, 5)
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_allclose(s.numpy(), js, rtol=1e-6)


def test_quantize_rows_and_qdot_match_jax_and_oracle():
    """The oracle of tests/test_serving.py::test_w8a8_qdot_matches_numpy_oracle."""
    rng = np.random.default_rng(1)
    h = (rng.standard_normal((6, 16)) * 3.0).astype(np.float32)
    h[2] = 0  # a zero row: sa = 1e-12 / 127, payload 0
    w8_ = rng.integers(-127, 128, (16, 8)).astype(np.int8)
    s = ((rng.random((1, 8)) + 0.1) / 100.0).astype(np.float32)
    sa = np.maximum(np.max(np.abs(h), axis=-1, keepdims=True), 1e-12) / np.float32(127.0)
    hq = np.round(h / sa).astype(np.int8)
    want = (hq.astype(np.int64) @ w8_.astype(np.int64)) * sa.astype(np.float64) * s
    got_q, got_sa = w8.quantize_rows_plain(torch.from_numpy(h))
    np.testing.assert_array_equal(got_q.numpy(), hq)
    np.testing.assert_array_equal(got_sa.numpy(), sa[:, 0])
    got = w8.qdot_plain(got_q, got_sa, torch.from_numpy(w8_), torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-5, atol=1e-7)
    jgot = np.asarray(_qdot(jnp.asarray(h), jnp.asarray(w8_), jnp.asarray(s)))
    np.testing.assert_allclose(got, jgot, rtol=1e-5, atol=1e-7)


def test_linear_w8a8_epilogues_associate_as_jax():
    rng = np.random.default_rng(2)
    hq = torch.from_numpy(rng.integers(-127, 128, (5, 32)).astype(np.int8))
    sa = torch.from_numpy(rng.random(5).astype(np.float32) + 0.1)
    wq = torch.from_numpy(rng.integers(-127, 128, (32, 8)).astype(np.int8))
    s = torch.from_numpy(rng.random((1, 8)).astype(np.float32) / 100)
    b = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32))
    y = (hq.float() @ wq.float()) * sa[:, None] * s
    assert torch.equal(w8.linear_w8a8_plain(hq, sa, wq, s, b, "bias"), y + b)
    assert torch.equal(w8.linear_w8a8_plain(hq, sa, wq, s, b, "relu"), torch.relu(y + b))
    got = w8.linear_w8a8_plain(hq, sa, wq, s, b, "residual", r.clone())
    assert torch.equal(got, (r + y) + b)


@pytest.mark.parametrize("bias", ["random", "zero"])
def test_layer_norm_quant_plain_matches_jax_ln_and_quantizer(bias):
    """LN then the row quantizer against JAX's _ln and _qdot's quantization
    (:122-123, in jnp). The payloads are equal but for +-1 flips on at most
    1e-4 of them (an LN output one ulp apart can cross a rounding midpoint);
    sa to rtol 1e-6. A constant row under a zero bias is an all-zero LN row:
    it takes the 1e-12 floor and a zero payload."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((600, 256)) * 3.0 + 0.5).astype(np.float32)
    x[3] = 2.5
    scale = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    b = (0.1 * rng.standard_normal(256)).astype(np.float32) if bias == "random" else np.zeros(256, np.float32)
    h = _ln(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(b))
    jsa = jnp.maximum(jnp.max(jnp.abs(h), axis=-1, keepdims=True), 1e-12) / 127.0
    jq, jsa = np.asarray(jnp.round(h / jsa).astype(jnp.int8)), np.asarray(jsa)[:, 0]
    q, sa = w8.layer_norm_quant_plain(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(b))
    assert q.dtype == torch.int8 and q.shape == x.shape and sa.dtype == torch.float32 and sa.shape == (600,)
    d = np.abs(q.numpy().astype(np.int32) - jq.astype(np.int32))
    assert d.max() <= 1 and (d > 0).sum() <= 1e-4 * d.size
    np.testing.assert_allclose(sa.numpy(), jsa, rtol=1e-6)
    if bias == "zero":
        assert sa[3].item() == np.float32(1e-12) / np.float32(127.0) and not q[3].any()


def test_ffn_w8a8_plain_matches_jax_qdot_composition():
    """The FFN on the quantized LN2 output against JAX's
    x + _qdot(relu(_qdot(h, f1, s1) + b1), f2, s2) + b2 at the bar of
    test_quantize_rows_and_qdot_match_jax_and_oracle; the weights K-major, as
    stack_weights keeps them."""
    rng = np.random.default_rng(8)
    m, d, f = 45, 32, 64
    h = (rng.standard_normal((m, d)) * 2.0).astype(np.float32)
    w1 = rng.integers(-127, 128, (d, f)).astype(np.int8)
    w2 = rng.integers(-127, 128, (f, d)).astype(np.int8)
    s1 = ((rng.random((1, f)) + 0.1) / 100.0).astype(np.float32)
    s2 = ((rng.random((1, d)) + 0.1) / 100.0).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(f)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(d)).astype(np.float32)
    x = rng.standard_normal((m, d)).astype(np.float32)
    jh = jnp.maximum(_qdot(jnp.asarray(h), jnp.asarray(w1), jnp.asarray(s1)) + b1, 0.0)
    want = np.asarray(jnp.asarray(x) + _qdot(jh, jnp.asarray(w2), jnp.asarray(s2)) + b2)
    t = torch.from_numpy
    hq, sa = w8.quantize_rows_plain(t(h))
    r = t(x.copy())
    got = w8.ffn_w8a8_plain(hq, sa, fs.k_major(t(w1)), t(s1), t(b1), fs.k_major(t(w2)), t(s2), t(b2), r)
    assert got is r and got.dtype == torch.float32 and got.shape == (m, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    # the three-step chain it replaces, in the stack's order
    fq, fsa = w8.quantize_rows_plain(w8.linear_w8a8_plain(hq, sa, t(w1), t(s1), t(b1), "relu"))
    assert torch.equal(got, w8.linear_w8a8_plain(fq, fsa, t(w2), t(s2), t(b2), "residual", t(x.copy())))


def _stack_params(rng):
    def n(*s, scale=1.0):
        return (scale * rng.standard_normal(s)).astype(np.float32)

    tree = {"norm": {"scale": 1 + n(D, scale=0.1), "bias": n(D, scale=0.1)}}
    for j in range(NL):
        tree[f"layer_{j}"] = {
            "norm1": {"scale": 1 + n(D, scale=0.1), "bias": n(D, scale=0.1)},
            "norm2": {"scale": 1 + n(D, scale=0.1), "bias": n(D, scale=0.1)},
            "self_att": {"in_proj_kernel": n(D, 3 * D, scale=D ** -0.5), "in_proj_bias": n(3 * D, scale=0.1),
                         "out_proj_kernel": n(D, D, scale=D ** -0.5), "out_proj_bias": n(D, scale=0.1)},
            "ffn_1": {"kernel": n(D, FFN, scale=D ** -0.5), "bias": n(FFN, scale=0.1)},
            "ffn_2": {"kernel": n(FFN, D, scale=FFN ** -0.5), "bias": n(D, scale=0.1)},
        }
    return tree


@pytest.mark.parametrize("cd", ["fp32", "bf16"])
def test_stack_matches_jax_w8a8(cd):
    rng = np.random.default_rng(3)
    tree = _stack_params(rng)
    x = rng.standard_normal((G, L, D)).astype(np.float32)
    jcd, tcd = (jnp.float32, torch.float32) if cd == "fp32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jax_fused_stack_apply(jnp.asarray(x), tree, nhead=H, compute_dtype=jcd, quant="w8a8"))
    exact = np.asarray(jax_fused_stack_apply(jnp.asarray(x), tree, nhead=H, compute_dtype=jnp.float32))
    stack = load_jax_params(TransformerStack(SepformerConfig(d_model=D, nhead=H, d_ffn=FFN, num_tf_layers=NL)),
                            tree)
    w = fs.stack_weights(stack, tcd, quant="w8a8")
    assert w["qkv_w"].dtype == torch.int8 and w["qkv_w"].shape == (NL, D, 3 * D)
    assert w["qkv_s"].dtype == torch.float32 and w["qkv_s"].shape == (NL, 1, 3 * D)
    # the payload comes from the fp32 weights, never a cd-rounded copy
    q, _ = fs.quantize_stacked(torch.stack([lyr.ffn_1.weight.detach() for lyr in stack.layers]).transpose(1, 2))
    assert torch.equal(w["f1_w"], q)
    w8.reset_launches()
    got = fs.fused_stack_apply(torch.from_numpy(x), w, nhead=H, compute_dtype=tcd, quant="w8a8")
    assert w8.launch_counts() == {}
    assert got.dtype == torch.float32 and got.shape == (G, L, D)
    assert _rel_l2(got.numpy(), want) <= 1e-3
    assert _rel_l2(got.numpy(), exact) <= 5e-2
    per_stack = fs.launches_per_stack(8, "w8a8")
    assert per_stack == {"layer_norm": 1, "layer_norm_quant": 16, "attention": 8, "quantize_rows": 8,
                         "linear_w8a8": 16, "ffn_w8a8": 8}
    assert sum(per_stack.values()) == 57 == sum(fs.launches_per_stack(8).values())


MATS = {"qkv": lambda l: l.self_att.in_proj.weight, "out": lambda l: l.self_att.out_proj.weight,
        "f1": lambda l: l.ffn_1.weight, "f2": lambda l: l.ffn_2.weight}


@pytest.mark.parametrize("name", list(MATS))
def test_stack_weights_keep_the_int8_payload_k_major(name):
    """The int8 GEMM reads W K-major with no copy: stack_weights makes the
    K-major copy once, and its [n, dout, din] bytes are the exact transpose
    of quantize_stacked's [n, din, dout] payload (the same values as before)."""
    stack = load_jax_params(TransformerStack(SepformerConfig(d_model=D, nhead=H, d_ffn=FFN, num_tf_layers=NL)),
                            _stack_params(np.random.default_rng(5)))
    w = fs.stack_weights(stack, torch.bfloat16, quant="w8a8")
    q, _ = fs.quantize_stacked(torch.stack([MATS[name](lyr).detach() for lyr in stack.layers]).transpose(1, 2))
    kt = w[f"{name}_w"].transpose(1, 2)
    assert kt.is_contiguous() and kt.dtype == torch.int8
    assert torch.equal(kt, q.transpose(1, 2).contiguous()) and torch.equal(w[f"{name}_w"], q)
    assert all(w[f"{name}_w"][li].t().is_contiguous() for li in range(NL))  # what linear_w8a8 checks
    assert torch.equal(fs.k_major(q), q) and fs.k_major(q).transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("cd", ["fp32", "bf16"])
def test_run_stack_on_k_major_weights_matches_jax(cd):
    """run_stack with the plain ops on the K-major weights against JAX's
    _stack_kernel_w8a8 (interpret mode), at this file's stack bar."""
    rng = np.random.default_rng(6)
    tree = _stack_params(rng)
    x = rng.standard_normal((3, 29, D)).astype(np.float32)
    jcd, tcd = (jnp.float32, torch.float32) if cd == "fp32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jax_fused_stack_apply(jnp.asarray(x), tree, nhead=H, compute_dtype=jcd, quant="w8a8"))
    stack = load_jax_params(TransformerStack(SepformerConfig(d_model=D, nhead=H, d_ffn=FFN, num_tf_layers=NL)),
                            tree)
    w = fs.stack_weights(stack, tcd, quant="w8a8")
    got = w8.run_stack(torch.from_numpy(x), w, H, tcd, w8.PLAIN_OPS)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _rel_l2(got.numpy(), want) <= 1e-3


# the widths the w8a8 engine is held at: the JAX suite's TINY (d_model 16, head
# width 4) and --debug_tiny_model's (d_model 32, head width 8, FFN 64); the
# paper's 256 / 1024 runs on the card (chip_smoke.py [9], [19])
WIDTHS = {"jax-tiny": TINY, "cli-tiny": dict(TINY, enc_channels=32, d_model=32, d_ffn=64)}


@functools.cache
def _engine_case(variant, widths="jax-tiny"):
    rng = np.random.default_rng(4)
    cfg = JaxConfig(variant=variant, ce=True, compute_dtype=jnp.float32, **WIDTHS[widths])
    mix = rng.standard_normal((2, 300)).astype(np.float32)
    ctx = rng.standard_normal((2, 1, 24)).astype(np.float32)
    params = jax.tree.map(np.asarray, JaxSepformer(cfg).init(jax.random.key(0), mix, ctx))
    outs = {q: JaxEngine(cfg, params, quant=q)(mix, ctx) for q in (None, "w8a8")}
    outs = {q: [np.asarray(o) for o in (v if variant == "contsep" else (v,))] for q, v in outs.items()}
    return params, mix, ctx, outs


def _engine_matches_jax(variant, widths):
    params, mix, ctx, outs = _engine_case(variant, widths)
    engine = ServingEngine(SepformerConfig(variant=variant, ce=True, **WIDTHS[widths]), params, device="cpu",
                           quant="w8a8")
    got = engine(mix, ctx)
    got = list(got) if variant == "contsep" else [got]
    for g, want, exact in zip(got, outs["w8a8"], outs[None]):
        g = g.numpy()
        assert np.isfinite(g).all() and g.shape == want.shape
        assert _rel_l2(g, want) <= 1e-3
        assert _rel_l2(g, exact) <= 5e-2


@pytest.mark.parametrize("variant", ["context", "contsep"])
def test_engine_matches_jax_w8a8(variant):
    _engine_matches_jax(variant, "jax-tiny")


# The whole w8a8 engine is chaotic at the size of one rounding: at cli-tiny,
# noise of 1e-6 on the mixture moves the fp32 engine's output by ~3e-6 (rel
# L2) and the w8a8 engine's by 2e-3 to 3e-3 (six draws), since an LN output
# an ulp apart flips an int8 rounding by a whole step. So the engine's own
# bar against JAX's w8a8 engine is 1e-2; each of its stacks is held at this
# file's 1e-3 against JAX's _stack_kernel_w8a8 on the input the engine gave it.
ENGINE_W8A8_TOL = 1e-2


@pytest.mark.parametrize("variant", ["context", "contsep"])
def test_engine_matches_jax_w8a8_at_cli_tiny(variant, monkeypatch):
    """The --debug_tiny_model widths, on the chain route the card takes there:
    every stack call of the engine against JAX's w8a8 stack on its input, the
    outputs against JAX's w8a8 engine and its exact fp32 run."""
    import cse_tpu_torch.serving as tserving

    assert w8.stack_route(32, 64) == "chain"
    params, mix, ctx, outs = _engine_case(variant, "cli-tiny")
    calls, stack_call = [], tserving.fused_stack_apply

    def recorded(x, w, **kw):
        y = stack_call(x, w, **kw)
        calls.append((x.numpy().copy(), y.numpy().copy()))
        return y

    monkeypatch.setattr(tserving, "fused_stack_apply", recorded)
    widths = WIDTHS["cli-tiny"]
    engine = ServingEngine(SepformerConfig(variant=variant, ce=True, **widths), params, device="cpu", quant="w8a8")
    got = engine(mix, ctx)
    masknet = params["params"]["masknet"]
    trees = [masknet[f"dual_mdl_{i}"][k] for i in range(widths["num_dp_layers"]) for k in ("intra_mdl", "inter_mdl")]
    assert len(calls) == len(trees)
    for (x, y), tree in zip(calls, trees):
        want = np.asarray(jax_fused_stack_apply(jnp.asarray(x), tree, nhead=widths["nhead"],
                                                compute_dtype=jnp.float32, quant="w8a8"))
        assert _rel_l2(y, want) <= 1e-3
    for g, want, exact in zip(list(got) if variant == "contsep" else [got], outs["w8a8"], outs[None]):
        g = g.numpy()
        assert np.isfinite(g).all() and g.shape == want.shape
        assert _rel_l2(g, want) <= ENGINE_W8A8_TOL
        assert _rel_l2(g, exact) <= 5e-2


# (d_model, nhead, d_ffn) of the three widths the card runs: jax-tiny, cli-tiny, the paper's
STACK_WIDTHS = {"jax-tiny": (16, 4, 32), "cli-tiny": (32, 4, 64), "paper": (256, 8, 1024)}
OP_KERNELS = {"ln": "layer_norm", "lnq": "layer_norm_quant", "quant": "quantize_rows", "lin": "linear_w8a8",
              "attn": "attention", "ffn": "ffn_w8a8"}


def _counting_plain_ops(counts):
    """PLAIN_OPS with each call counted under the kernel it stands for."""
    def counted(name, fn):
        def call(*a, **k):
            counts[OP_KERNELS[name]] = counts.get(OP_KERNELS[name], 0) + 1
            return fn(*a, **k)
        return call
    ops = dict(vars(w8.PLAIN_OPS))
    return types.SimpleNamespace(**{k: counted(k, f) if k in OP_KERNELS else f for k, f in ops.items()})


@pytest.mark.parametrize("widths", list(STACK_WIDTHS))
def test_launches_per_stack_follows_the_route(widths):
    """run_stack calls each kernel as often as launches_per_stack counts for
    the route its widths choose: the fused one (57 calls at 8 layers) at the
    paper's widths only, the chain (89 at 8 layers) at the others."""
    d, h, f = STACK_WIDTHS[widths]
    route = w8.stack_route(d, f)
    assert route == ("fused" if widths == "paper" else "chain")
    stack = TransformerStack(SepformerConfig(d_model=d, nhead=h, d_ffn=f, num_tf_layers=2))
    w = fs.stack_weights(stack, torch.float32, quant="w8a8")
    counts = {}
    got = w8.run_stack(torch.randn(2, 5, d, generator=torch.Generator().manual_seed(0)), w, h, torch.float32,
                       _counting_plain_ops(counts))
    assert got.shape == (2, 5, d) and torch.isfinite(got).all()
    assert counts == fs.launches_per_stack(2, "w8a8", d, f)
    total = sum(fs.launches_per_stack(8, "w8a8", d, f).values())
    assert total == (57 if route == "fused" else 89)


@pytest.mark.parametrize("d, h, f, what", [(48, 4, 96, "head widths"), (256, 8, 2048, "K <= 1024"),
                                           (40, 5, 80, "K % 16")])
def test_w8a8_stack_refuses_widths_no_route_takes(d, h, f, what, monkeypatch):
    """Head width 12, an FFN wider than the int8 GEMM's K, a K % 16 != 0:
    the kernel path raises before its first launch (the device check
    answered as for CUDA tensors, the library refused)."""
    monkeypatch.setattr(fs, "_route", lambda *ts: True)
    monkeypatch.setattr(w8._build, "library", lambda: pytest.fail("no launch for a refused width"))
    monkeypatch.setattr(fs._build, "library", lambda: pytest.fail("no launch for a refused width"))
    stack = TransformerStack(SepformerConfig(d_model=d, nhead=h, d_ffn=f, num_tf_layers=1))
    w = fs.stack_weights(stack, torch.bfloat16, quant="w8a8")
    with pytest.raises(ValueError, match=what):
        fs.fused_stack_apply(torch.zeros(1, 4, d, dtype=torch.bfloat16), w, h, torch.bfloat16, quant="w8a8")


def test_w8a8_refuses_training_and_unknown_modes():
    params, mix, ctx, _ = _engine_case("context")
    cfg = SepformerConfig(variant="context", **TINY)
    model = load_jax_params(Sepformer(cfg), params)
    with pytest.raises(ValueError, match="inference-only"):
        sepformer_fused_forward(model, torch.from_numpy(mix), torch.from_numpy(ctx), train=True, quant="w8a8")
    with pytest.raises(ValueError, match="quant"):
        ServingEngine(cfg, model, device="cpu", quant="int4")
    with pytest.raises(TypeError, match="int8"):
        sepformer_fused_forward(model, torch.from_numpy(mix), torch.from_numpy(ctx), quant="w8a8",
                                stacks=ServingEngine(cfg, model, device="cpu").stacks)


def _ffn_args(m=4, d=256, f=1024, device="cpu"):
    i8 = dict(dtype=torch.int8, device=device)
    return (torch.zeros(m, d, **i8), torch.ones(m, device=device), fs.k_major(torch.zeros(d, f, **i8)),
            torch.ones(1, f, device=device), torch.zeros(f, device=device), fs.k_major(torch.zeros(f, d, **i8)),
            torch.ones(1, d, device=device), torch.zeros(d, device=device), torch.zeros(m, d, device=device))


def test_wrappers_refuse_other_devices():
    h = torch.empty(4, 16, device="meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        w8.quantize_rows(h)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        w8.linear_w8a8(torch.empty(4, 16, dtype=torch.int8, device="meta"), torch.empty(4, device="meta"),
                       torch.empty(16, 8, dtype=torch.int8), torch.empty(8), torch.empty(8), "bias")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        w8.layer_norm_quant(torch.empty(4, 256, device="meta"), torch.ones(256), torch.zeros(256))
    args = list(_ffn_args())
    args[0] = args[0].to("meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        w8.ffn_w8a8(*args)


@pytest.mark.parametrize("d, f", [(128, 1024), (256, 512), (512, 1024)])
def test_new_wrappers_refuse_other_widths(d, f, monkeypatch):
    """layer_norm_quant and ffn_w8a8 take the model's widths (D 256, F 1024)
    and raise for any other before they launch: run here with the device
    check answered as for CUDA tensors, so the widths are what is checked."""
    monkeypatch.setattr(fs, "_route", lambda *ts: True)
    monkeypatch.setattr(w8._build, "library", lambda: pytest.fail("no launch for a refused width"))
    if d != 256:
        with pytest.raises(ValueError, match="D = 256"):
            w8.layer_norm_quant(torch.zeros(4, d), torch.ones(d), torch.zeros(d))
    with pytest.raises(ValueError, match="D = 256, F = 1024"):
        w8.ffn_w8a8(*_ffn_args(d=d, f=f))
    with pytest.raises(ValueError, match="K-major"):  # the right widths, a row-major weight
        args = list(_ffn_args())
        args[2] = args[2].contiguous()
        w8.ffn_w8a8(*args)
