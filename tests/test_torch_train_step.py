"""cse_tpu_torch.train.step against cse_tpu.train.step at the tiny ContExt
config of tests/test_fused_train.py.

Weights go across through cse_tpu_torch.compat.jax_params (so do JAX's
gradient and updated-parameter trees, which have the parameters' layout);
inputs are numpy from a seed. Loss and gradients: rtol 5e-3, atol 1e-4, the
JAX suite's fused-vs-XLA bar; the 50-step bf16 trajectory: max relative
deviation < 5e-2 and both curves descend (tests/test_fused_train.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cse_tpu.train.step as jstep
import cse_tpu_torch.train.step as tstep
from cse_tpu.models import Sepformer as JaxSepformer
from cse_tpu.models import SepformerConfig as JaxConfig
from cse_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from cse_tpu.train.schedules import cosine_warmup_schedule as jax_cosine
from cse_tpu_torch.compat.jax_params import jax_params_to_state_dict, load_jax_params
from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig
from cse_tpu_torch.ops import fused_train as tft
from cse_tpu_torch.train.optimizer import build_optimizer
from cse_tpu_torch.train.schedules import cosine_warmup_schedule

torch.set_num_threads(1)

TINY = dict(enc_channels=32, enc_kernel=8, enc_stride=4, d_model=32, nhead=4, d_ffn=64,
            num_dp_layers=1, chunk_size=16, llm_dim=24, se_dim=12, pe_max_len=256)
B, T = 2, 400
TOL = dict(rtol=5e-3, atol=1e-4)
# (train variant, model variant, add_se, ce, layers, speakers); the
# three-speaker forms are the JAX suite's num_spks=3 (tests/test_model_parity.py):
# PIT over six permutations, the selector over three streams
CASES = {
    "context": ("context", "context", False, True, 2, 2),
    "contsep-ce": ("contsep", "contsep", False, True, 1, 2),
    "contsep-bce": ("contsep", "contsep", False, False, 1, 2),
    "base": ("base", "base", False, True, 1, 2),
    "hcontext": ("hcontext", "context", True, True, 1, 2),
    "contsep-ce-3spk": ("contsep", "contsep", False, True, 1, 3),
    "base-3spk": ("base", "base", False, True, 1, 3),
}
HCONTEXT_CUE = 0  # the cue both packages use when _sample_cue is fixed
# Against a random gt the SI-SNR sits near -40 dB: a cancellation that
# magnifies a 1e-6 difference in the estimate to 1e-4 in every gradient. The
# loss and gradient checks therefore use gt = the JAX model's own stream-0
# estimate plus noise (SI-SNR near +6 dB); the trajectory keeps the random gt.


def _cfgs(case, dtype="fp32"):
    tv, mv, add_se, ce, layers, spks = CASES[case]
    jcfg = JaxConfig(variant=mv, add_se=add_se, ce=ce, num_tf_layers=layers, num_spks=spks,
                     compute_dtype=jnp.float32 if dtype == "fp32" else jnp.bfloat16, **TINY)
    tcfg = SepformerConfig(variant=mv, add_se=add_se, ce=ce, num_tf_layers=layers, num_spks=spks,
                           compute_dtype=torch.float32 if dtype == "fp32" else torch.bfloat16, **TINY)
    return tv, ce, jcfg, tcfg


@functools.cache
def _case(case):
    """Flax model, params (numpy) and the numpy batch, from seed 0."""
    rng = np.random.default_rng(0)
    tv, _, jcfg, _ = _cfgs(case)
    batch = {"mixed": rng.standard_normal((B, T)).astype(np.float32),
             "gt": rng.standard_normal((B, T)).astype(np.float32),
             "ctx_feat": rng.standard_normal((B, 1, 24)).astype(np.float32)}
    kw = {}
    if tv in ("contsep", "base"):
        batch["noises"] = rng.standard_normal((B, T, jcfg.num_spks - 1)).astype(np.float32)
    if tv == "hcontext":
        batch["se"] = rng.standard_normal((B, 1, 12)).astype(np.float32)
        kw = dict(se=jnp.asarray(batch["se"]), cue_index=jnp.asarray(0))
    model = JaxSepformer(jcfg)
    args = (jnp.asarray(batch["mixed"]),) if tv == "base" else (jnp.asarray(batch["mixed"]), jnp.asarray(batch["ctx_feat"]))
    params = model.init(jax.random.key(0), *args, **kw)
    out = model.apply(params, *args, **kw)
    est = np.asarray(out[0] if isinstance(out, tuple) else out)[:, :, 0]
    conditioned = dict(batch, gt=(est + 0.5 * est.std() * rng.standard_normal(est.shape)).astype(np.float32))
    return model, jax.tree.map(np.asarray, params), batch, conditioned


@functools.cache
def _jax_loss_grads(case, fused):
    model, params, _, batch = _case(case)
    tv, ce, _, _ = _cfgs(case)
    fn = jstep.make_loss_fn(model, jstep.TrainConfig(variant=tv, use_ce=ce), fused=fused)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    orig = jstep._sample_cue
    jstep._sample_cue = lambda rng: jnp.asarray(HCONTEXT_CUE)
    try:
        (loss, _), grads = jax.value_and_grad(lambda p: fn(p, jb, jax.random.key(1)), has_aux=True)(
            jax.tree.map(jnp.asarray, params))
    finally:
        jstep._sample_cue = orig
    return float(loss), {k: v.numpy() for k, v in jax_params_to_state_dict(grads).items()}


def _port_model(case, dtype="fp32"):
    params = _case(case)[1]
    return load_jax_params(Sepformer(_cfgs(case, dtype)[3]), params)


def _port_loss_grads(case, monkeypatch):
    _, _, _, batch = _case(case)
    tv, ce, _, _ = _cfgs(case)
    monkeypatch.setattr(tstep, "_sample_cue", lambda generator=None: HCONTEXT_CUE)
    model = _port_model(case)
    fn = tstep.make_loss_fn(model, tstep.TrainConfig(variant=tv, use_ce=ce), fused=True)
    loss, metrics = fn({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), {k: p.grad.numpy() for k, p in model.named_parameters()}, metrics


def _check(got, want):
    (gl, gg), (wl, wg) = got, want
    np.testing.assert_allclose(gl, wl, **TOL)
    assert set(gg) == set(wg)
    for k in wg:
        np.testing.assert_allclose(gg[k], wg[k], err_msg=k, **TOL)


@pytest.mark.parametrize("fused", [True, False], ids=["jax-fused", "jax-xla"])
def test_context_fused_loss_and_grads_match_jax(fused, monkeypatch):
    loss, grads, metrics = _port_loss_grads("context", monkeypatch)
    _check((loss, grads), _jax_loss_grads("context", fused))
    assert set(metrics) == {"snr_loss"}


@pytest.mark.parametrize("case", ["contsep-ce", "contsep-bce", "base", "hcontext", "contsep-ce-3spk", "base-3spk"])
def test_other_variants_fused_loss_and_grads_match_jax(case, monkeypatch):
    loss, grads, metrics = _port_loss_grads(case, monkeypatch)
    _check((loss, grads), _jax_loss_grads(case, False))
    if case.startswith("contsep"):
        assert set(metrics) == {"snr_loss", "ctx_loss", "ctx_acc"}


def _jax_tx():
    return jax_build_optimizer(jax_cosine(1e-3, 100, 1))


@functools.cache
def _jax_two_steps():
    model, params, _, batch = _case("context")
    tx = _jax_tx()
    step = jstep.make_train_step(model, tx, jstep.TrainConfig(variant="context"), fused=False)
    p = jax.tree.map(jnp.asarray, params)
    opt = tx.init(p)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    for i in range(2):
        p, opt, m = step(p, opt, jb, jax.random.key(1 + i))
        metrics.append({k: float(v) for k, v in m.items()})
    return {k: v.numpy() for k, v in jax_params_to_state_dict(p).items()}, metrics


def test_train_step_updated_params_match_jax():
    """Two steps (the first at lr 0, as the schedule's count 0 gives) of the
    port's fused step against JAX's: updated parameters and metrics."""
    want, want_metrics = _jax_two_steps()
    _, _, _, batch = _case("context")
    model = _port_model("context")
    step = tstep.make_train_step(model, build_optimizer(cosine_warmup_schedule(1e-3, 100, 1)),
                                 tstep.TrainConfig(variant="context"), fused=True, device="cpu")
    got_metrics = [step(batch) for _ in range(2)]
    for g, w in zip(got_metrics, want_metrics):
        assert set(g) == set(w) == {"loss", "grad_norm", "snr_loss"}
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=5e-3, err_msg=k)
    assert step.opt_state.count == 2 and step.opt_state.lr_count == 2
    got = {k: p.detach().numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    start = {k: v.numpy() for k, v in jax_params_to_state_dict(_case("context")[1]).items()}
    D = TINY["d_model"]
    for k in want:
        g, w = got[k], want[k]
        if k.endswith("in_proj.bias"):
            # the key bias shifts every score of a row alike, so softmax makes
            # its gradient zero up to rounding noise, and AdamW turns that
            # noise into a step of either sign: only its size, lr, is fixed
            assert np.abs(g[D : 2 * D] - start[k][D : 2 * D]).max() <= 1.01e-3, k
            g, w = np.delete(g, np.s_[D : 2 * D]), np.delete(w, np.s_[D : 2 * D])
        np.testing.assert_allclose(g, w, err_msg=k, **TOL)
    assert all(not np.array_equal(got[k], start[k]) for k in ("encoder.weight", "decoder.weight"))


def test_fused_bf16_trajectory_tracks_jax_50_steps():
    """50 bf16 steps on one batch: the port's fused step against JAX's XLA
    step, max relative deviation < 5e-2, both curves descend."""
    model, params, batch, _ = _case("context")
    jcfg = _cfgs("context", "bf16")[2]
    jmodel = JaxSepformer(jcfg)
    tx = jax_build_optimizer(jax_cosine(1e-3, 1000, 10))
    jst = jstep.make_train_step(jmodel, tx, jstep.TrainConfig(variant="context"), fused=False)
    p = jax.tree.map(jnp.asarray, params)
    opt = tx.init(p)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tmodel = _port_model("context", "bf16")
    tst = tstep.make_train_step(tmodel, build_optimizer(cosine_warmup_schedule(1e-3, 1000, 10)),
                                tstep.TrainConfig(variant="context"), fused=True, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    xla, fus = [], []
    for i in range(50):
        p, opt, m = jst(p, opt, jb, jax.random.key(1 + i))
        xla.append(float(m["loss"]))
        fus.append(tst(tb)["loss"])
    xla, fus = np.asarray(xla), np.asarray(fus)
    assert np.isfinite(xla).all() and np.isfinite(fus).all()
    dev = np.abs(xla - fus) / (1.0 + np.abs(xla))
    assert dev.max() < 5e-2, (dev.max(), dev.argmax())
    assert xla[-5:].mean() < 0.5 * xla[:5].mean()
    assert fus[-5:].mean() < 0.5 * fus[:5].mean()


def test_train_step_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        tstep.make_train_step(_port_model("context"), build_optimizer(1e-3), tstep.TrainConfig())


def test_eval_step_picks_streams(monkeypatch):
    """Fused eval matches the plain eval: contsep through the selector, base
    through the oracle stream, context stream 0."""
    for case in ("contsep-ce", "base", "context"):
        _, _, _, batch = _case(case)
        tv, ce, _, _ = _cfgs(case)
        model = _port_model(case)
        cfg = tstep.TrainConfig(variant=tv, use_ce=ce)
        (a, aux_a), (b, aux_b) = (tstep.make_eval_step(model, cfg, fused=f, device="cpu")(batch)
                                  for f in (True, False))
        assert a.shape == (B, T)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
        assert set(aux_a) == set(aux_b)


def test_cue_draw_covers_the_three_cues():
    g = torch.Generator().manual_seed(0)
    cues = [tstep._sample_cue(g) for _ in range(400)]
    freq = np.bincount(cues, minlength=3) / len(cues)
    assert abs(freq[0] - 0.3) < 0.08 and abs(freq[1] - 0.35) < 0.08 and abs(freq[2] - 0.35) < 0.08


def test_serving_engine_has_no_graph_and_train_forward_has_one():
    from cse_tpu_torch.serving import ServingEngine, sepformer_fused_forward

    _, params, batch, _ = _case("context")
    cfg = _cfgs("context")[3]
    mix, ctx = torch.from_numpy(batch["mixed"]), torch.from_numpy(batch["ctx_feat"])
    out = ServingEngine(cfg, params, device="cpu")(mix, ctx)
    assert not out.requires_grad
    model = _port_model("context")
    est = sepformer_fused_forward(model, mix, ctx, train=True)
    assert est.requires_grad and est.grad_fn is not None
    est.sum().backward()
    assert all(p.grad is not None for p in model.masknet.dual_mdl[0].intra_mdl.parameters())
    tft.reset_launches()
