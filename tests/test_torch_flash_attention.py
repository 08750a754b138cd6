"""cse_tpu_torch.ops.attention and the flash-attention model path against the
JAX package (Pallas kernels in interpret mode on the CPU).

Op bars are those of tests/test_attention.py: forward 2e-5, gradients 1e-4
(fp32); bf16 inputs round the same values at the same places and differ in
summation order only, so relative L2 <= 1e-2. Model bars: forward 2e-4
(tests/test_serving.py); loss and gradients rtol 5e-3, atol 1e-4, the key
bias left out (tests/test_torch_train_step.py). Inputs are numpy from a seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cse_tpu.train.step as jstep
import cse_tpu_torch.models.sepformer as tsep
import cse_tpu_torch.train.step as tstep
from cse_tpu.models import Sepformer as JaxSepformer
from cse_tpu.models import SepformerConfig as JaxConfig
from cse_tpu.ops.attention import _flash_fwd_impl
from cse_tpu.ops.attention import flash_mhsa as jax_flash_mhsa
from cse_tpu_torch.compat.jax_params import jax_params_to_state_dict, load_jax_params
from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig
from cse_tpu_torch.ops import attention as at
from cse_tpu_torch.ops.fused_train import qv_part

torch.set_num_threads(1)

TINY = dict(num_spks=2, enc_channels=32, enc_kernel=8, enc_stride=4, d_model=32, nhead=4, d_ffn=64,
            num_tf_layers=2, num_dp_layers=1, chunk_size=16, llm_dim=24, se_dim=12, pe_max_len=256,
            variant="context")
B, T = 2, 400
REMATS = [None, "layer", "block", "nested"]


def _qkv(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(3)]


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


# ---------------------------------------------------------------- the op


@pytest.mark.parametrize("L", [17, 128, 130])
def test_forward_and_lse_match_jax(L):
    q, k, v = _qkv(L, (2, 2, L, 32))
    want = np.asarray(jax_flash_mhsa(*map(jnp.asarray, (q, k, v))))
    Lp = -(-L // 128) * 128
    pad = [(0, 0), (0, 0), (0, Lp - L), (0, 0)]
    _, want_lse = _flash_fwd_impl(*(jnp.pad(jnp.asarray(t), pad) for t in (q, k, v)), L)
    o, lse = at.flash_fwd(*map(_torch, (q, k, v)))
    assert o.dtype == torch.float32 and o.shape == (2, 2, L, 32)
    np.testing.assert_allclose(o.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, :, :L, 0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(at.flash_mhsa(*map(_torch, (q, k, v))).numpy(), want, rtol=2e-5, atol=2e-5)


def _jax_grads(q, k, v, dtype):
    args = [jnp.asarray(t, dtype) for t in (q, k, v)]
    return jax.grad(lambda q, k, v: jnp.sum(jax_flash_mhsa(q, k, v).astype(jnp.float32) ** 2),
                    argnums=(0, 1, 2))(*args)


def _port_grads(q, k, v, dtype):
    ts = [_torch(t, dtype).requires_grad_(True) for t in (q, k, v)]
    at.flash_mhsa(*ts).float().square().sum().backward()
    return [t.grad for t in ts]


def test_grads_match_jax():
    q, k, v = _qkv(0, (1, 2, 30, 16))
    for got, want in zip(_port_grads(q, k, v, torch.float32), _jax_grads(q, k, v, jnp.float32)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("L", [30, 130])
def test_head_width_4_forward_and_grads_match_jax(L):
    """The JAX suite's head width (d_model 16, 4 heads): forward and gradients."""
    q, k, v = _qkv(3, (2, 2, L, 4))
    want = np.asarray(jax_flash_mhsa(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(at.flash_mhsa(*map(_torch, (q, k, v))).numpy(), want, rtol=2e-5, atol=2e-5)
    for got, want in zip(_port_grads(q, k, v, torch.float32), _jax_grads(q, k, v, jnp.float32)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_bf16_forward_and_grads_match_jax():
    q, k, v = _qkv(1, (2, 2, 130, 32))
    want = jax_flash_mhsa(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)))
    got = at.flash_mhsa(*(_torch(t, torch.bfloat16) for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    assert _rel_l2(got.float().numpy(), np.asarray(want, np.float32)) <= 1e-2
    q, k, v = _qkv(2, (1, 2, 30, 16))
    for g, w in zip(_port_grads(q, k, v, torch.bfloat16), _jax_grads(q, k, v, jnp.bfloat16)):
        assert g.dtype == torch.bfloat16
        assert _rel_l2(g.float().numpy(), np.asarray(w, np.float32)) <= 1e-2


@pytest.mark.parametrize("L", [1, 7, 33])
def test_plain_backward_matches_autograd(L):
    """flash_bwd_plain against autograd of an fp32 einsum softmax attention."""
    q, k, v = (_torch(t).requires_grad_(True) for t in _qkv(3, (2, 3, L, 16)))
    do = _torch(np.random.default_rng(4).standard_normal((2, 3, L, 16)).astype(np.float32))
    o = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) / 4.0, dim=-1) @ v
    o.backward(do)
    qd, kd, vd = (t.detach() for t in (q, k, v))
    o2, lse = at.flash_fwd_plain(qd, kd, vd)
    for got, t in zip(at.flash_bwd_plain(qd, kd, vd, o2, lse, do), (q, k, v)):
        np.testing.assert_allclose(got.numpy(), t.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_zero_do_rows_add_nothing():
    """Query rows whose do is 0 (the JAX wrapper's padded rows) change no
    gradient: the same dk, dv as the attention of the kept rows alone."""
    L, keep = 20, 13
    q, k, v = (_torch(t) for t in _qkv(5, (1, 2, L, 32)))
    do = _torch(np.random.default_rng(6).standard_normal((1, 2, L, 32)).astype(np.float32))
    do[:, :, keep:] = 0
    o, lse = at.flash_fwd_plain(q, k, v)
    dq, dk, dv = at.flash_bwd_plain(q, k, v, o, lse, do)
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    oref = torch.softmax(qr[:, :, :keep] @ kr.transpose(-1, -2) / 32 ** 0.5, dim=-1) @ vr
    oref.backward(do[:, :, :keep])
    np.testing.assert_allclose(dk.numpy(), kr.grad.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dv.numpy(), vr.grad.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dq[:, :, :keep].numpy(), qr.grad[:, :, :keep].numpy(), rtol=1e-5, atol=1e-5)
    assert not dq[:, :, keep:].any()


def test_backward_strip_bound_matches_the_source():
    """flash_bwd makes the delta scratch only for the routes whose C launcher
    needs it: the bf16 strip ends at the source's STRIP_MAX_L."""
    from cse_tpu_torch.ops import _build

    text = (_build.CSRC / "attention.cu").read_text()
    assert f"constexpr int STRIP_MAX_L = {at.STRIP_MAX_L};" in text
    assert "if (L <= STRIP_MAX_L) return bwd_strip_plan<DH, 16>();" in text


def test_wrappers_refuse_other_devices_and_count_no_cpu_launch():
    q = torch.empty(1, 2, 4, 16, device="meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        at.flash_fwd(q, q, q)
    at.reset_launches()
    q, k, v = (_torch(t).requires_grad_(True) for t in _qkv(7, (1, 2, 9, 16)))
    at.flash_mhsa(q, k, v).sum().backward()
    assert at.launch_counts() == {"flash_fwd": 0, "flash_bwd": 0}
    assert at.launches_per_step(32, True) == {"flash_fwd": 64, "flash_bwd": 32}
    assert at.launches_per_step(32, False, train=False) == {"flash_fwd": 32, "flash_bwd": 0}


# ---------------------------------------------------------------- the model


@functools.cache
def _case():
    """Flax params (numpy), the batch, and a gt near the model's own estimate
    (a random gt makes the SI-SNR a -40 dB cancellation)."""
    rng = np.random.default_rng(0)
    batch = {"mixed": rng.standard_normal((B, T)).astype(np.float32),
             "gt": rng.standard_normal((B, T)).astype(np.float32),
             "ctx_feat": rng.standard_normal((B, 1, 24)).astype(np.float32)}
    model = JaxSepformer(JaxConfig(compute_dtype=jnp.float32, **TINY))
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0), batch["mixed"], batch["ctx_feat"]))
    flash = JaxSepformer(JaxConfig(compute_dtype=jnp.float32, use_flash_attention=True, **TINY))
    est = np.asarray(jax.jit(flash.apply)(params, batch["mixed"], batch["ctx_feat"]))
    gt = est[:, :, 0] + 0.5 * est.std() * rng.standard_normal(est.shape[:2])
    return params, dict(batch, gt=gt.astype(np.float32)), est


@functools.cache
def _jax_loss_grads(remat):
    params, batch, _ = _case()
    model = JaxSepformer(JaxConfig(compute_dtype=jnp.float32, use_flash_attention=True,
                                   remat=remat or False, **TINY))
    fn = jstep.make_loss_fn(model, jstep.TrainConfig(variant="context"), fused=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(lambda p: fn(p, jb, jax.random.key(1)), has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    return float(loss), {k: v.numpy() for k, v in jax_params_to_state_dict(grads).items()}


def _port_model(**kw):
    return load_jax_params(Sepformer(SepformerConfig(**{**TINY, **kw})), _case()[0])


@functools.cache
def _port_loss_grads(remat, flash=True):
    _, batch, _ = _case()
    model = _port_model(use_flash_attention=flash, remat=remat)
    loss, _ = tstep.make_loss_fn(model, tstep.TrainConfig(variant="context"))(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()}


def test_model_forward_matches_jax_flash_apply():
    _, batch, _ = _case()
    model = _port_model(use_flash_attention=True)
    with torch.no_grad():
        got = model(torch.from_numpy(batch["mixed"]), torch.from_numpy(batch["ctx_feat"]))
    np.testing.assert_allclose(got.numpy(), _case()[2], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("remat", REMATS, ids=[str(r) for r in REMATS])
def test_loss_and_grads_match_jax(remat):
    loss, grads = _port_loss_grads(remat)
    wloss, wgrads = _jax_loss_grads(remat)
    np.testing.assert_allclose(loss, wloss, rtol=5e-3, atol=1e-4)
    assert set(grads) == set(wgrads)
    for k, w in wgrads.items():
        g = grads[k].numpy()
        if k.endswith("in_proj.bias"):
            g, w = qv_part(torch.from_numpy(g)).numpy(), qv_part(torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(g, w, rtol=5e-3, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("remat", REMATS[1:])
def test_remat_changes_no_value(remat):
    loss, grads = _port_loss_grads(remat)
    loss0, grads0 = _port_loss_grads(None)
    assert abs(loss - loss0) <= 1e-6
    for k, g in grads0.items():
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_flash_flag_routes_to_flash_mhsa(monkeypatch):
    """An A == A comparison passes even if the flag is dropped: count calls."""
    calls = {"n": 0}
    real = tsep.flash_mhsa

    def counting(*a):
        calls["n"] += 1
        return real(*a)

    monkeypatch.setattr(tsep, "flash_mhsa", counting)
    _, batch, _ = _case()
    args = (torch.from_numpy(batch["mixed"]), torch.from_numpy(batch["ctx_feat"]))
    with torch.no_grad():
        _port_model()(*args)
        assert calls["n"] == 0
        _port_model(use_flash_attention=True)(*args)
    assert calls["n"] == 2 * TINY["num_dp_layers"] * TINY["num_tf_layers"]


def test_softmax_dtype_bf16_follows_jax():
    """softmax_dtype=bf16 on the non-flash path: cast, scale and softmax in
    bf16 as JAX does; both stay within the bf16 serving bar (5e-2) of each
    other and of the fp32 softmax."""
    params, batch, _ = _case()
    jm = JaxSepformer(JaxConfig(compute_dtype=jnp.float32, softmax_dtype=jnp.bfloat16, **TINY))
    want = np.asarray(jax.jit(jm.apply)(params, batch["mixed"], batch["ctx_feat"]))
    model = _port_model(softmax_dtype=torch.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(batch["mixed"]), torch.from_numpy(batch["ctx_feat"])).numpy()
    assert _rel_l2(got, want) <= 5e-2
    assert _rel_l2(got, _case()[2]) <= 5e-2


def test_config_checks_and_strict_load():
    with pytest.raises(ValueError, match="remat"):
        SepformerConfig(remat="chunk")
    params, _, _ = _case()
    sd = jax_params_to_state_dict(params)
    assert set(sd) == set(Sepformer(SepformerConfig(use_flash_attention=True, remat="nested", **TINY))
                          .state_dict())


def test_layer_by_layer_steps_run_flash_and_remat():
    """make_train_step / make_eval_step (fused=False) on the flash + remat
    model: the step's metrics equal the plain model's loss and the eval
    output the fused serving forward's."""
    _, batch, _ = _case()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    from cse_tpu_torch.train.optimizer import build_optimizer

    model = _port_model(use_flash_attention=True, remat="layer")
    step = tstep.make_train_step(model, build_optimizer(1e-3), tstep.TrainConfig(variant="context"),
                                 device="cpu")
    m = step(tb)
    assert np.isfinite(m["grad_norm"]) and abs(m["loss"] - _port_loss_grads(None, False)[0]) <= 1e-4
    model = _port_model(use_flash_attention=True, remat="layer")
    cfg = tstep.TrainConfig(variant="context")
    got, _ = tstep.make_eval_step(model, cfg, device="cpu")(tb)
    want, _ = tstep.make_eval_step(model, cfg, fused=True, device="cpu")(tb)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)
