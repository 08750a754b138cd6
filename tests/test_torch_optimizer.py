"""cse_tpu_torch.train.optimizer / schedules against cse_tpu's optax chain.

Same seeded numpy parameters and gradients go through both; fp32 updates
match to rel 1e-6 (only the order of the global-norm sum differs)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cse_tpu.train import optimizer as jopt
from cse_tpu.train import schedules as jsch
from cse_tpu_torch.train import optimizer as topt
from cse_tpu_torch.train import schedules as tsch

torch.set_num_threads(1)
SHAPES = {"a": (7, 5), "b": (5,), "c": (3, 4, 2)}
TOL = dict(rtol=1e-6, atol=1e-9)


def _params(rng):
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(rng, n, scale=1.0):
    """n gradient sets; every other one has a global norm above the clip of 5."""
    return [{k: (scale * (20.0 if i % 2 else 0.3) * rng.standard_normal(s)).astype(np.float32)
             for k, s in SHAPES.items()} for i in range(n)]


def _run_both(params, grads_seq, update_frequency=1, plateau_at=None):
    sched = (jsch.cosine_warmup_schedule(1e-2, 100, 3), tsch.cosine_warmup_schedule(1e-2, 100, 3))
    tx = jopt.build_optimizer(sched[0], update_frequency=update_frequency)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    opt = topt.build_optimizer(sched[1], update_frequency=update_frequency)
    tp = [torch.from_numpy(params[k].copy()) for k in SHAPES]
    ts = opt.init(tp)
    for i, g in enumerate(grads_seq):
        if plateau_at is not None and i == plateau_at:
            js = jopt.set_plateau_scale(js, 0.5)
            topt.set_plateau_scale(ts, 0.5)
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, [torch.from_numpy(g[k]) for k in SHAPES], ts)
        for k, t in zip(SHAPES, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), err_msg=f"step {i} {k}", **TOL)
    return js, ts, jp, tp


def test_six_steps_match_optax(rng):
    params = _params(rng)
    _, ts, jp, tp = _run_both(params, _grads(rng, 6))
    assert ts.count == 6 and ts.lr_count == 6
    assert not np.allclose(tp[0].numpy(), params["a"])  # the params moved


def test_non_finite_step_is_skipped(rng):
    params = _params(rng)
    grads = _grads(rng, 5)
    grads[2]["b"][1] = np.nan
    grads[3]["c"][0, 0, 0] = np.inf
    js, ts, _, _ = _run_both(params, grads)
    inner = js.inner_state
    assert ts.count == int(inner[1].count) == 3
    assert ts.lr_count == int(inner[3].count) == 3
    assert ts.total_notfinite == int(js.total_notfinite) == 2
    assert ts.notfinite_count == int(js.notfinite_count) == 0 and ts.last_finite


def test_skipped_step_leaves_params_and_counts(rng):
    params = _params(rng)
    opt = topt.build_optimizer(1e-2)
    tp = [torch.from_numpy(params[k].copy()) for k in SHAPES]
    ts = opt.init(tp)
    g = [torch.full(SHAPES[k], float("nan")) for k in SHAPES]
    assert opt.step(tp, g, ts) is False
    for k, t in zip(SHAPES, tp):
        np.testing.assert_array_equal(t.numpy(), params[k])
    assert (ts.count, ts.lr_count, ts.notfinite_count, ts.last_finite) == (0, 0, 1, False)
    assert all(float(m.abs().sum()) == 0 for m in ts.mu + ts.nu + ts.nu_max)


def test_plateau_scale_takes_effect(rng):
    params = _params(rng)
    js, ts, _, _ = _run_both(params, _grads(rng, 4), plateau_at=2)
    assert topt.get_plateau_scale(ts) == jopt.get_plateau_scale(js) == 0.5


def test_update_frequency_two_matches(rng):
    params = _params(rng)
    js, ts, _, _ = _run_both(params, _grads(rng, 6), update_frequency=2)
    assert ts.count == 3 and ts.gradient_step == int(js.gradient_step) == 3
    assert ts.mini_step == int(js.mini_step) == 0


@pytest.mark.parametrize("count", [0, 1, 10, 11, 50, 1000])
def test_schedules_match(count):
    total, warmup, lr = 1000, 10, 1.5e-4
    j = float(jsch.cosine_warmup_schedule(lr, total, warmup)(jnp.asarray(count, jnp.int32)))
    t = tsch.cosine_warmup_schedule(lr, total, warmup)(count)
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
    j = float(jsch.linear_warmup_schedule(lr, warmup)(jnp.asarray(count, jnp.int32)))
    np.testing.assert_allclose(tsch.linear_warmup_schedule(lr, warmup)(count), j, rtol=1e-6, atol=0)
    if count == 0:
        assert t == 0.0  # the first update runs at lr 0


def test_reduce_lr_on_plateau_matches():
    a, b = jsch.ReduceLROnPlateau(), tsch.ReduceLROnPlateau()
    for m in [1.0, 2.0, 2.0001, 1.5, 1.9, 1.9, 1.9, 1.9, 1.9, 3.0, 2.0]:
        assert a.step(m) == b.step(m)
    assert b.state_dict() == a.state_dict()
