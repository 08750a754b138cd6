"""cse_tpu_torch serving path and plain Sepformer against the JAX package.

Weights go across through cse_tpu_torch.compat.jax_params (strict load);
inputs are made with numpy from a seed and fed to both. TINY config and the
2e-4 fp32 tolerance are those of tests/test_serving.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cse_tpu.models import Sepformer as JaxSepformer
from cse_tpu.models import SepformerConfig as JaxConfig
from cse_tpu.serving import sepformer_fused_forward as jax_fused_forward
from cse_tpu_torch.compat.jax_params import jax_params_to_state_dict, load_jax_params
from cse_tpu_torch.core.device import resolve_device
from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig
from cse_tpu_torch.ops import fused_stack as fs
from cse_tpu_torch.serving import ServingEngine, sepformer_fused_forward

torch.set_num_threads(1)

TINY = dict(
    enc_channels=16, enc_kernel=8, enc_stride=4, d_model=16, nhead=4, d_ffn=32,
    num_tf_layers=2, num_dp_layers=2, chunk_size=10, llm_dim=24, se_dim=12,
    pe_max_len=256,
)
TOL = dict(rtol=2e-4, atol=2e-4)
# (variant, add_se, ce, cue, speakers): cue is the H-ContExt cue index (None
# elsewhere); the three-speaker forms are the JAX suite's num_spks=3
# (tests/test_model_parity.py)
CASES = [
    ("base", False, True, None, 2),
    ("context", False, True, None, 2),
    ("contsep", False, True, None, 2),
    ("contsep", False, False, None, 2),
    ("context", True, True, 0, 2),
    ("context", True, True, 1, 2),
    ("context", True, True, 2, 2),
    ("base", False, True, None, 3),
    ("contsep", False, True, None, 3),
    ("contsep", False, False, None, 3),
]
IDS = ["base", "context", "contsep-ce", "contsep-bce", "hcontext-cue0", "hcontext-cue1", "hcontext-cue2",
       "base-3spk", "contsep-ce-3spk", "contsep-bce-3spk"]


@functools.cache
def _jax_case(variant, add_se, ce, spks=2):
    """Flax model, its params (as numpy) and the numpy inputs, from seed 0."""
    rng = np.random.default_rng(0)
    cfg = JaxConfig(variant=variant, add_se=add_se, ce=ce, num_spks=spks, compute_dtype=jnp.float32, **TINY)
    model = JaxSepformer(cfg)
    inputs = {
        "mix": rng.standard_normal((2, 300)).astype(np.float32),
        "ctx": rng.standard_normal((2, 1, 24)).astype(np.float32),
        "se": rng.standard_normal((2, 1, 12)).astype(np.float32),
    }
    kw = {} if variant == "base" else {"ctx": inputs["ctx"]}
    if add_se:
        kw.update(se=inputs["se"], cue_index=jnp.asarray(0))
    params = model.init(jax.random.key(0), inputs["mix"], **kw)
    return model, jax.tree_util.tree_map(np.asarray, params), inputs


@functools.cache
def _jax_ref(variant, add_se, ce, cue, spks=2):
    model, params, inputs = _jax_case(variant, add_se, ce, spks)
    kw = _kwargs(variant, add_se, cue, inputs, jnp.asarray)
    if add_se:
        kw["cue_index"] = jnp.asarray(cue)
    out = model.apply(params, inputs["mix"], **kw)
    return tuple(np.asarray(o) for o in (out if variant == "contsep" else (out,)))


def _kwargs(variant, add_se, cue, inputs, conv):
    kw = {} if variant == "base" else {"ctx": conv(inputs["ctx"])}
    if add_se:
        kw.update(se=conv(inputs["se"]), cue_index=cue)
    return kw


def _port_cfg(variant, add_se, ce, spks=2):
    return SepformerConfig(variant=variant, add_se=add_se, ce=ce, num_spks=spks, **TINY)


def _port_model(variant, add_se, ce, spks=2):
    _, params, _ = _jax_case(variant, add_se, ce, spks)
    return load_jax_params(Sepformer(_port_cfg(variant, add_se, ce, spks)), params)


def _check(got, want):
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 or g.ndim == 2
        np.testing.assert_allclose(g.detach().numpy(), w, **TOL)


@pytest.mark.parametrize("variant,add_se,ce,cue,spks", CASES, ids=IDS)
def test_plain_sepformer_matches_apply(variant, add_se, ce, cue, spks):
    _, _, inputs = _jax_case(variant, add_se, ce, spks)
    model = _port_model(variant, add_se, ce, spks)
    with torch.no_grad():
        got = model(torch.from_numpy(inputs["mix"]),
                    **_kwargs(variant, add_se, cue, inputs, torch.from_numpy))
    _check(got, _jax_ref(variant, add_se, ce, cue, spks))


@pytest.mark.parametrize("variant,add_se,ce,cue,spks", CASES, ids=IDS)
def test_fused_forward_matches_apply(variant, add_se, ce, cue, spks):
    _, _, inputs = _jax_case(variant, add_se, ce, spks)
    got = sepformer_fused_forward(
        _port_model(variant, add_se, ce, spks), torch.from_numpy(inputs["mix"]),
        **_kwargs(variant, add_se, cue, inputs, torch.from_numpy),
    )
    _check(got, _jax_ref(variant, add_se, ce, cue, spks))


@pytest.mark.parametrize("variant,add_se,ce,cue,spks", CASES, ids=IDS)
def test_engine_cpu_matches_apply(variant, add_se, ce, cue, spks):
    """ServingEngine from the flax param tree itself, numpy inputs."""
    _, params, inputs = _jax_case(variant, add_se, ce, spks)
    engine = ServingEngine(_port_cfg(variant, add_se, ce, spks), params, device="cpu")
    got = engine(inputs["mix"], **_kwargs(variant, add_se, cue, inputs, np.asarray))
    _check(got, _jax_ref(variant, add_se, ce, cue, spks))


def test_engine_per_example_cues():
    """A [B] cue vector picks each example's cue, as Sepformer.apply does."""
    model, params, inputs = _jax_case("context", True, True)
    cues = np.array([2, 0])
    want = np.asarray(model.apply(params, inputs["mix"], inputs["ctx"], se=inputs["se"],
                                  cue_index=jnp.asarray(cues)))
    engine = ServingEngine(_port_cfg("context", True, True), _port_model("context", True, True),
                           device="cpu")
    got = engine(inputs["mix"], inputs["ctx"], se=inputs["se"], cue_index=torch.from_numpy(cues))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_context_matches_jax_fused_forward_interpret():
    """Against the JAX serving path itself (Pallas stack in interpret mode)."""
    _, params, inputs = _jax_case("context", False, True)
    jcfg = JaxConfig(variant="context", compute_dtype=jnp.float32, **TINY)
    want = np.asarray(jax_fused_forward(params, jcfg, jnp.asarray(inputs["mix"]),
                                        ctx=jnp.asarray(inputs["ctx"])))
    got = sepformer_fused_forward(_port_model("context", False, True),
                                  torch.from_numpy(inputs["mix"]), ctx=torch.from_numpy(inputs["ctx"]))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bf16_engine_runs_close():
    """bf16 compute on the CPU path: finite, right shape, and within the bf16
    serving bar (relative L2 <= 5e-2) of the fp32 reference."""
    _, params, inputs = _jax_case("context", False, True)
    cfg = SepformerConfig(variant="context", compute_dtype=torch.bfloat16, **TINY)
    got = ServingEngine(cfg, params, device="cpu")(inputs["mix"], inputs["ctx"]).numpy()
    want = _jax_ref("context", False, True, None)[0]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 5e-2


def test_fused_forward_counts_no_launch_on_cpu():
    _, _, inputs = _jax_case("context", False, True)
    fs.reset_launches()
    sepformer_fused_forward(_port_model("context", False, True), torch.from_numpy(inputs["mix"]),
                            ctx=torch.from_numpy(inputs["ctx"]))
    assert sum(fs.launch_counts().values()) == 0


def test_strict_load_rejects_missing_and_unexpected_keys():
    _, params, _ = _jax_case("context", False, True)
    sd = jax_params_to_state_dict(params)
    assert set(sd) == set(Sepformer(_port_cfg("context", False, True)).state_dict())
    p = {k: v for k, v in params["params"].items() if k != "decoder"}
    with pytest.raises(RuntimeError, match="decoder"):
        load_jax_params(Sepformer(_port_cfg("context", False, True)), p)
    with pytest.raises(RuntimeError, match="context_mapper"):
        load_jax_params(Sepformer(_port_cfg("base", False, True)), params)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    _, params, _ = _jax_case("context", False, True)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(_port_cfg("context", False, True), params)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
