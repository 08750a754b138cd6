"""Released PyTorch checkpoints across the two packages, on the CPU.

cse_tpu's ``save_torch_checkpoint`` of random flax params, loaded by the
port: the plain forward matches ``Sepformer.apply`` on the same params
within 2e-4 (ROADMAP queue 1, item 2), every variant. The port's
``save_torch_checkpoint``, read back by cse_tpu's importer, gives the flax
tree that ``compat.jax_params`` carried in, exactly. And the warm start of
the port's trainer from such a file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cse_tpu.compat.torch_export import save_torch_checkpoint as jax_save_torch_checkpoint
from cse_tpu.compat.torch_import import infer_reference_config as jax_infer_reference_config
from cse_tpu.compat.torch_import import load_torch_checkpoint as jax_load_torch_checkpoint
from cse_tpu.compat.torch_import import sepformer_from_state_dict as jax_sepformer_from_state_dict
from cse_tpu.models import Sepformer as JaxSepformer
from cse_tpu.models import SepformerConfig as JaxSepformerConfig
from cse_tpu_torch.compat.jax_params import load_jax_params
from cse_tpu_torch.compat.torch_export import save_torch_checkpoint, sepformer_to_state_dict
from cse_tpu_torch.compat.torch_import import (
    infer_reference_config,
    load_torch_checkpoint,
    sepformer_from_state_dict,
)
from cse_tpu_torch.core.cli import TINY_MODEL
from cse_tpu_torch.core.flags import parse_train_args
from cse_tpu_torch.models import Sepformer, SepformerConfig
from cse_tpu_torch.train import checkpoint as ckpt_lib
from cse_tpu_torch.train.loop import train_net

torch.set_num_threads(1)

# tests/test_torch_export.py's widths
TINY = dict(
    enc_channels=16, enc_kernel=8, enc_stride=4, d_model=16, nhead=4, d_ffn=32,
    num_tf_layers=2, num_dp_layers=2, chunk_size=10, llm_dim=24, se_dim=12,
    pe_max_len=256,
)
VARIANTS = {
    "base": dict(variant="base"),
    "context": dict(variant="context"),
    "contsep_ce": dict(variant="contsep", ce=True),
    "contsep_bce": dict(variant="contsep", ce=False),
    "hcontext": dict(variant="context", add_se=True),
}
FWD_TOL = 2e-4


def _inputs(kw):
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((2, 400)).astype(np.float32)
    ctx = rng.standard_normal((2, 1, 24)).astype(np.float32)
    se = rng.standard_normal((2, 1, 12)).astype(np.float32)
    args = () if kw["variant"] == "base" else (ctx,)
    extra = dict(se=se, cue_index=0) if kw.get("add_se") else {}
    return mix, args, extra


def _jax_params(kw):
    model = JaxSepformer(JaxSepformerConfig(**kw, **TINY))
    mix, args, extra = _inputs(kw)
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    params = model.init(jax.random.key(0), jnp.asarray(mix), *map(jnp.asarray, args), **jextra)
    return model, params, jextra


def _outputs(out):
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_released_checkpoint_from_jax_loads_and_matches_apply(tmp_path, name):
    kw = VARIANTS[name]
    jmodel, params, jextra = _jax_params(kw)
    path = str(tmp_path / "released.ckpt")
    jax_save_torch_checkpoint(path, params, step=7, epoch=2)

    restored = ckpt_lib.restore_checkpoint(path)
    assert restored["step"] == 7 and restored["epoch"] == 2
    cfg = infer_reference_config(restored["state_dict"])
    assert cfg == jax_infer_reference_config(jax_load_torch_checkpoint(path)["state_dict"])
    assert (cfg["variant"], cfg["add_se"], cfg["num_dp_layers"], cfg["num_tf_layers"]) == (
        kw["variant"], kw.get("add_se", False), 2, 2)
    model = Sepformer(SepformerConfig(**kw, **TINY))
    model.load_state_dict(sepformer_from_state_dict(restored["state_dict"], 2, 2), strict=True)

    mix, args, extra = _inputs(kw)
    want = _outputs(jmodel.apply(params, jnp.asarray(mix), *map(jnp.asarray, args), **jextra))
    with torch.no_grad():
        got = _outputs(model(torch.from_numpy(mix), *map(torch.from_numpy, args),
                             **{k: torch.from_numpy(v) if k == "se" else v for k, v in extra.items()}))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=FWD_TOL)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_port_export_reads_back_through_jax_exactly(tmp_path, name):
    kw = VARIANTS[name]
    _, params, _ = _jax_params(kw)
    host = jax.tree.map(np.asarray, params)
    model = load_jax_params(Sepformer(SepformerConfig(**kw, **TINY)), host)
    path = str(tmp_path / "export.ckpt")
    save_torch_checkpoint(path, model, step=3, epoch=1)

    blob = jax_load_torch_checkpoint(path)
    assert blob["step"] == 3 and blob["epoch"] == 1
    back = jax_sepformer_from_state_dict(blob["state_dict"], num_dp_layers=2, num_tf_layers=2)
    want = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(host)}
    got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(back)}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=0, err_msg=k)
    assert jax_infer_reference_config(blob["state_dict"]) == infer_reference_config(
        sepformer_to_state_dict(model))


def test_restore_accepts_released_forms_and_refuses_foreign_files(tmp_path):
    model = Sepformer(SepformerConfig(variant="context", **TINY), generator=torch.Generator().manual_seed(1))
    sd = sepformer_to_state_dict(model)
    bare = str(tmp_path / "bare.ckpt")
    torch.save(sd, bare)  # a bare state_dict is a released form too
    got = ckpt_lib.restore_checkpoint(bare)
    assert set(got["state_dict"]) == set(sd)
    assert all(torch.equal(got["state_dict"][k], v) for k, v in sd.items())
    assert load_torch_checkpoint(bare)["state_dict"].keys() == sd.keys()

    foreign = str(tmp_path / "foreign.ckpt")
    torch.save({"weights": {"w": torch.zeros(2)}, "step": 1}, foreign)
    with pytest.raises(ValueError, match="neither"):
        ckpt_lib.restore_checkpoint(foreign)
    with pytest.raises(ValueError, match="not a released"):
        load_torch_checkpoint(foreign)
    # a key the model needs is missing: the mapping raises, the load stays strict
    with pytest.raises(KeyError, match="masknet.prelu.weight"):
        sepformer_from_state_dict({k: v for k, v in sd.items() if k != "masknet.prelu.weight"}, 2, 2)


BASE = ["--synthetic_smoke", "--platform", "cpu", "--debug_tiny_model", "--train_data", "dailytalk",
        "--batch_size", "2", "--eval_step", "1000", "--max_sp_len", "2", "--max_ctx_tokens", "16",
        "--workers", "2", "--log_every", "10"]


def test_train_net_warm_starts_from_a_released_checkpoint(tmp_path, monkeypatch, capsys):
    """--checkpoint <released> --from_ckpt takes step and epoch from the file,
    and the first update runs on fresh optimizer moments: it equals the update
    of a weights-only warm start at the same epoch."""
    model = Sepformer(SepformerConfig(variant="context", **TINY_MODEL), generator=torch.Generator().manual_seed(3))
    released = str(tmp_path / "released.ckpt")
    save_torch_checkpoint(released, model, step=5, epoch=1)

    def no_moments(*a, **k):
        raise AssertionError("a released checkpoint has no optimizer moments to load")

    monkeypatch.setattr(ckpt_lib, "load_opt_state", no_moments)
    stats = {}
    # --tot_iters 5 from step 5: the stop rule ends the run after one update
    a = train_net(parse_train_args(BASE + ["--checkpoint", released, "--from_ckpt", "--tot_iters", "5",
                                           "--checkpoint_dir", str(tmp_path / "a")]), "context", stats=stats)
    assert stats["start_step"] == 5 and stats["final_step"] == 6
    assert "starting at step 5, epoch 1" in capsys.readouterr().out
    b = train_net(parse_train_args(BASE + ["--checkpoint", released, "--start_epoch", "1", "--tot_iters", "0",
                                           "--checkpoint_dir", str(tmp_path / "b")]), "context")
    assert "starting at step 0, epoch 1" in capsys.readouterr().out
    moved = 0
    for (k, pa), pb, p0 in zip(a.named_parameters(), b.parameters(), model.parameters()):
        assert torch.equal(pa, pb), k
        moved += not torch.equal(pa, p0)
    assert moved > 0  # the update did change the weights
