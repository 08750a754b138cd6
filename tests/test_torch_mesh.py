"""cse_tpu_torch.core.mesh and the sharded train step on the CPU, the port's
counterpart of tests/test_multihost.py: two gloo processes rendezvous through
``distributed_init_if_needed`` on JAX's variables (COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES, JAX_PROCESS_ID), shard the train list, and take one step
of the tiny Sepformer of tests/test_multihost.py on different rows each.

Bars: the loss bit-equal on both ranks, and equal parameters after the step
(rank 1 starts from other weights, so this also proves the broadcast from
rank 0); loss and updated parameters within rtol 5e-3 / atol 1e-4 (the bar
of tests/test_torch_train_step.py) of JAX's ``make_train_step(mesh=
make_mesh(n_data=2))`` on the global batch, run here on the conftest's
virtual devices with the weights carried by ``compat/jax_params.py``; within
rtol 1e-5 of one port process's step on the global batch (the mean of two
one-row means against the mean of two rows: fp32 rounding only), leaving
out the key-bias third of each packed qkv bias, whose gradient is rounding
noise that Adam's first step scales to a full step
(``ops/fused_train.py::qv_part``, the repo's gradient comparisons). The
checkpoint contract of tests/test_multihost.py: rank 0 saves, barrier, both
restore, and the continuation equals the uncheckpointed one exactly. The two
children run under tests/torch_ranks.py's group deadline.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cse_tpu.train.step as jstep
import cse_tpu_torch.core.mesh as tmesh
from cse_tpu.core.mesh import make_mesh as jax_make_mesh
from cse_tpu.core.mesh import shard_batch as jax_shard_batch
from cse_tpu.models import Sepformer as JaxSepformer
from cse_tpu.models import SepformerConfig as JaxConfig
from cse_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from cse_tpu_torch.compat.jax_params import jax_params_to_state_dict, load_jax_params
from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig
from cse_tpu_torch.ops.fused_train import qv_part
from cse_tpu_torch.train.optimizer import build_optimizer
from cse_tpu_torch.train.step import TrainConfig, make_train_step
from torch_ranks import launch, tagged

torch.set_num_threads(1)

# tests/test_multihost.py's model
CFG = dict(variant="context", enc_channels=8, enc_kernel=8, enc_stride=4, d_model=8, nhead=2, d_ffn=16,
           num_tf_layers=1, num_dp_layers=1, chunk_size=8, llm_dim=8, pe_max_len=128)
LR = 1e-4
TOL = dict(rtol=5e-3, atol=1e-4)

CHILD = r"""
import itertools, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from cse_tpu_torch.core import mesh as M

joined = M.distributed_init_if_needed(device="cpu")
again = M.distributed_init_if_needed(device="cpu")  # a second call is a no-op
r, n = M.process_index(), M.process_count()
print("INIT", json.dumps([r, n, joined, again]), flush=True)

from cse_tpu_torch.data.pipeline import PipelineConfig, TrainLoader
from cse_tpu_torch.data.tokenizer import ByteTokenizer
def loader(n_files):
    return TrainLoader([f"f{i}.wav" for i in range(n_files)], PipelineConfig(max_sp_len=1), ByteTokenizer(),
                       "dailytalk", batch_size=1, num_workers=1, process_index=r, process_count=n, device="cpu")
ten = loader(10)
print("SHARD", json.dumps(sorted(ten.epoch_indices(0))), flush=True)
ten.close()

from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig
from cse_tpu_torch.train import checkpoint as ckpt_lib
from cse_tpu_torch.train.optimizer import build_optimizer
from cse_tpu_torch.train.step import TrainConfig, make_train_step

work, cfg, lr = sys.argv[1], SepformerConfig(**json.loads(sys.argv[2])), float(sys.argv[3])
data = np.load(os.path.join(work, "batch.npz"))
local = {k: torch.from_numpy(v[r:r + 1]) for k, v in data.items()}  # each rank's own row
mesh = M.make_mesh(n_data=2, device="cpu")
hex_ = lambda m: {k: float(v).hex() for k, v in m.items()}

def build(state=None):
    model = Sepformer(cfg, generator=torch.Generator().manual_seed(1 + r))  # rank 1: other weights
    if state is not None:
        model.load_state_dict(state)
    return model, make_train_step(model, build_optimizer(lr), TrainConfig(variant="context"), mesh=mesh)

model, step = build(torch.load(os.path.join(work, "init.pt")) if r == 0 else None)
batch = M.shard_batch(local, mesh)
print("STEP", json.dumps(hex_(step(batch))), flush=True)
torch.save(model.state_dict(), os.path.join(work, f"params{r}.pt"))

# rank 0 saves, every rank waits, both restore; the continuation must be exact
ckdir = os.path.join(work, "ckpts")
if r == 0:
    ckpt_lib.save_checkpoint(ckdir, 0, 1, 0.0, {"model": model.state_dict(), "opt_state": step.opt_state,
                                                "step": 1, "epoch": 0})
M.barrier()
ref = hex_(step(batch))
restored = ckpt_lib.restore_checkpoint(ckpt_lib.latest_checkpoint(ckdir), map_location="cpu")
model2, step2 = build(restored["model"])
ckpt_lib.load_opt_state(step2.opt_state, restored["opt_state"])
res = hex_(step2(batch))
same = all(torch.equal(a, b) for a, b in zip(model.parameters(), model2.parameters()))
print("CKPT", json.dumps([ref, res, same]), flush=True)

# 11 files at batch 1: 6 batches on rank 0, 5 on rank 1; every rank stops at the smallest count
eleven = loader(11)
counts = eleven.num_batches(0)
agreed = M.min_over_ranks(counts, "cpu")
for _ in itertools.islice(range(counts), agreed):
    step(batch)
print("EPOCH", json.dumps([counts, agreed]), flush=True)
eleven.close()

# unequal rows: every rank raises
try:
    step({k: v[:r + 1] for k, v in data.items()})
    print("ROWS", json.dumps("accepted"), flush=True)
except RuntimeError as e:
    print("ROWS", json.dumps(str(e)), flush=True)
"""


@pytest.fixture(scope="module")
def jax_case():
    """The JAX model and weights (key 0), and the global batch of two rows
    (rank r's row from numpy seed r), gt = the model's own estimate + noise."""
    jcfg = JaxConfig(**CFG)
    model = JaxSepformer(jcfg)
    rows = [np.random.default_rng(r) for r in range(2)]
    batch = {k: np.concatenate([g.standard_normal(shape).astype(np.float32) for g in rows])
             for k, shape in (("mixed", (1, 800)), ("ctx_feat", (1, 1, 8)))}
    params = model.init(jax.random.key(0), jnp.asarray(batch["mixed"]), jnp.asarray(batch["ctx_feat"]))
    est = np.asarray(model.apply(params, jnp.asarray(batch["mixed"]), jnp.asarray(batch["ctx_feat"])))[:, :, 0]
    noise = np.random.default_rng(2).standard_normal(est.shape)
    batch["gt"] = (est + 0.5 * est.std() * noise).astype(np.float32)
    return model, jax.tree.map(np.asarray, params), batch


@pytest.fixture(scope="module")
def two_ranks(jax_case, tmp_path_factory):
    _, params, batch = jax_case
    work = tmp_path_factory.mktemp("mesh")
    np.savez(work / "batch.npz", **batch)
    torch.save(load_jax_params(Sepformer(SepformerConfig(**CFG)), params).state_dict(), work / "init.pt")
    outs = launch(["-c", CHILD, work, json.dumps(CFG), LR], 2)
    params = [torch.load(work / f"params{r}.pt") for r in range(2)]
    return tagged(outs), params, outs


def test_rendezvous_on_jax_variables_and_second_call_is_a_no_op(two_ranks):
    got, _, _ = two_ranks
    assert [g["INIT"] for g in got] == [[0, 2, True, False], [1, 2, True, False]]


def test_loader_shards_are_disjoint_and_cover_the_files(two_ranks):
    got, _, _ = two_ranks
    a, b = (set(g["SHARD"]) for g in got)
    assert a.isdisjoint(b) and a | b == set(range(10))


def test_sharded_step_matches_jax_mesh_step(jax_case, two_ranks):
    model, params, batch = jax_case
    got, port, _ = two_ranks
    losses = [g["STEP"]["loss"] for g in got]
    assert losses[0] == losses[1]  # bit-equal on both ranks, from different rows
    assert all(torch.equal(port[0][k], port[1][k]) for k in port[0])
    mesh = jax_make_mesh(n_data=2)
    tx = jax_build_optimizer(LR)
    jparams = jax.tree.map(jnp.asarray, params)
    step = jstep.make_train_step(model, tx, jstep.TrainConfig(variant="context"), mesh=mesh)
    gbatch = jax_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    new, _, metrics = step(jparams, tx.init(jparams), gbatch, jax.random.key(1))
    np.testing.assert_allclose(float.fromhex(losses[0]), float(metrics["loss"]), **TOL)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, new))
    assert set(want) <= set(port[0])
    for k, v in want.items():
        np.testing.assert_allclose(port[0][k].numpy(), np.asarray(v), err_msg=k, **TOL)


def test_sharded_step_matches_one_process_step(jax_case, two_ranks):
    _, params, batch = jax_case
    got, port, _ = two_ranks
    model = load_jax_params(Sepformer(SepformerConfig(**CFG)), params)
    step = make_train_step(model, build_optimizer(LR), TrainConfig(variant="context"), device="cpu")
    m = step({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float.fromhex(got[0]["STEP"]["loss"]), m["loss"], rtol=1e-5)
    for k, v in model.state_dict().items():
        a, b = (qv_part(t) if k.endswith("in_proj.bias") else t for t in (port[0][k], v))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-8, err_msg=k)


def test_checkpoint_save_barrier_restore_continues_exactly(two_ranks):
    got, _, _ = two_ranks
    for g in got:
        ref, res, same = g["CKPT"]
        assert ref == res and same
    assert got[0]["CKPT"][0] == got[1]["CKPT"][0]


def test_unequal_shards_finish_an_epoch(two_ranks):
    got, _, _ = two_ranks
    assert [g["EPOCH"] for g in got] == [[6, 5], [5, 5]]


def test_unequal_rows_raise_on_every_rank(two_ranks):
    got, _, _ = two_ranks
    for g in got:
        assert "unequal batches" in g["ROWS"], g["ROWS"]


def test_shard_batch_on_a_one_rank_mesh_is_the_identity():
    mesh = tmesh.make_mesh(1, device="cpu")
    assert (mesh.n_data, mesh.n_model, mesh.data_index, mesh.model_index) == (1, 1, 0, 0)
    assert mesh.data_group is None and mesh.model_group is None
    t = torch.arange(6.0).reshape(2, 3)
    out = tmesh.shard_batch({"mixed": t, "gt": t.numpy(), "names": ["a", "b"]}, mesh)
    assert out["mixed"] is t and torch.equal(out["gt"], t) and out["names"] == ["a", "b"]


def test_make_mesh_needs_the_world_size():
    with pytest.raises(ValueError, match="world size of 2"):
        tmesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="world size of 4"):
        tmesh.make_mesh(n_data=1, n_model=4, device="cpu")


def test_rendezvous_variables(monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "RANK", "WORLD_SIZE", "CSE_MULTIHOST"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.distributed_init_if_needed(device="cpu") is False  # single process: nothing to join
    assert tmesh.process_index() == 0 and tmesh.process_count() == 1
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1")
    with pytest.raises(RuntimeError, match="JAX_NUM_PROCESSES and JAX_PROCESS_ID"):
        tmesh.distributed_init_if_needed(device="cpu")
    assert not torch.distributed.is_initialized()


def test_the_rendezvous_destroys_its_group_at_exit():
    """A rank that joined through ``distributed_init_if_needed`` destroys its
    process group in an exit hook: left to the interpreter's teardown, gloo's
    threads abort a finished rank now and then (exit -6, "terminate called
    without an active exception"), which fails a group that did its work."""
    child = ("import atexit, json, torch, torch.distributed as dist\n"
             "from cse_tpu_torch.core import mesh as M\n"
             "M.distributed_init_if_needed(device='cpu'); x = torch.ones(2); dist.all_reduce(x)\n"
             "atexit._run_exitfuncs()\n"
             "print('LEFT', json.dumps([float(x[0]), dist.is_initialized()]), flush=True)")
    assert [t["LEFT"] for t in tagged(launch(["-c", child], 2))] == [[2.0, False]] * 2
