"""The trainer slice as a whole on the CPU: cse_tpu_torch.train.loop.train_net
through parse_train_args with --debug_tiny_model --platform cpu (the flags of
tests/test_integration.py), the first batch's loss and gradients against
cse_tpu's, resume, and the checkpoint files.

First-step parity: the model's weights and the encoder's tables go across
(compat.jax_params); each package draws the batch from its own loader and
its own synthesize_batch. Loss and every gradient at rtol 5e-3, atol 1e-4
(fp32), the bar of tests/test_torch_train_step.py. H-ContExt: each package
crops the enrollment from its own batch on the same draws (JAX's key) and
embeds it with its spectral stand-in on the same projection; the cue draw is
fixed on both sides.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cse_tpu.train.loop as jloop
import cse_tpu.train.step as jstep
import cse_tpu_torch.train.loop as tloop
import cse_tpu_torch.train.step as tstep
from cse_tpu.core.flags import parse_train_args as jax_parse_train_args
from cse_tpu.data import datasets as jds
from cse_tpu.data.pipeline import TrainLoader as JaxTrainLoader
from cse_tpu.data.pipeline import crop_enrollment as jax_crop_enrollment
from cse_tpu.data.tokenizer import load_tokenizer as jax_load_tokenizer
from cse_tpu.models.context_encoder import HashProjectionEncoder as JaxEncoder
from cse_tpu.models.llama import LlamaContextEncoder as JaxLlamaEncoder
from cse_tpu.models.speaker_encoder import _spectral_embedding as jax_spectral_embedding
from cse_tpu_torch.compat.jax_params import (
    hash_encoder_tables,
    jax_params_to_state_dict,
    load_jax_params,
    spectral_projection_from_jax,
)
from cse_tpu_torch.core.cli import corpus_paths, setup_synthetic
from cse_tpu_torch.core.flags import parse_train_args
from cse_tpu_torch.data import datasets as tds
from cse_tpu_torch.data.pipeline import TrainLoader, crop_enrollment
from cse_tpu_torch.data.tokenizer import load_tokenizer
from cse_tpu_torch.models.context_encoder import HashProjectionEncoder
from cse_tpu_torch.models.llama import LlamaContextEncoder
from cse_tpu_torch.models.speaker_encoder import SpectralSpeakerEncoder
from cse_tpu_torch.train import checkpoint as ckpt_lib
from cse_tpu_torch.train.loop import train_net
from cse_tpu_torch.train.optimizer import build_optimizer
from cse_tpu_torch.train.schedules import ReduceLROnPlateau
from torch_ranks import launch, tagged

torch.set_num_threads(1)

BASE = ["--synthetic_smoke", "--platform", "cpu", "--debug_tiny_model", "--train_data", "dailytalk",
        "--tot_iters", "3", "--batch_size", "2", "--eval_step", "2", "--max_sp_len", "2",
        "--max_ctx_tokens", "16", "--workers", "2", "--log_every", "10"]
TOL = dict(rtol=5e-3, atol=1e-4)


def _args(extra, parse=parse_train_args):
    return parse(BASE + [str(e) for e in extra])


def test_flags_match_the_jax_package():
    a, b = vars(_args([])), vars(_args([], jax_parse_train_args))
    assert a == b
    assert parse_train_args([]).platform is None and parse_train_args([]).fused_train is None
    assert parse_train_args(["--no_fused_train"]).fused_train is False
    assert parse_train_args(["--ctx_buckets", "none"]).ctx_buckets == ()


@pytest.mark.parametrize("variant", ["context", "contsep", "base", "hcontext"])
def test_train_net_variants(tmp_path, variant, capsys):
    stats = {}
    model = train_net(_args(["--checkpoint_dir", tmp_path / variant]), variant=variant, stats=stats)
    assert all(torch.isfinite(p).all() for p in model.parameters())
    ckpts = sorted(p.name for p in (tmp_path / variant).glob("*.ckpt"))
    assert [c[:16] for c in ckpts if c.startswith("Epoch")] == ["Epoch_0000_00002", "Epoch_0000_00004"]
    # --tot_iters 3: the reference's stop rule ends the run after update 4
    assert stats["start_step"] == 0 and stats["final_step"] == 4
    assert stats["loss_reads"] and all(np.isfinite(stats["loss_reads"]))
    assert len(stats["val_ms"]) >= 3 and stats["h2d_bytes"] > 0
    out = capsys.readouterr().out
    assert "train path: layer by layer (auto) on cpu" in out and "Total Iteration Reached" in out
    assert out.count("## VALIDATION SI-SNR") == 3  # the smoke validation and steps 2, 4


def test_unported_paths_raise(tmp_path, monkeypatch):
    # --mesh_data must be the world size: one process cannot hold a data axis of 2
    with pytest.raises(SystemExit, match="must be the world size, 1 process"):
        train_net(_args(["--checkpoint_dir", tmp_path, "--mesh_data", 2]), variant="context")
    # no --platform: the card, and without one it raises rather than run on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(["--checkpoint_dir", tmp_path])
    args.platform = None
    with pytest.raises(RuntimeError, match="CUDA"):
        train_net(args, variant="context")


DP_CHILD = r"""
import json, sys
import torch
torch.set_num_threads(1)
import cse_tpu_torch.train.loop as loop
from cse_tpu_torch.core.flags import parse_train_args
from cse_tpu_torch.train import checkpoint as ckpt_lib

saves, writers = [], []
save = ckpt_lib.save_checkpoint
ckpt_lib.save_checkpoint = lambda *a, **k: (saves.append(a[2]), save(*a, **k))[1]
logger = loop.MetricLogger
loop.MetricLogger = lambda *a, **k: (writers.append(k["enabled"]), logger(*a, **k))[1]
stats = {}
loop.train_net(parse_train_args(sys.argv[1:]), variant="context", stats=stats)
print("RESULT", json.dumps({"saves": saves, "writers": writers, "final_step": stats["final_step"],
                            "losses": [float(x).hex() for x in stats["loss_reads"]]}), flush=True)
"""


def test_two_processes_train_with_mesh_data(tmp_path):
    """--mesh_data 2 over two gloo processes (JAX's rendezvous variables):
    both ranks exit 0 after the same updates and read the same losses (the
    reduced metrics); only rank 0 opens the metric logs and writes the
    checkpoint of step 2."""
    argv = ["-c", DP_CHILD] + [str(a) for a in BASE] + ["--tot_iters", 2, "--mesh_data", 2,
                                                        "--checkpoint_dir", tmp_path]
    res = [t["RESULT"] for t in tagged(launch(argv, 2))]
    assert [r["writers"] for r in res] == [[True], [False]]
    assert res[0]["saves"] == [2] and res[1]["saves"] == []
    assert res[0]["final_step"] == res[1]["final_step"] == 3
    assert res[0]["losses"] == res[1]["losses"] and res[0]["losses"]
    assert [p.name[:16] for p in tmp_path.glob("Epoch_*.ckpt")] == ["Epoch_0000_00002"]


def test_fused_path_can_be_forced_on_the_cpu(tmp_path, capsys):
    stats = {"profile_steps": (0, 2)}  # both steps under the loop's profiler window
    train_net(_args(["--checkpoint_dir", tmp_path, "--fused_train", "--tot_iters", 1, "--eval_step", 5]),
              variant="context", stats=stats)
    assert "train path: fused kernels (forced) on cpu" in capsys.readouterr().out
    assert stats["final_step"] == 2 and np.isfinite(stats["loss_reads"]).all()
    assert not list(tmp_path.glob("*.ckpt"))  # no eval_step boundary was reached
    # on the CPU the window has the loop's and the step's spans and no device activity: each step
    # one forward, loss, backward, optimizer and its two host reads; the tiny model's one block
    # (2 layers) runs its intra stack on G = B x 162 chunks of L = 50 + 1 context token and its
    # inter stack on G = B x 50 of L = 162 + 1, and the fused backward once a layer and stack
    per_step = {"prepare_batch": 1, "train.forward": 1, "model.encode": 1, "model.stack.intra[G=324,L=51]": 1,
                "model.stack.inter[G=100,L=163]": 1, "model.mask_head": 1, "model.decode": 1, "train.loss": 1,
                "train.backward": 1, "train.stack_backward[G=324,L=51]": 2, "train.stack_backward[G=100,L=163]": 2,
                "train.optimizer": 1, "train.optimizer.read_finite": 1, "train.optimizer.read_clip": 1}
    assert stats["profile"] == {"range_ms": {k: [0.0] * (2 * n) for k, n in per_step.items()}}


def test_device_activity_reads_busy_share_and_longest_gap():
    """Busy time is the union of the device intervals (two streams overlap in
    1500-2000); a range's device time is the work launched while it was open
    on any thread, matched to its launch by correlation id: by the runtime
    call's id (from the loop's thread and from autograd's), else through the
    operator a kernel is linked to."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from cse_tpu_torch.utils.profiling import device_activity

    def ev(dev, a, b, name="k", note=False, id=0, linked=0, kind=None, thread=1):
        return NS(device_type=dev, time_range=NS(start=a, end=b), name=name, is_user_annotation=note, id=id,
                  linked_correlation_id=linked, activity_type=kind, thread=thread)

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [ev(cpu, 0.0, 10.0, "cse/prepare_batch", note=True, id=1, kind="user_annotation"),
              ev(cpu, 1.0, 2.0, "aten::copy_", id=2, kind="cpu_op"),
              ev(cpu, 1.5, 1.8, "cudaMemcpyAsync", id=900, linked=2, kind="cuda_runtime"),
              ev(cuda, 0.0, 1000.0, "Memcpy HtoD", id=900, linked=2, kind="gpu_memcpy"),
              ev(cpu, 20.0, 90.0, "cse/train.backward", note=True, id=3, kind="user_annotation"),
              ev(cpu, 30.0, 31.0, "cudaLaunchKernel", id=901, kind="cuda_runtime", thread=7),
              ev(cuda, 1500.0, 2000.0, id=901, kind="kernel"),
              ev(cpu, 40.0, 41.0, "aten::mul", id=4, kind="cpu_op", thread=7),
              ev(cuda, 1200.0, 1800.0, id=555, linked=4, kind="kernel"),
              ev(cpu, 95.0, 96.0, "cudaLaunchKernel", id=902, kind="cuda_runtime"),
              ev(cuda, 3000.0, 4000.0, id=902, kind="kernel"),
              ev(cuda, 0.0, 4000.0, "cse/prepare_batch", note=True, kind="gpu_user_annotation"),
              ev(cpu, 0.0, 10.0, "aten::add", id=5, kind="cpu_op")]
    got = device_activity(NS(events=lambda: events))
    assert got == {"wall_ms": 4.0, "kernel_ms": 2.8, "busy_share": 0.7, "longest_idle_gap_ms": 1.0,
                   "range_ms": {"prepare_batch": [1.0], "train.backward": [0.8]}}
    # torch 2.11's events carry neither the kind nor the link: runtime calls are known by name
    bare = [NS(**{k: v for k, v in vars(e).items() if k not in ("activity_type", "linked_correlation_id")})
            for e in events]
    assert device_activity(NS(events=lambda: bare))["range_ms"] == {"prepare_batch": [1.0], "train.backward": [0.5]}


def _first_batches(args, jargs):
    """The first train batch of each package from its own loader and synthesis."""
    out = []
    for a, ds_, Loader, load_tok, loop, paths_of in (
            (jargs, jds, JaxTrainLoader, jax_load_tokenizer, jloop, jloop._corpus_paths),
            (args, tds, TrainLoader, load_tokenizer, tloop, corpus_paths)):
        paths = paths_of(a)
        kw = dict(seed=a.seed, num_workers=a.workers, process_index=0, process_count=1,
                  demand_files=ds_.demand_noise_list(paths) if a.noise_add else None)
        if Loader is TrainLoader:
            kw["device"] = "cpu"
        loader = Loader(ds_.build_train_list(paths, a.train_data), loop._pipeline_cfg(a, "train"),
                        load_tok(a.llama_path, a.llama_auth_token), a.train_data, a.batch_size, **kw)
        out.append(loader.device_batch(next(iter(loader.batches(0)))))
        loader.close()
    return out


@pytest.fixture(scope="module")
def llama_4096(tmp_path_factory):
    """A Llama directory at the context width the model reads (hidden 4096,
    32 query and 8 key-value heads), 1 layer, intermediate 64, vocab 320 (the
    ByteTokenizer's ids fit), saved by transformers."""
    from transformers import LlamaConfig as HFConfig, LlamaForCausalLM

    torch.manual_seed(0)
    d = tmp_path_factory.mktemp("llama_4096")
    LlamaForCausalLM(HFConfig(vocab_size=320, hidden_size=4096, intermediate_size=64, num_hidden_layers=1,
                              num_attention_heads=32, num_key_value_heads=8, attn_implementation="eager")
                     ).save_pretrained(str(d), safe_serialization=True)
    return str(d)


LLAMA = "<the llama_4096 directory>"


@pytest.mark.parametrize("variant,extra", [("context", ["--augmentation", "--noise_add"]), ("contsep", []),
                                           ("base", []), ("context", ["--max_ctx_tokens", 32, "--llama_path", LLAMA]),
                                           ("hcontext", [])])
def test_first_batch_loss_and_grads_match_jax(variant, extra, request, monkeypatch):
    """With ``--llama_path``: both packages' Llama encoders on the same files,
    in fp32 (the trainers' bf16 default would compare two CPU bf16 product
    orders, not the ports)."""
    args = setup_synthetic(_args(extra))
    jargs = _args(extra, jax_parse_train_args)
    llama = request.getfixturevalue("llama_4096") if LLAMA in extra else None
    if llama:
        args.llama_path = llama  # setup_synthetic points it at the stub
    for k in ("dailytalk_data_path", "acoustic_noise_path", "lists_root", "llama_path"):
        setattr(jargs, k, getattr(args, k))  # both read the port's copy of the corpus
    jbatch, tbatch = _first_batches(args, jargs)
    keys = ("mixed", "gt", "noises", "context_ids", "context_mask")
    init_kw = {}
    if variant == "hcontext":
        keys += ("se",)
        key = jax.random.key(5)
        k1, k2 = jax.random.split(key)  # crop_enrollment's draws from its key
        draws = (torch.from_numpy(np.array(jax.random.randint(k1, (2,), 1, 6))),
                 torch.from_numpy(np.array(jax.random.uniform(k2, (2,)))))
        jbatch["se"] = jax_spectral_embedding(*jax_crop_enrollment(jbatch["gt16k"], jbatch["gt16k_len"], key))
        stand = SpectralSpeakerEncoder(projection=spectral_projection_from_jax(
            np.asarray(jax.random.normal(jax.random.key(0), (402, 192)))))
        tbatch["se"] = stand(*crop_enrollment(tbatch["gt16k"], tbatch["gt16k_len"], *draws))
        np.testing.assert_allclose(tbatch["se"].numpy(), np.asarray(jbatch["se"]), rtol=1e-4, atol=1e-5)
        monkeypatch.setattr(jstep, "_sample_cue", lambda rng: jnp.asarray(0))  # the joint cue on both sides
        monkeypatch.setattr(tstep, "_sample_cue", lambda generator=None: 0)
        init_kw = dict(se=jnp.zeros((2, 1, 192)), cue_index=jnp.asarray(0))

    jmodel, jtcfg = jloop.build_model(jargs, variant)
    jb = {k: jbatch[k] for k in keys}
    dummy = (jnp.zeros((2, 4000)),) + (() if variant == "base" else (jnp.zeros((2, 1, 4096)),))
    params = jmodel.init(jax.random.key(0), *dummy, **init_kw)
    jenc = JaxLlamaEncoder(llama, ctx_length=1, dtype=jnp.float32) if llama else JaxEncoder(dim=4096, ctx_length=1)
    jfn, jps = jenc.pure()
    loss_fn = jstep.make_loss_fn(jmodel, jtcfg, None if variant == "base" else jfn, fused=False)
    (jl, jmetrics), jg = jax.value_and_grad(lambda p: loss_fn(p, jb, jax.random.key(1), jps), has_aux=True)(params)
    want = {k: v.numpy() for k, v in jax_params_to_state_dict(jax.tree.map(np.asarray, jg)).items()}

    model, tcfg = tloop.build_model(args, variant)
    load_jax_params(model, jax.tree.map(np.asarray, params))
    key = jax.random.key(0)
    tables = hash_encoder_tables(np.asarray(jax.random.normal(key, (1, 1, 4096)) * 0.02),
                                 np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (1, 1, 4096)) * 6.283))
    if llama:
        tfn, tps = LlamaContextEncoder(llama, ctx_length=1, dtype=torch.float32, device="cpu").pure()
    else:
        tfn, tps = HashProjectionEncoder(dim=4096, ctx_length=1, tables=tables).pure()
    loss, metrics = tstep.make_loss_fn(model, tcfg, None if variant == "base" else tfn, llm_params=tps)(
        {k: tbatch[k] for k in keys})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    assert set(metrics) == set(jmetrics)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_resume_restores_state_bit_exact_and_continues(tmp_path, monkeypatch):
    d = tmp_path / "run"
    train_net(_args(["--checkpoint_dir", d, "--tot_iters", 2, "--plateau", "--no_reduce", 0,
                     "--update_frequency", 2]), variant="context")
    first = ckpt_lib.latest_checkpoint(str(d))
    assert os.path.basename(first).startswith("Epoch_0000_00002_")
    saved = ckpt_lib.restore_checkpoint(first)
    assert saved["step"] == 2 and saved["epoch"] == 0 and saved["format"] == ckpt_lib.FORMAT
    assert saved["opt_state"]["count"] == 2 and saved["opt_state"]["mini_step"] == 0
    assert saved["opt_state"]["gradient_step"] == 2 and len(saved["opt_state"]["acc_grads"]) == len(saved["model"])
    assert set(saved["plateau"]) == set(ReduceLROnPlateau().state_dict())

    seen = {}
    orig_load, orig_state = ckpt_lib.load_opt_state, ReduceLROnPlateau.load_state_dict

    def load_opt_state(state, saved_state):
        out = orig_load(state, saved_state)
        seen["opt"] = copy.deepcopy(ckpt_lib.opt_state_to_dict(out))
        return out

    def load_state_dict(self, sd):
        orig_state(self, sd)
        seen["plateau"] = self.state_dict()

    monkeypatch.setattr(ckpt_lib, "load_opt_state", load_opt_state)
    monkeypatch.setattr(ReduceLROnPlateau, "load_state_dict", load_state_dict)
    stats = {}
    model = train_net(_args(["--checkpoint_dir", d, "--tot_iters", 4, "--resume", "--from_ckpt", "--plateau",
                             "--no_reduce", 0, "--update_frequency", 2]), variant="context", stats=stats)
    assert stats["start_step"] == 2 and stats["final_step"] == 5
    assert seen["plateau"] == dict(saved["plateau"])
    for k, v in saved["opt_state"].items():
        if isinstance(v, list):
            assert all(torch.equal(a, b) for a, b in zip(seen["opt"][k], v)), k
        else:
            assert seen["opt"][k] == v, k
    second = ckpt_lib.latest_checkpoint(str(d))
    later = ckpt_lib.restore_checkpoint(second)
    assert later["step"] == 4 > saved["step"] and later["best_val"] >= saved["best_val"]
    assert later["opt_state"]["count"] == 4
    assert all(torch.isfinite(p).all() for p in model.parameters())
    # weights only (no --from_ckpt): the model is loaded, the counters are not
    stats = {}
    train_net(_args(["--checkpoint_dir", d, "--checkpoint", first, "--tot_iters", 0, "--eval_step", 50]),
              variant="context", stats=stats)
    assert stats["start_step"] == 0 and stats["final_step"] == 1


def test_checkpoint_names_best_rolls_and_latest_orders(tmp_path):
    d = str(tmp_path)
    lin = torch.nn.Linear(3, 2)
    opt = build_optimizer(1e-3, update_frequency=2)
    state = {"model": lin.state_dict(), "opt_state": opt.init(list(lin.parameters())), "step": 7, "epoch": 1,
             "best_val": 1.5, "plateau": ReduceLROnPlateau().state_dict()}
    p1 = ckpt_lib.save_checkpoint(d, 1, 7, 1.5, state)
    assert os.path.basename(p1) == "Epoch_0001_00007_1.50.ckpt"
    b1 = ckpt_lib.save_checkpoint(d, 1, 7, 1.5, state, best=True)
    assert os.path.basename(b1) == "Best_0001_00007_1.50.ckpt"
    p2 = ckpt_lib.save_checkpoint(d, 0, 12, -3.256, dict(state, step=12))
    assert os.path.basename(p2) == "Epoch_0000_00012_-3.26.ckpt"
    b2 = ckpt_lib.save_checkpoint(d, 2, 9, 2.0, dict(state, step=9), best=True)
    assert sorted(os.listdir(d)) == ["Best_0002_00009_2.00.ckpt", "Epoch_0000_00012_-3.26.ckpt",
                                    "Epoch_0001_00007_1.50.ckpt"]  # one rolling Best
    assert ckpt_lib.latest_checkpoint(d) == p2  # by the step in the name, not the epoch or the time
    assert ckpt_lib.latest_checkpoint(str(tmp_path / "none")) is None
    got = ckpt_lib.restore_checkpoint(b2)
    assert got["step"] == 9 and got["epoch"] == 1 and got["best_val"] == 1.5
    assert all(torch.equal(got["model"][k], v) for k, v in lin.state_dict().items())
    fresh = opt.init(list(lin.parameters()))
    fresh.count = 99
    ckpt_lib.load_opt_state(fresh, got["opt_state"])
    assert fresh.count == 0 and fresh.acc_grads is not None and fresh.plateau_scale == 1.0
    # a released PyTorch checkpoint (no format entry) comes back in the reference's form;
    # a file of neither form is refused
    released = str(tmp_path / "released.ckpt")
    torch.save({"state_dict": lin.state_dict(), "step": 3}, released)
    rel = ckpt_lib.restore_checkpoint(released)
    assert rel["step"] == 3 and all(torch.equal(rel["state_dict"][k], v) for k, v in lin.state_dict().items())
    torch.save({"weights": lin.state_dict()}, released)
    with pytest.raises(ValueError, match="neither"):
        ckpt_lib.restore_checkpoint(released)
    with pytest.raises(ValueError, match="does not fit"):
        ckpt_lib.load_opt_state(build_optimizer(1e-3).init(list(torch.nn.Linear(2, 2).parameters())),
                                dict(got["opt_state"], mu=[]))
