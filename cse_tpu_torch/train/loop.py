"""Generic trainer driving every CSE variant (the reference's L5 layer).

Port of ``cse_tpu/train/loop.py``. One ``train_net(args, variant)`` replaces
the reference's copy-pasted trainers (``train_ContSep.py`` /
``train_ContExt.py`` / ``train_HContExt.py``), keeping their operational
behaviour:

* smoke ``validate(fast_validate=True)`` before training ("debug the
  pipeline", reference ``train_ContSep.py:282``);
* per-``--log_every`` wall-clock prints; loss prints every 100 steps;
* validation every ``--eval_step`` with checkpoint + rolling Best;
* ``--tot_iters`` stop (a clean exit, not the reference's assert-crash);
* ``--resume`` / ``--checkpoint`` with ``--from_ckpt`` restore model,
  optimizer, plateau, step and epoch; a released PyTorch checkpoint of the
  reference warm-starts the weights (with ``--from_ckpt`` also step and
  epoch) under fresh optimizer moments.

Execution model: the host threads only decode and tokenize; per step the
device runs the mixture synthesis, the frozen context encoder, the
separator's forward and backward and the optimizer. The loop prepares batch
i + 1 (pinned host-to-device copies and its synthesis, enqueued without
waiting) after step i has been enqueued, keeps the step's metrics as 0-d
tensors, and reads them only at log boundaries. One host sync per optimizer
update remains: the optimizer's finite check and clip branch read the
gradient norm (``train/optimizer.py``).

``--platform cpu`` runs on the CPU; with no ``--platform`` the device is the
card, and the run raises without one. The fused train path is on by default
on the card and off on the CPU; ``--fused_train`` / ``--no_fused_train``
force it. A ``--llama_path`` holding Llama weights conditions on the frozen
Llama (``models/llama.py``; ``--llama_int8``, ``--llama_w8a8``) inside the
step; ``--synthetic_smoke`` forces the stub. ``variant="hcontext"`` embeds a
random 1-5 s enrollment crop of each batch's 16 kHz source with the frozen
speaker encoder (``--ecapa_path``, else the stand-in) on the device, when the
batch is prepared; validation embeds by the eval enrollment rules.

Data parallel (``--mesh_data N``, one process per rank: ``python -m
torch.distributed.run --nproc_per_node N``, or JAX's ``COORDINATOR_ADDRESS``
/ ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``): the rendezvous comes first
(``core/mesh.py``); N must be the world size, and a run of several processes
without ``--mesh_data`` stops. Each rank loads its own shard of the file
list, the step all-reduces the gradients (``train/step.py``), and every rank
runs the same updates. Each epoch runs the smallest batch count of any rank.
Only rank 0 writes the metric logs, the audio dumps and the checkpoints (a
barrier follows each checkpoint); every rank validates, and rank 0's
validation SI-SNR decides the plateau, the best checkpoint and the files'
names on every rank. A resume restores the same file on every rank.
"""

from __future__ import annotations

import itertools
import os
import time

import numpy as np
import torch

from cse_tpu_torch.compat.torch_import import sepformer_from_state_dict
from cse_tpu_torch.core.banner import announce_assets
from cse_tpu_torch.core.cli import TAG, TINY_MODEL, corpus_paths, device_of, setup_synthetic
from cse_tpu_torch.core.mesh import (
    barrier,
    distributed_init_if_needed,
    from_rank0,
    make_mesh,
    min_over_ranks,
    process_count,
    process_index,
    shard_batch,
)
from cse_tpu_torch.data import datasets as ds
from cse_tpu_torch.data.pipeline import (
    EvalLoader,
    PipelineConfig,
    TrainLoader,
    crop_enrollment,
    draw_enrollment,
    prefetch,
)
from cse_tpu_torch.data.tokenizer import load_tokenizer
from cse_tpu_torch.eval.enrollment import eval_enrollment_embeddings
from cse_tpu_torch.models import Sepformer, SepformerConfig
from cse_tpu_torch.models.context_encoder import build_context_encoder
from cse_tpu_torch.models.speaker_encoder import build_speaker_encoder, encode_speaker
from cse_tpu_torch.ops.losses import si_snr
from cse_tpu_torch.train import checkpoint as ckpt_lib
from cse_tpu_torch.train.optimizer import build_optimizer, set_plateau_scale
from cse_tpu_torch.train.schedules import (
    ReduceLROnPlateau,
    cosine_warmup_schedule,
    linear_warmup_schedule,
)
from cse_tpu_torch.train.step import TrainConfig, make_eval_step, make_train_step
from cse_tpu_torch.utils.logging import IterTimer, MetricLogger
from cse_tpu_torch.utils.profiling import profile_dir_from_env, span, trace_if


def build_model(args, variant: str) -> tuple[Sepformer, TrainConfig]:
    if variant == "contsep" and args.train_data == "dailytalk":
        args.ce = False  # forced, reference train_ContSep.py:167-168
    use_ce = bool(args.ce) if variant == "contsep" else True
    tiny = TINY_MODEL if getattr(args, "debug_tiny_model", False) else {}
    cfg = SepformerConfig(
        num_spks=args.num_max_mix,
        variant="context" if variant == "hcontext" else variant,
        add_se=variant == "hcontext",
        ce=use_ce,
        compute_dtype=torch.bfloat16 if (args.bf16 or args.fp16) else torch.float32,
        remat=None if args.remat == "none" else args.remat,
        use_flash_attention=args.flash_attention,
        **tiny,
    )
    tcfg = TrainConfig(
        variant=variant,
        num_spks=args.num_max_mix,
        ctx_weight=args.ctx_weight,
        use_ce=use_ce,
    )
    return Sepformer(cfg, generator=torch.Generator().manual_seed(0)), tcfg


def build_schedule(args):
    # plateau is EXCLUSIVE of warmup/cosine (reference scheduler selection,
    # train_ContSep.py:244-251: `if plateau: ... elif warmup: ...`): the
    # base lr stays constant and only the plateau scale moves it
    if args.plateau:
        return args.lr
    if args.warmup:
        if args.tot_iters is not None:
            return cosine_warmup_schedule(args.lr, args.tot_iters, args.warmup_iteration)
        return linear_warmup_schedule(args.lr, args.warmup_iteration)
    return args.lr


def _pipeline_cfg(args, mode: str) -> PipelineConfig:
    # validation uses a 30 s bucket (reference train_ContSep.py:577) except in
    # synthetic smoke mode where the tiny corpus makes that pure padding
    val_len = args.max_sp_len if getattr(args, "synthetic_smoke", False) else 30
    return PipelineConfig(
        max_sp_len=args.max_sp_len if mode != "val" else val_len,
        sr=args.sr,
        num_max_mix=args.num_max_mix,
        augmentation=args.augmentation,
        speed_perturb_ratio=tuple(args.speed_perturb_ratio),
        shift_prob=args.shift_prob,
        max_shift_sec=args.max_shift_sec,
        noise_add=args.noise_add,
        max_context_train=args.max_context_train,
        context_length=args.context_length,
        max_ctx_tokens=args.max_ctx_tokens,
        ctx_buckets=tuple(getattr(args, "ctx_buckets", ()) or ()),
        # train-only; eval keeps the exact reference bucket (metric parity)
        aligned_buckets=(mode == "train") and getattr(args, "aligned_buckets", True),
    )


def train_net(args, variant: str, stats: dict | None = None):
    """Train ``variant``; returns the model. ``stats``, when given, receives
    the run's measurements: ``sustained_mixtures_per_s``, ``loss_reads`` (every
    loss the loop read), ``val_ms`` (host-clock ms per validation batch),
    ``h2d_bytes`` per train batch, ``start_step`` and ``final_step``. A caller
    that sets ``stats["profile_steps"] = (start, stop)`` gets those steps of
    the loop (each with the preparation of the batch after it) under
    ``torch.profiler`` and finds ``utils.profiling.device_activity`` of that
    window in ``stats["profile"]``."""
    assert variant in ("base", "contsep", "context", "hcontext")
    dev = device_of(args)
    # the rendezvous before anything else (the torchrun / idr_torch
    # replacement, reference train_ContSep.py:114-132)
    distributed_init_if_needed(device=dev)
    stats = {} if stats is None else stats
    if args.synthetic_smoke:
        args = setup_synthetic(args)

    paths = corpus_paths(args)
    tokenizer = load_tokenizer(args.llama_path, args.llama_auth_token)
    if process_count() > 1 and not args.mesh_data:
        # without a mesh there is no gradient all-reduce: each process would
        # silently train its own model on its shard of the data
        raise SystemExit(f"a run of {process_count()} processes needs --mesh_data {process_count()}")
    if args.mesh_data and args.mesh_data != process_count():
        raise SystemExit(f"--mesh_data {args.mesh_data} must be the world size, {process_count()} "
                         "process(es): launch one process per rank (python -m torch.distributed.run "
                         "--nproc_per_node N, or COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID)")
    mesh = make_mesh(args.mesh_data, device=dev) if args.mesh_data else None
    rank0 = process_index() == 0
    llm = None
    if variant != "base":
        llm = build_context_encoder(
            args.llama_path,
            ctx_length=args.ctx_length if variant != "contsep" else 1,
            auth_token=args.llama_auth_token,
            quant=("w8a8" if getattr(args, "llama_w8a8", False)
                   else "int8" if getattr(args, "llama_int8", False) else None),
            device=dev,
            mesh=mesh,
        )

    model, tcfg = build_model(args, variant)
    speaker = build_speaker_encoder(args.ecapa_path, dev) if variant == "hcontext" else None

    # loud real-vs-stub banner + train-on-stubs refusal (the base variant uses
    # no external nets: the context column is loaded but never conditioned on)
    if variant != "base":
        nets = dict(tokenizer=tokenizer, llm=llm)
        if variant == "hcontext":
            nets["ecapa_path"] = args.ecapa_path
        announce_assets("train", args, **nets)

    files = ds.build_train_list(paths, args.train_data)
    print(f"{TAG} {len(files)} training utterances ({args.train_data})")
    train_loader = TrainLoader(
        files,
        _pipeline_cfg(args, "train"),
        tokenizer,
        args.train_data,
        args.batch_size,
        demand_files=ds.demand_noise_list(paths) if args.noise_add else None,
        seed=args.seed,
        num_workers=args.workers,
        process_index=process_index(),
        process_count=process_count(),
        device=dev,
    )

    B = args.batch_size
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{TAG} Train # of params: {n_params:,}")

    # ---- optimizer and steps
    tx = build_optimizer(
        build_schedule(args),
        weight_decay=args.weight_decay,
        update_frequency=args.update_frequency,
    )
    # fused train path: default ON on the card (the benched configuration is
    # the shipped default), OFF on the CPU; --fused_train / --no_fused_train
    # force either way
    fused_flag = getattr(args, "fused_train", None)
    fused = fused_flag if fused_flag is not None else dev.type == "cuda"
    print(f"{TAG} train path: {'fused kernels' if fused else 'layer by layer'}"
          + (" (auto)" if fused_flag is None else " (forced)") + f" on {dev}")
    llm_fn, llm_ps = llm.pure() if llm is not None else (None, None)
    train_step = make_train_step(model, tx, tcfg, fused=fused, device=dev,
                                 llm_apply=llm_fn, llm_params=llm_ps, mesh=mesh)
    eval_step = make_eval_step(model, tcfg, device=dev, llm_apply=llm_fn, llm_params=llm_ps, mesh=mesh)
    opt_state = train_step.opt_state
    plateau = ReduceLROnPlateau() if args.plateau else None
    step_num, start_epoch = args.start_step, args.start_epoch
    best_val = 0.0

    # ---- resume (reference train_ContSep.py:179-214)
    if args.resume and args.checkpoint is None:
        args.checkpoint = ckpt_lib.latest_checkpoint(args.checkpoint_dir)
        if args.checkpoint:
            print(f"{TAG} Resume with the latest checkpoint {args.checkpoint}")
    if args.checkpoint:
        print(f"{TAG} Loading checkpoint: {args.checkpoint}")
        restored = ckpt_lib.restore_checkpoint(args.checkpoint, map_location=dev)
        if "state_dict" in restored:  # released PyTorch weights: warm start under fresh moments
            cfg = model.cfg
            model.load_state_dict(sepformer_from_state_dict(
                restored["state_dict"], cfg.num_dp_layers, cfg.num_tf_layers))
            if args.from_ckpt:
                step_num = int(restored.get("step", 0))
                start_epoch = int(restored.get("epoch", 0))
        else:
            model.load_state_dict(restored["model"])
            if args.from_ckpt:
                step_num = int(restored["step"])
                start_epoch = int(restored["epoch"])
                if not args.reset_optimizer:  # else fresh moments, keep step/epoch
                    ckpt_lib.load_opt_state(opt_state, restored["opt_state"])
                best_val = float(restored.get("best_val", 0.0))
                if plateau is not None and restored.get("plateau") is not None:
                    plateau.load_state_dict(dict(restored["plateau"]))
                    set_plateau_scale(opt_state, plateau.scale)
    stats["start_step"] = step_num

    schedule = build_schedule(args)
    # per-experiment dump dir (reference train_ContExt.py:131: temp_dir is
    # derived from the checkpoint dir so parallel runs never mix audio)
    if not args.temp_dir:
        args.temp_dir = os.path.join(
            "./tmp_eval", os.path.basename(os.path.normpath(args.checkpoint_dir))
        )
    writer = MetricLogger(args.checkpoint_dir, args.project, enabled=rank0, config=vars(args))
    # with a writer on, the loop reads every step's metrics back (a host sync per step)
    stats["metric_writers"] = [n for n, w in (("tensorboard", writer.tb), ("wandb", writer.wandb)) if w is not None]
    print(f"{TAG} metric writers: {', '.join(stats['metric_writers']) or 'none'}")
    profile_dir = profile_dir_from_env()
    profile_steps = stats.get("profile_steps")  # None: the window of CSE_TPU_PROFILE, if set
    trace_kw = {} if profile_steps is None else dict(
        start=profile_steps[0], stop=profile_steps[1], summary=stats.setdefault("profile", {}))
    val_ms: list[float] = stats.setdefault("val_ms", [])
    loss_reads: list[float] = stats.setdefault("loss_reads", [])

    def _dump(sub_dir, name, arrays, n, step, tag, count, caption=""):
        from cse_tpu_torch.data.audio_io import write_wav

        for sub, arr in arrays:
            d = os.path.join(sub_dir, sub)
            os.makedirs(d, exist_ok=True)
            x = arr[:n].astype(np.float32)
            x = x / max(np.abs(x).max(), 1e-9) * 0.9
            write_wav(os.path.join(d, name + ".wav"), x, args.sr)
            if count < 3:  # wandb audio for the first 3 samples
                writer.audio(f"{tag}/{sub}_{count}", x, args.sr, step, caption=caption)

    def validate(fast_validate=True, epoch=0, step=0):
        # reference fast-val caps (inclusive break: cap+1 batches run,
        # train_ContSep.py:602-678). ContSep validates fast even at
        # eval_step; ContExt runs the full val set there.
        t_cap = (100 if variant == "contsep" else 5) + 1
        loader = EvalLoader(
            paths, args.train_data, "val", _pipeline_cfg(args, "val"),
            tokenizer, args.batch_size, num_test_mix=args.num_test_mix,
            num_workers=args.workers, seed=args.seed, device=dev,
        )
        sisnrs, prevs, accs = [], [], []
        dumped = 0
        dump = args.generate_speech and rank0
        if dump:
            # stale dumps from earlier validations are cleared first
            # (reference train_ContExt.py:579-582)
            import shutil

            shutil.rmtree(os.path.join(args.temp_dir, "val"), ignore_errors=True)
        model.eval()
        for batch in loader.batches(limit_batches=t_cap if fast_validate else None):
            t0 = time.perf_counter()
            if variant == "hcontext":
                # the eval enrollment rules (register wavs / 1 s crops), not the
                # train-time random 1-5 s crop (reference dataset :380-391)
                batch["se"] = eval_enrollment_embeddings(
                    batch, args.train_data, "val", paths, speaker,
                    num_test_mix=args.num_test_mix, seed=args.seed,
                )
            enhanced, aux = eval_step(_model_batch(batch))
            sisnrs.append(si_snr(enhanced, batch["gt"]).cpu().numpy())
            prevs.append(si_snr(batch["mixed"], batch["gt"]).cpu().numpy())
            val_ms.append(1e3 * (time.perf_counter() - t0))
            if "ctx_label" in aux:
                accs.append((aux["ctx_pred"] == aux["ctx_label"]).cpu().numpy())
            # val audio dumps (reference train_ContSep.py:681-710)
            if dump and dumped < args.num_gen_speech:
                lens = batch["sp_len"].cpu().numpy()
                host = {k: batch[k].float().cpu().numpy() for k in ("gt", "mixed")}
                host["preds"] = enhanced.float().cpu().numpy()
                for k, name in enumerate(batch["names"]):
                    if dumped >= args.num_gen_speech:
                        break
                    _dump(os.path.join(args.temp_dir, "val", args.train_data), name,
                          (("gts", host["gt"][k]), ("preds", host["preds"][k]), ("mixed", host["mixed"][k])),
                          int(lens[k]), step, "val_audio", dumped, caption=name)
                    dumped += 1
        model.train()
        loader.close()
        # every rank validates; rank 0's value decides (the decoder's cuDNN
        # conv_transpose1d is not deterministic, so the ranks' last bits differ)
        val = from_rank0(float(np.mean(np.concatenate(sisnrs))) if sisnrs else 0.0, dev)
        prev = float(np.mean(np.concatenate(prevs))) if prevs else 0.0
        print(f"## VALIDATION SI-SNR ({args.train_data}): {val:.4f} "
              f"(SI-SNR-i {val - prev:+.4f})")
        if accs:
            acc = float(np.mean(np.concatenate(accs)))
            print(f"## VALIDATION CTX ACC ({args.train_data}): {acc:.4f}")
            if step:
                writer.scalar(f"val_{args.train_data}/CTX_ACC", acc, step)
        if step:
            writer.scalar(f"val_{args.train_data}/SI-SNR", val, step)
            writer.scalar(f"val_{args.train_data}/SI-SNR-I", val - prev, step)
        return val

    def _model_batch(batch):
        keys = ("mixed", "gt", "noises", "context_ids", "context_mask", "se")
        return {k: batch[k] for k in keys if k in batch}

    def _read_loss(metrics) -> float:
        """The one place the loop reads a step's metrics back (a host sync)."""
        loss = float(metrics["loss"])
        loss_reads.append(loss)
        return loss

    # smoke validation before training (reference :282 "debug the pipeline")
    validate(fast_validate=True)

    print(f"{TAG} starting at step {step_num}, epoch {start_epoch}")
    stop = False
    micro = 0  # global microbatch counter (checkpoints land on update
    # boundaries, so the restored MultiSteps mini_step is 0: aligned)
    # sustained-throughput marks: (global microbatch, wall-clock) at every
    # log boundary; the end-of-run summary rates marks[1:] so the first
    # block (which contains the kernels' build and the warm-up) is excluded.
    # The step is enqueued without waiting for its metrics, so each mark first
    # reads the newest step's loss: marks are true completion times.
    sustained_marks: list[tuple[int, float]] = []
    last_metrics = None
    # the enrollment crops' draws: batch i (from 1, over the whole run) draws
    # from a generator seeded with (seed + 1, i), as JAX folds its dispatch index
    # in; the step's cue draws come from one generator seeded with the seed
    crop_gen = torch.Generator(device=dev) if variant == "hcontext" else None
    cue_gen = torch.Generator().manual_seed(args.seed) if variant == "hcontext" else None
    dispatch_idx = 0
    for epoch in range(start_epoch, args.epochs):
        if stop:
            break
        print(f"Epoch [{epoch}/{args.epochs}]")
        timer = IterTimer(args.log_every)

        def _prepare(host):
            # enqueues the pinned host->device copies and the synthesis on the
            # device; called one batch AHEAD of the metric read below so the
            # next batch's copies and synthesis queue up behind the step in flight
            nonlocal dispatch_idx
            dispatch_idx += 1
            b = train_loader.device_batch(host)
            stats["h2d_bytes"] = train_loader.h2d_bytes
            if variant == "hcontext":
                # the frozen speaker encoder on a random 1-5 s crop of the 16 kHz
                # pre-mix source, enqueued behind the synthesis (the same draws
                # on every rank, each on its own rows)
                crop_gen.manual_seed(int(np.random.SeedSequence([args.seed + 1, dispatch_idx]).generate_state(1)[0]))
                draws = draw_enrollment(b["gt16k"].shape[0], crop_gen)
                b["se"] = encode_speaker(speaker, *crop_enrollment(b["gt16k"], b["gt16k_len"], *draws))
            b = {k: v for k, v in b.items() if k not in ("gt16k", "gt16k_len", "sp_len")}
            return b if mesh is None else shard_batch(b, mesh)

        # every rank stops at the smallest batch count of any rank's shard: a
        # rank with one batch more would wait in an all-reduce the others never enter
        n_batches = min_over_ranks(train_loader.num_batches(epoch), dev)
        host_iter = iter(prefetch(itertools.islice(train_loader.batches(epoch), n_batches)))
        nxt = next(host_iter, None)
        pending = _prepare(nxt) if nxt is not None else None
        i = -1
        while pending is not None:
            i += 1
            batch = pending
            if i % args.log_every == 0:
                if last_metrics is not None:
                    _read_loss(last_metrics)  # drain the device queue
                iter_time = timer.lap()
                sustained_marks.append((micro, time.time()))
                print(
                    "******** Training [%d / %d] : %d / %d, Iter Time : %.3f sec ********"
                    % (epoch, args.epochs, (i + 1) * B, len(files), iter_time)
                )
            with trace_if(profile_dir, step_num, **trace_kw):
                metrics = train_step.tensors(batch, cue_gen)
                last_metrics = metrics
                # prepare batch i+1 while step i runs on the device
                nxt = next(host_iter, None)
                with span("prepare_batch"):
                    pending = _prepare(nxt) if nxt is not None else None
            # step = optimizer updates, not microbatches (reference
            # train_ContSep.py:402-421 with --update_frequency). The counter
            # is GLOBAL (not per-epoch) so it stays aligned with the
            # optimizer's MultiSteps microbatch count across epoch boundaries
            # whose batch count isn't a multiple of update_frequency.
            micro += 1
            if micro % args.update_frequency != 0:
                continue
            step_num += 1
            if writer.tb is not None or writer.wandb is not None:
                vals = {k: float(v) for k, v in metrics.items()}
                writer.scalars(vals, step_num, prefix="train/")
                writer.scalar("train/SI-SNR", -vals.get("snr_loss", 0.0), step_num)
                # the update just applied ran at count = step_num - 1
                lr = schedule(max(step_num - 1, 0)) if callable(schedule) else schedule
                if plateau is not None:
                    lr = lr * plateau.scale
                writer.scalar("lr/learning_rate", float(lr), step_num)
            if step_num % 100 == 0:
                print(
                    f"######## Step(Epoch): {step_num}({epoch}), "
                    f"Loss: {_read_loss(metrics):.4f} #########"
                )
            if args.generate_speech and step_num % args.generate_step == 0 and rank0:
                # train-batch audio dumps (reference train_ContSep.py:515-555)
                model.eval()
                enhanced, _ = eval_step(batch)
                model.train()
                host = {"gts": batch["gt"], "preds": enhanced, "mixed": batch["mixed"]}
                host = {k: v.float().cpu().numpy() for k, v in host.items()}
                for kk in range(min(args.num_gen_speech, enhanced.shape[0])):
                    _dump(os.path.join(args.temp_dir, "train"), str(kk),
                          tuple((sub, arr[kk]) for sub, arr in host.items()),
                          host["gts"].shape[1], step_num, "train_audio", kk)

            if step_num % args.eval_step == 0:
                # reference: ContSep validates fast (cap 100, :459); ContExt
                # scores the FULL val set every eval_step (:425/:417)
                val = validate(
                    fast_validate=(variant in ("contsep", "base")),
                    epoch=epoch, step=step_num,
                )
                if plateau is not None and step_num >= args.no_reduce:
                    prev_scale = plateau.scale
                    plateau.step(val)
                    if plateau.scale != prev_scale:
                        # push the new lr scale into the optimizer state (the
                        # torch param_group-mutation equivalent)
                        set_plateau_scale(opt_state, plateau.scale)
                        print(f"{TAG} plateau: lr scale -> {plateau.scale:g}")
                best_val = max(best_val, val)
                state = {
                    "model": model.state_dict(), "opt_state": opt_state,
                    "step": step_num, "epoch": epoch,
                    "best_val": best_val,
                    "plateau": (plateau or ReduceLROnPlateau()).state_dict(),
                }
                if rank0:
                    print(f"Saving checkpoint for Epoch: {epoch}")
                    ckpt_lib.save_checkpoint(
                        args.checkpoint_dir, epoch, step_num, val, state
                    )
                    if val >= best_val:
                        ckpt_lib.save_checkpoint(
                            args.checkpoint_dir, epoch, step_num, val, state, best=True
                        )
                barrier()  # the files exist for every rank before any goes on
            if step_num - 1 == args.tot_iters:
                print("Total Iteration Reached")  # clean stop (vs assert 1==0)
                stop = True
                break
    if last_metrics is not None:
        _read_loss(last_metrics)
    print("Finishing training")
    if len(sustained_marks) >= 3:
        # end-to-end trainer throughput: host decode/tokenize/prefetch +
        # device synthesis + train step, measured over steady-state blocks
        # (marks[1:] skip the first block with its warm-up). This is the
        # number to hold next to the device-resident step rate.
        (m0, t0), (m1, t1) = sustained_marks[1], sustained_marks[-1]
        if m1 > m0 and t1 > t0:
            rate = (m1 - m0) * B / (t1 - t0)
            stats["sustained_mixtures_per_s"] = rate
            print(f"{TAG} sustained end-to-end throughput: "
                  f"{rate:.3f} mixtures/s ({m1 - m0} microbatches x B={B} "
                  f"over {t1 - t0:.1f} s, steady state)")
    stats["final_step"] = step_num
    train_loader.close()
    writer.close()
    return model
