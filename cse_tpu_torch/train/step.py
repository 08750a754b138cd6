"""Train and eval steps for every CSE variant, data-parallel over a mesh.

Port of ``cse_tpu/train/step.py``. A step runs the separator forward (the
plain :class:`Sepformer`, or with ``fused=True`` the fused forward whose
stacks run the training kernels), the loss, the backward, and the
AdamW-amsgrad chain of :mod:`cse_tpu_torch.train.optimizer`.

With a ``mesh`` (``core/mesh.py``) each rank runs the step on its own rows
and one all-reduce over the data group averages the gradients and the
metrics: the explicit form of the reduction XLA inserts from JAX's sharding
annotations (and of the reference's DDP backward hook,
``train_ContSep.py:276-280,396-419``). The mean over a rank's rows averaged
over equally many rows per rank is JAX's mean over the global batch; the
step raises when the ranks' row counts differ. Every rank then takes the
same update from the same reduced gradients.

Loss per variant:
* contsep:  ctx_weight * selector loss (BCE | CE against the argmax of the
            detached per-stream SI-SNR) + PIT SI-SNR;
* context:  -SI-SNR on stream 0;
* hcontext: the same, with the cue (joint .3 / history .35 / voice .35) drawn
            per step from two uniforms;
* base:     PIT SI-SNR only.

The context features come from the batch (``ctx_feat``) or, when the steps
are built with ``llm_apply`` and ``llm_params``, from the frozen context
encoder run on ``context_ids`` / ``context_mask`` under ``no_grad``.
The steps run on CUDA unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from cse_tpu_torch.core.device import resolve_device
from cse_tpu_torch.core.mesh import Mesh, broadcast_tensors
from cse_tpu_torch.ops.losses import ctx_selection_loss, pit_si_snr_loss, si_snr
from cse_tpu_torch.serving import sepformer_fused_forward
from cse_tpu_torch.train.optimizer import AdamWAmsgrad, global_norm
from cse_tpu_torch.utils.profiling import span

_ALIGN = 128  # fp32 elements: a gradient's slot in the all-reduce buffer starts on 512 bytes


def _slot(n: int) -> int:
    return n + (-n) % _ALIGN


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    variant: str = "context"  # 'base' | 'contsep' | 'context' | 'hcontext'
    num_spks: int = 2
    ctx_weight: float = 1.0
    use_ce: bool = True


def _sample_cue(generator: torch.Generator | None = None) -> int:
    """H-ContExt per-step cue draw from two independent uniforms (the
    reference's double random.random()): joint 0.3 / history 0.35 / voice 0.35."""
    r = torch.rand(2, generator=generator)
    if r[0] < 0.3:
        return 0
    return 1 if 0.3 <= r[1] < 0.8 else 2


def _apply_fn(model, fused: bool):
    if fused:
        return lambda mix, ctx=None, **kw: sepformer_fused_forward(model, mix, ctx, train=True, **kw)
    return lambda mix, ctx=None, **kw: model(mix, ctx, **kw)


def _get_ctx(batch, llm_apply, llm_params):
    """The context features: the frozen encoder's, under no_grad, when
    ``llm_apply`` is given; else the batch's ``ctx_feat``."""
    if llm_apply is not None:
        with torch.no_grad():
            return llm_apply(llm_params, batch["context_ids"], batch["context_mask"])
    return batch.get("ctx_feat")


def make_loss_fn(model, cfg: TrainConfig, llm_apply: Callable | None = None, fused: bool = False,
                 llm_params=None):
    """loss(batch, generator=None) -> (loss, metrics).

    ``batch`` keys: mixed [B, T], gt [B, T], noises [B, T, spk-1]
    (contsep/base), ctx_feat [B, Tc, llm_dim] (or context_ids / context_mask
    when ``llm_apply`` is given), se [B, 1, se_dim] (hcontext).
    ``fused=True`` runs the separator through the fused forward (training
    kernels on the card): the same parameters and math. ``llm_apply`` is a
    pure function ``(llm_params, ids, mask) -> feats`` (an encoder's
    ``pure()``); no gradient flows into it."""
    apply_fn = _apply_fn(model, fused)

    def loss_fn(batch, generator=None):
        mixed, gt = batch["mixed"], batch["gt"]
        metrics: dict[str, Any] = {}
        if cfg.variant == "base":
            est = apply_fn(mixed)
            with span("train.loss"):
                targets = torch.cat([gt[:, :, None], batch["noises"]], dim=-1)
                loss = pit_si_snr_loss(est, targets).mean()
            metrics["snr_loss"] = loss
            return loss, metrics
        ctx = _get_ctx(batch, llm_apply, llm_params)
        if cfg.variant == "contsep":
            est, logits = apply_fn(mixed, ctx)
            with span("train.loss"):
                # selection label: the stream with the highest SI-SNR against gt (no grad)
                label = si_snr(est.detach().transpose(1, 2), gt[:, None, :]).argmax(dim=-1)
                ctx_loss = ctx_selection_loss(logits, label, cfg.use_ce)
                targets = torch.cat([gt[:, :, None], batch["noises"]], dim=-1)
                snr_loss = pit_si_snr_loss(est, targets).mean()
                loss = cfg.ctx_weight * ctx_loss + snr_loss
                pred = logits.argmax(dim=-1) if cfg.use_ce else (logits[:, 0] > 0).long()
                metrics.update(snr_loss=snr_loss, ctx_loss=ctx_loss,
                               ctx_acc=(pred == label).float().mean())
            return loss, metrics
        kwargs = {}
        if cfg.variant == "hcontext":
            kwargs = dict(se=batch["se"], cue_index=_sample_cue(generator))
        est = apply_fn(mixed, ctx, **kwargs)
        with span("train.loss"):
            loss = -si_snr(est[:, :, 0], gt).mean()
        metrics["snr_loss"] = loss
        return loss, metrics

    return loss_fn


def _to_device(batch, device):
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v).to(device)
            for k, v in batch.items()}


def _llm_to(llm_params, device):
    """The encoder's weights on ``device``: a tuple (the stub's tables) or a
    dict tree (the Llama encoder's). ``Tensor.to`` returns a tensor already
    there as it is, so weights loaded on the device are never copied."""
    if llm_params is None:
        return None
    if isinstance(llm_params, dict):
        return {k: _llm_to(v, device) for k, v in llm_params.items()}
    if isinstance(llm_params, torch.Tensor):
        return llm_params.to(device)
    return tuple(_llm_to(t, device) for t in llm_params)


def all_reduce_mean(params, grads, metrics: dict, rows: int, mesh: Mesh):
    """Average ``grads`` (None counts as zeros) and the 0-d ``metrics`` over
    the mesh's data group in one fp32 all-reduce; returns ``(grads,
    metrics, check)``: the reduced gradients as views of the buffer (None
    where the local gradient was None), the reduced metrics, and ``check()``,
    which raises unless every rank held ``rows`` rows.

    Each gradient's slot starts on a 512-byte boundary, as a tensor of its
    own would, so the reductions that read it (the norm, the clip) take the
    same vectorised path and give the same bits as on unreduced gradients.
    The row counts travel in the same buffer and are copied to the host
    behind the reduction, so ``check`` reads them without waiting once the
    optimizer has read its finite flag."""
    names = list(metrics)
    dev = params[0].device
    pad = torch.zeros(_ALIGN, dtype=torch.float32, device=dev)
    parts = []
    for p, g in zip(params, grads):
        n = p.numel()
        parts += [torch.zeros(n, dtype=torch.float32, device=dev) if g is None else g.float().reshape(-1),
                  pad[:_slot(n) - n]]
    # rows and rows^2, filled on the device: a copy from the host would wait for the backward
    row_stats = torch.full((2,), float(rows), device=dev)
    row_stats[1] = float(rows * rows)
    flat = torch.cat(parts + [torch.stack([metrics[k].detach().float() for k in names]), row_stats])
    if mesh.data_group is not None:
        dist.all_reduce(flat, group=mesh.data_group)
    if dev.type == "cuda":
        counts = torch.empty(2, pin_memory=True)
        counts.copy_(flat[-2:], non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
    else:
        counts, copied = flat[-2:], None
    flat = flat[:-2].div_(torch.full((), float(mesh.n_data), device=dev))

    def check():
        with span("train.all_reduce.read_rows"):
            if copied is not None:
                copied.synchronize()
            total, squares = counts.tolist()
        if squares * mesh.n_data != total * total:
            raise RuntimeError(f"the {mesh.n_data} data ranks hold unequal batches ({rows} rows here, "
                               f"{total:g} in all): the mean over ranks is not the global batch's")

    *chunks, reduced = flat.split([_slot(p.numel()) for p in params] + [len(names)])
    grads = [None if g is None else c[:p.numel()].view_as(p) for p, g, c in zip(params, grads, chunks)]
    return grads, dict(zip(names, reduced.unbind())), check


def make_train_step(model, optimizer: AdamWAmsgrad, cfg: TrainConfig, fused: bool = False,
                    device=None, llm_apply: Callable | None = None, llm_params=None, mesh: Mesh | None = None):
    """step(batch, generator=None) -> metrics (floats: the loss terms,
    ``loss`` and the pre-clip ``grad_norm``).

    Moves ``model`` to ``device`` (CUDA unless ``device="cpu"``; with a mesh
    the mesh's device) and updates its parameters in place; the optimizer
    state is ``step.opt_state``. ``step.tensors(batch, generator=None)`` is
    the same step returning the metrics as 0-d tensors on the device, without
    reading them back: the trainer's loop reads them only at its log
    boundaries. ``llm_apply`` / ``llm_params``: see :func:`make_loss_fn`.

    ``mesh``: the batch is this rank's rows. The parameters are broadcast
    from data rank 0 once, here; each step all-reduces the gradients and
    metrics (:func:`all_reduce_mean`), so ``grad_norm``, the clip and the
    non-finite skip act on the reduced gradients alike on every rank.
    ``step.reduced_bytes`` is the size of the last step's all-reduce."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    model.to(dev)
    params = list(model.parameters())
    if mesh is not None and mesh.data_group is not None:
        broadcast_tensors(params, mesh.data_group, mesh.data_src)
    opt_state = optimizer.init(params)
    loss_fn = make_loss_fn(model, cfg, llm_apply, fused, _llm_to(llm_params, dev))
    n_slots = sum(_slot(p.numel()) for p in params)

    def tensors(batch, generator=None):
        batch = _to_device(batch, dev)
        for p in params:
            p.grad = None
        with span("train.forward"):
            loss, metrics = loss_fn(batch, generator)
        with span("train.backward"):
            loss.backward()
        grads = [p.grad for p in params]
        metrics["loss"] = loss
        check = None
        if mesh is not None:
            with span("train.all_reduce"):
                grads, metrics, check = all_reduce_mean(params, grads, metrics, batch["mixed"].shape[0], mesh)
            step.reduced_bytes = 4 * (n_slots + len(metrics) + 2)
        with span("train.optimizer"):
            metrics["grad_norm"] = global_norm([g for g in grads if g is not None])
            optimizer.step(params, grads, opt_state)
        if check is not None:
            check()
        return {k: v.detach() for k, v in metrics.items()}

    def step(batch, generator=None):
        return {k: float(v) for k, v in tensors(batch, generator).items()}

    step.tensors = tensors
    step.opt_state = opt_state
    return step


def make_eval_step(model, cfg: TrainConfig, cue: str = "joint", fused: bool = False, device=None,
                   llm_apply: Callable | None = None, llm_params=None, mesh: Mesh | None = None):
    """step(batch) -> (enhanced [B, T], aux).

    ContSep picks the stream through the selector head (argmax of the
    softmax, or the sign of the BCE logit); base returns the oracle-best
    stream when ``gt`` is given; context variants return stream 0.
    ``fused=True`` runs the fused serving forward. ``mesh``: the step runs on
    the mesh's device, on data rank 0's parameters (broadcast once, here);
    each rank evaluates the batches it is given."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    model.to(dev)
    if mesh is not None and mesh.data_group is not None:
        broadcast_tensors(list(model.parameters()), mesh.data_group, mesh.data_src)
    llm_params = _llm_to(llm_params, dev)
    cue_idx = {"joint": 0, "history": 1, "voice": 2}[cue]
    if fused:
        apply_fn = lambda mix, ctx=None, **kw: sepformer_fused_forward(model, mix, ctx, **kw)
    else:
        apply_fn = _apply_fn(model, False)

    @torch.no_grad()
    def step(batch):
        batch = _to_device(batch, dev)
        mixed = batch["mixed"]
        if cfg.variant == "base":
            est = apply_fn(mixed)
            if "gt" in batch:
                best = si_snr(est.transpose(1, 2), batch["gt"][:, None, :]).argmax(dim=-1)
                return est.gather(2, best[:, None, None].expand(-1, est.shape[1], 1))[:, :, 0], {}
            return est[:, :, 0], {}
        ctx = _get_ctx(batch, llm_apply, llm_params)
        if cfg.variant == "contsep":
            est, logits = apply_fn(mixed, ctx)
            pred = logits.argmax(dim=-1) if cfg.use_ce else (logits[:, 0] > 0).long()
            enhanced = est.gather(2, pred[:, None, None].expand(-1, est.shape[1], 1))[:, :, 0]
            aux = {"ctx_pred": pred}
            if "gt" in batch:
                aux["ctx_label"] = si_snr(est.transpose(1, 2), batch["gt"][:, None, :]).argmax(dim=-1)
            return enhanced, aux
        kwargs = {}
        if cfg.variant == "hcontext":
            kwargs = dict(se=batch["se"], cue_index=cue_idx)
        return apply_fn(mixed, ctx, **kwargs)[:, :, 0], {}

    return step
