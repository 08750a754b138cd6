"""Serving engine: fused-stack inference for the Sepformer family.

Port of ``cse_tpu/serving.py``. Runs the parameters of a
:class:`cse_tpu_torch.models.sepformer.Sepformer` but executes each
intra/inter transformer stack through :func:`fused_stack_apply` (the CUDA
kernels on the card, the plain version on the CPU). The remaining
projections (1x1 convs, context mappers, mask heads, encoder and decoder)
stay ordinary PyTorch ops. With ``train=True`` the same forward is
differentiable: each stack runs through
:func:`cse_tpu_torch.ops.fused_train.fused_stack_train` (the training
kernels) and gradients reach the model's parameters. With ``quant="w8a8"``
(inference only) the stacks' projections run int8 (``_stack_kernel_w8a8``).
With a ``context_encoder`` (``models/context_encoder.py``'s contract: ids,
mask -> [B, 1, dim]) one call goes from the dialog history's token ids to the
streams: the encoder's prefill, then the same fused forward.

Usage:
    engine = ServingEngine(cfg, params_or_model)   # device defaults to cuda
    engine = ServingEngine(cfg, params_or_model, quant="w8a8")
    est = engine(mix, ctx)                          # same outputs as Sepformer
    engine = ServingEngine(cfg, model, quant="w8a8", context_encoder=enc)
    est = engine(mix, ids=ids, mask=mask)           # enc(ids, mask), then as above
    est = sepformer_fused_forward(model, mix, ctx, train=True)  # a graph
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from cse_tpu_torch.core.device import resolve_device
from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig, add_pe, dense, mask_head
from cse_tpu_torch.ops.fused_stack import check_quant_mode, fused_stack_apply, stack_weights
from cse_tpu_torch.ops.fused_train import fused_stack_train
from cse_tpu_torch.ops.segmentation import segment
from cse_tpu_torch.utils.profiling import span


def stacked_weights(model: Sepformer, quant: str | None = None) -> dict[str, dict[str, torch.Tensor]]:
    """Every stack's :func:`stack_weights`, keyed ``"{block}.intra"`` /
    ``"{block}.inter"``."""
    cd = model.cfg.compute_dtype
    out = {}
    for i, blk in enumerate(model.masknet.dual_mdl):
        out[f"{i}.intra"] = stack_weights(blk.intra_mdl, cd, quant)
        out[f"{i}.inter"] = stack_weights(blk.inter_mdl, cd, quant)
    return out


def _check_quant(quant, train=False):
    check_quant_mode(quant)
    if train and quant is not None:
        raise ValueError("w8a8 stacks are inference-only: train=True takes quant=None")


def _stack(x, cfg: SepformerConfig, stacks, block: int, view: str, module, quant=None):
    """PE + fused transformer stack. x: [G, L, D]. ``stacks`` None runs the
    differentiable training stack on ``module`` (the TransformerStack), else
    the inference stack on ``stacks[f"{block}.{view}"]`` (made for ``quant``)."""
    x = add_pe(x, cfg.pe_max_len)
    cd = cfg.compute_dtype
    with span("model.stack." + view, {"G": x.shape[0], "L": x.shape[1]}):
        if stacks is not None:
            return fused_stack_apply(x, stacks[f"{block}.{view}"], nhead=cfg.nhead, compute_dtype=cd, quant=quant)
        y = fused_stack_train(x, module, nhead=cfg.nhead, compute_dtype=cd)
    return y.to(cd)


def sepformer_fused_forward(
    model: Sepformer,
    mix: torch.Tensor,
    ctx: torch.Tensor | None = None,
    se: torch.Tensor | None = None,
    cue_index=None,
    stacks: dict | None = None,
    train: bool = False,
    quant: str | None = None,
):
    """Mirror of ``Sepformer.forward`` with fused stacks; same returns.

    ``train=False`` (serving) runs without autograd on the model's
    :func:`stacked_weights` for ``quant`` (``stacks``, made here when not
    given); ``train=True`` returns a graph through the training stacks and
    refuses ``quant="w8a8"``.
    """
    _check_quant(quant, train)
    if train:
        return _fused_forward(model, mix, ctx, se, cue_index, None)
    with torch.no_grad():
        return _fused_forward(model, mix, ctx, se, cue_index,
                              stacked_weights(model, quant) if stacks is None else stacks, quant)


def _fused_forward(model: Sepformer, mix, ctx, se, cue_index, stacks, quant=None):
    """The forward's body; ``stacks`` None selects the training stacks."""
    cfg, cd = model.cfg, model.cfg.compute_dtype
    B, T = mix.shape
    with span("model.encode"):
        w = model.encode(mix)  # [B, L, N] in cd
    L = w.shape[1]
    if cfg.add_se and ctx is not None:
        ctx = model.fuse_cues(ctx, se, cue_index)

    mn = model.masknet
    x = dense(mn.norm(w), mn.conv1d, cd)
    x, gap = segment(x, cfg.chunk_size)  # [B, S, K, D]
    _, S, K, N = x.shape
    Tc = 0 if (ctx is None or not cfg.add_ctx) else ctx.shape[1]

    pred_head = None
    for i, blk in enumerate(mn.dual_mdl):
        intra = x.reshape(B * S, K, N)
        if Tc:
            c = dense(ctx, blk.intra_context_mapper, cd)
            c = c[:, None].expand(B, S, Tc, N).reshape(B * S, Tc, N)
            intra = torch.cat([c, intra.to(c.dtype)], dim=1)
        intra = _stack(intra, cfg, stacks, i, "intra", blk.intra_mdl, quant)
        intra = intra[:, Tc:].reshape(B, S, K, N)
        intra = blk.intra_norm(intra) + x

        inter = intra.transpose(1, 2).reshape(B * K, S, N)
        if Tc:
            c = dense(ctx, blk.inter_context_mapper, cd)
            c = c[:, None].expand(B, K, Tc, N).reshape(B * K, Tc, N)
            inter = torch.cat([c, inter.to(c.dtype)], dim=1)
        inter = _stack(inter, cfg, stacks, i, "inter", blk.inter_mdl, quant)
        pred_head = inter[:, 0].reshape(B, K, N).mean(dim=1)
        inter = inter[:, Tc:].reshape(B, K, S, N).transpose(1, 2)
        x = blk.inter_norm(inter) + intra

    with span("model.mask_head"):
        masks = mask_head(mn, x, gap, B, L)
    with span("model.decode"):
        est = model.decode(w, masks, T)
    if cfg.variant == "contsep":
        with span("model.select"):
            return est, model.select(pred_head)
    return est


class ServingEngine:
    """Fused-inference wrapper with the ``Sepformer`` call signature.

    ``params_or_model`` is a port :class:`Sepformer` or a ``cse_tpu`` flax
    param tree (nested mappings of arrays), which is loaded strictly through
    :func:`cse_tpu_torch.compat.jax_params.load_jax_params`. ``device``
    defaults to ``cuda`` and raises when CUDA is absent; the stacked kernel
    weights are made once here. ``quant="w8a8"`` quantizes the stacks'
    projections to int8 (``_stack_kernel_w8a8``). ``context_encoder`` (on
    the same device) lets a call take the history's ``ids`` and ``mask``
    in place of ``ctx``.
    """

    def __init__(self, cfg: SepformerConfig, params_or_model, device=None, quant: str | None = None,
                 context_encoder=None):
        _check_quant(quant)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.quant = quant
        if isinstance(params_or_model, Sepformer):
            if params_or_model.cfg != cfg:
                raise ValueError("model.cfg differs from cfg")
            model = params_or_model
        elif isinstance(params_or_model, Mapping):
            from cse_tpu_torch.compat.jax_params import load_jax_params

            model = Sepformer(cfg)
            load_jax_params(model, params_or_model)
        else:
            raise TypeError(f"expected a Sepformer or a param mapping, got {type(params_or_model)}")
        self.model = model.to(self.device).eval()
        self.stacks = stacked_weights(self.model, quant)
        self.context_encoder = context_encoder

    def _in(self, a):
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.as_tensor(np.asarray(a), device=self.device)

    def __call__(self, mix, ctx=None, se=None, cue_index=None, ids=None, mask=None):
        """The model's outputs for ``mix`` conditioned on ``ctx``, or on the
        context encoder's vectors of ``ids`` / ``mask`` [B, T] (left-padded
        histories)."""
        with span("serve"), torch.inference_mode():
            if ids is not None:
                if self.context_encoder is None or ctx is not None:
                    raise ValueError("ids take the engine's context_encoder, in place of ctx")
                ctx = self.context_encoder(self._in(ids), self._in(mask))
            ctx = self._in(ctx)
            cue = cue_index if cue_index is None or isinstance(cue_index, int) else self._in(cue_index)
            return sepformer_fused_forward(
                self.model, self._in(mix), ctx=ctx, se=self._in(se),
                cue_index=cue, stacks=self.stacks, quant=self.quant,
            )
