"""Sepformer dual-path separator and its CSE variants, layer by layer.

Port of ``cse_tpu/models/sepformer.py``. This module is the layer-by-layer
model, in the reference's channels-last layout: ordinary PyTorch ops, except
that ``use_flash_attention`` runs each attention through the flash kernels
(:func:`cse_tpu_torch.ops.attention.flash_mhsa`) and ``remat`` recomputes
layers or dual blocks in the backward. The serving path
(:mod:`cse_tpu_torch.serving`, which runs the transformer stacks through the
fused-stack kernels) is held against it. One configurable model covers the
variants:

* ``variant='base'``     — plain 2/3-source separation
* ``variant='contsep'``  — separate all sources + selector head over the
  context token (``ce`` picks CE over speakers or a single BCE logit)
* ``variant='context'``  — extract ONE stream conditioned on context; with
  ``add_se=True`` this is H-ContExt (speaker-embedding cue fusion).

Parameters use the reference's module names (``masknet.dual_mdl.{i}.intra_mdl
.layers.{j}.self_att.in_proj`` ...) with ``nn.Linear`` weights stored
``[out, in]``; :mod:`cse_tpu_torch.compat.jax_params` carries a flax param
tree across.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from cse_tpu_torch.ops.attention import flash_mhsa
from cse_tpu_torch.ops.segmentation import overlap_add, segment

REMAT_MODES = (False, None, True, "block", "layer", "nested")


@dataclasses.dataclass(frozen=True)
class SepformerConfig:
    num_spks: int = 2
    variant: str = "base"  # 'base' | 'contsep' | 'context'
    add_se: bool = False  # H-ContExt speaker-embedding cue (variant='context')
    ce: bool = True  # selector head: CE over spks vs BCE single logit
    enc_channels: int = 256
    enc_kernel: int = 16
    enc_stride: int = 8
    d_model: int = 256
    nhead: int = 8
    d_ffn: int = 1024
    num_tf_layers: int = 8
    num_dp_layers: int = 2
    chunk_size: int = 250
    llm_dim: int = 4096
    se_dim: int = 192
    pe_max_len: int = 2500
    compute_dtype: torch.dtype = torch.float32
    use_flash_attention: bool = False
    # softmax dtype of the non-flash attention: fp32 (default) or bf16
    softmax_dtype: torch.dtype = torch.float32
    # rematerialization: False/None, 'block' (each dual block; True too),
    # 'layer' (each transformer layer) or 'nested' (both)
    remat: bool | str | None = False

    def __post_init__(self):
        if self.remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, got {self.remat!r}")

    @property
    def remat_layers(self) -> bool:
        return self.remat in ("layer", "nested")

    @property
    def remat_blocks(self) -> bool:
        return self.remat in (True, "block", "nested")

    @property
    def add_ctx(self) -> bool:
        return self.variant in ("contsep", "context")


def sinusoidal_pe(
    length: int, d_model: int, device: torch.device | str | None = None
) -> torch.Tensor:
    """Sinusoidal positional encoding table ``[length, d_model]`` in fp32.

    pe[p, 2i] = sin(p * exp(-2i ln(1e4)/d)), pe[p, 2i+1] = cos(...).
    """
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / d_model)
    )
    pe = torch.zeros(length, d_model, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def add_pe(x: torch.Tensor, pe_max_len: int) -> torch.Tensor:
    """x [G, L, D] + the PE table's first L rows, in x's dtype (position 0,
    the context token's, included)."""
    L, D = x.shape[1], x.shape[2]
    if L > pe_max_len:
        raise ValueError(f"sequence length {L} exceeds pe_max_len {pe_max_len}")
    return x + sinusoidal_pe(L, D, x.device)[None].to(x.dtype)


def dense(x: torch.Tensor, layer: nn.Linear, cd: torch.dtype) -> torch.Tensor:
    """Flax ``nn.Dense(dtype=cd)``: input, kernel and bias rounded to cd."""
    y = x.to(cd) @ layer.weight.t().to(cd)
    return y + layer.bias.to(cd) if layer.bias is not None else y


def remat(module: nn.Module, on: bool, *args):
    """``module(*args)``, rematerialised in the backward when ``on`` (as
    ``nn.remat`` does): only the inputs are saved, and the forward runs again
    when the gradient is taken. Values are unchanged."""
    if on and torch.is_grad_enabled():
        return checkpoint(module, *args, use_reentrant=False)
    return module(*args)


class MultiHeadSelfAttention(nn.Module):
    """Packed-QKV multi-head self-attention (``in_proj`` is q|k|v)."""

    def __init__(self, cfg: SepformerConfig):
        super().__init__()
        D = cfg.d_model
        self.nhead = cfg.nhead
        self.cd = cfg.compute_dtype
        self.use_flash = cfg.use_flash_attention
        self.sd = cfg.softmax_dtype
        self.in_proj = nn.Linear(D, 3 * D)
        self.out_proj = nn.Linear(D, D)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        H = self.nhead
        hd = D // H
        qkv = dense(x, self.in_proj, self.cd)
        q, k, v = (t.reshape(B, L, H, hd).transpose(1, 2) for t in qkv.split(D, dim=-1))
        if self.use_flash:
            out = flash_mhsa(q, k, v)
        else:
            # scores cast to the softmax dtype sd, scaled and normalised in sd
            sd = self.sd
            logits = (q @ k.transpose(-1, -2)).to(sd) * torch.tensor(1.0 / math.sqrt(hd), dtype=sd)
            probs = torch.softmax(logits, dim=-1).to(self.cd)
            out = probs @ v
        out = out.transpose(1, 2).reshape(B, L, D)
        return dense(out, self.out_proj, self.cd)


class TransformerEncoderLayer(nn.Module):
    """Pre-LN encoder layer: LN->MHA->+res, LN->FFN(relu)->+res (eps 1e-6)."""

    def __init__(self, cfg: SepformerConfig):
        super().__init__()
        D = cfg.d_model
        self.cd = cfg.compute_dtype
        self.norm1 = nn.LayerNorm(D, eps=1e-6)
        self.self_att = MultiHeadSelfAttention(cfg)
        self.norm2 = nn.LayerNorm(D, eps=1e-6)
        self.ffn_1 = nn.Linear(D, cfg.d_ffn)
        self.ffn_2 = nn.Linear(cfg.d_ffn, D)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_att(self.norm1(x.float()))
        h = torch.relu(dense(self.norm2(x.float()), self.ffn_1, self.cd))
        return x + dense(h, self.ffn_2, self.cd)


class TransformerStack(nn.Module):
    """PE + N pre-LN layers + final LayerNorm."""

    def __init__(self, cfg: SepformerConfig):
        super().__init__()
        self.pe_max_len = cfg.pe_max_len
        self.remat = cfg.remat_layers
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(cfg) for _ in range(cfg.num_tf_layers)
        )
        self.norm = nn.LayerNorm(cfg.d_model, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = add_pe(x, self.pe_max_len)
        for layer in self.layers:
            x = remat(layer, self.remat, x)
        return self.norm(x.float())


class GroupNorm1(nn.Module):
    """GroupNorm with a single group, eps 1e-8: per-sample stats over all
    non-batch dims (fp32), per-channel affine, cast back to the input dtype."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        axes = tuple(range(1, x.ndim))
        mean = xf.mean(dim=axes, keepdim=True)
        var = xf.var(dim=axes, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + 1e-8)
        return (y * self.weight + self.bias).to(x.dtype)


class DualComputationBlock(nn.Module):
    """One dual-path block: intra-chunk transformer (+skip) then inter-chunk.

    Context prompt tokens are prepended to both sequence views and stripped
    after the transformer; the inter output at the context position,
    mean-pooled over the chunk index, is the selector feature.
    """

    def __init__(self, cfg: SepformerConfig):
        super().__init__()
        self.cfg = cfg
        self.intra_mdl = TransformerStack(cfg)
        self.intra_norm = GroupNorm1(cfg.d_model)
        self.inter_mdl = TransformerStack(cfg)
        self.inter_norm = GroupNorm1(cfg.d_model)
        if cfg.add_ctx:
            self.intra_context_mapper = nn.Linear(cfg.llm_dim, cfg.d_model)
            self.inter_context_mapper = nn.Linear(cfg.llm_dim, cfg.d_model)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor | None):
        cd = self.cfg.compute_dtype
        B, S, K, N = x.shape
        Tc = 0 if ctx is None else ctx.shape[1]

        intra = x.reshape(B * S, K, N)
        if ctx is not None:
            c = dense(ctx, self.intra_context_mapper, cd)  # [B, Tc, N]
            c = c[:, None].expand(B, S, Tc, N).reshape(B * S, Tc, N)
            intra = torch.cat([c, intra.to(c.dtype)], dim=1)
        intra = self.intra_mdl(intra)
        intra = intra[:, Tc:].reshape(B, S, K, N)
        intra = self.intra_norm(intra) + x

        inter = intra.transpose(1, 2).reshape(B * K, S, N)
        if ctx is not None:
            c = dense(ctx, self.inter_context_mapper, cd)
            c = c[:, None].expand(B, K, Tc, N).reshape(B * K, Tc, N)
            inter = torch.cat([c, inter.to(c.dtype)], dim=1)
        inter = self.inter_mdl(inter)
        pred_head = inter[:, 0].reshape(B, K, N).mean(dim=1)
        inter = inter[:, Tc:].reshape(B, K, S, N).transpose(1, 2)
        return self.inter_norm(inter) + intra, pred_head


class DualPathModel(nn.Module):
    """Mask network: norm -> 1x1 -> segment -> dual blocks -> mask heads.

    Returns (masks [B, spk, L, N], pred_head [B, N]).
    """

    def __init__(self, cfg: SepformerConfig):
        super().__init__()
        self.cfg = cfg
        N, D = cfg.enc_channels, cfg.d_model
        self.norm = GroupNorm1(N)
        self.conv1d = nn.Linear(N, D, bias=False)
        self.dual_mdl = nn.ModuleList(
            DualComputationBlock(cfg) for _ in range(cfg.num_dp_layers)
        )
        self.prelu_alpha = nn.Parameter(torch.full((1,), 0.25))
        self.conv2d = nn.Linear(D, D * cfg.num_spks)
        self.output = nn.Linear(D, D)
        self.output_gate = nn.Linear(D, D)
        self.end_conv1x1 = nn.Linear(D, N, bias=False)

    def forward(self, w: torch.Tensor, ctx: torch.Tensor | None):
        cfg, cd = self.cfg, self.cfg.compute_dtype
        B, L, N = w.shape
        x = dense(self.norm(w), self.conv1d, cd)
        x, gap = segment(x, cfg.chunk_size)  # [B, S, K, D]
        pred_head = None
        for blk in self.dual_mdl:
            x, pred_head = remat(blk, cfg.remat_blocks, x, ctx)
        return mask_head(self, x, gap, B, L), pred_head


def mask_head(mn: DualPathModel, x: torch.Tensor, gap: int, B: int, L: int) -> torch.Tensor:
    """PReLU -> conv2d -> overlap-add -> tanh*sigmoid gate -> end_conv1x1 ->
    relu: dual-path output [B, S, K, D] to masks [B, spk, L, N]. Shared by
    the plain model and the serving path (none of it is a TPU kernel)."""
    cfg, cd = mn.cfg, mn.cfg.compute_dtype
    alpha = mn.prelu_alpha.to(x.dtype)
    x = torch.where(x >= 0, x, alpha * x)
    x = dense(x, mn.conv2d, cd)
    _, S, K, _ = x.shape
    x = x.reshape(B, S, K, cfg.num_spks, cfg.d_model)
    x = x.permute(0, 3, 1, 2, 4).reshape(B * cfg.num_spks, S, K, cfg.d_model)
    gate_in = overlap_add(x, gap)  # [B*spk, L, D]
    x = torch.tanh(dense(gate_in, mn.output, cd)) * torch.sigmoid(
        dense(gate_in, mn.output_gate, cd)
    )
    x = torch.relu(dense(x, mn.end_conv1x1, cd))
    return x.reshape(B, cfg.num_spks, L, cfg.enc_channels)


class Sepformer(nn.Module):
    """Full separator. Input mix [B, T]; returns

      base:     est_source [B, T, spk]
      contsep:  (est_source [B, T, spk], ctx_logits [B, 1|spk])
      context:  est_source [B, T, 1]

    ``generator`` seeds the initial weights (on the CPU; move the module
    with ``.to(device)`` afterwards).
    """

    def __init__(self, cfg: SepformerConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        N = cfg.enc_channels
        self.encoder = nn.Conv1d(1, N, cfg.enc_kernel, stride=cfg.enc_stride, bias=False)
        if cfg.add_se:
            self.se_embedding = nn.Linear(cfg.se_dim, cfg.llm_dim)
        self.masknet = DualPathModel(cfg)
        self.decoder = nn.ConvTranspose1d(
            N, 1, cfg.enc_kernel, stride=cfg.enc_stride, bias=False
        )
        if cfg.variant == "contsep":
            n_out = 1 if (cfg.num_spks == 2 and not cfg.ce) else cfg.num_spks
            self.context_selector = nn.Linear(cfg.d_model, n_out)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Flax-like init from ``generator``: attention projections
        xavier-uniform, other kernels lecun-normal, biases zero, norms
        one/zero, PReLU slope 0.25."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if "norm" in name.rsplit(".", 2)[-2] or leaf == "bias":
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "prelu_alpha":
                p.fill_(0.25)
            elif "self_att" in name:
                fan_out, fan_in = p.shape
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                p.uniform_(-bound, bound, generator=generator)
            else:
                fan_in = p.shape[1] * (p.shape[2] if p.ndim == 3 else 1)
                if name == "decoder.weight":
                    fan_in = p.shape[0] * p.shape[2]
                p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)

    def encode(self, mix: torch.Tensor) -> torch.Tensor:
        """Conv1d(1->N, k, s, no bias) + ReLU in cd: [B, T] -> [B, L, N]."""
        cd = self.cfg.compute_dtype
        w = F.conv1d(mix[:, None].to(cd), self.encoder.weight.to(cd), stride=self.cfg.enc_stride)
        return torch.relu(w).transpose(1, 2)

    def fuse_cues(self, ctx, se, cue_index):
        """H-ContExt cue fusion: pick joint / history / voice context per cue.

        ``cue_index`` is a scalar (one cue for the batch) or a [B] vector."""
        cd = self.cfg.compute_dtype
        if se is None or cue_index is None:
            raise ValueError("add_se=True needs se and cue_index")
        se_emb = dense(se, self.se_embedding, cd)  # [B, 1, llm_dim]
        ctx = ctx.to(cd)
        joint = torch.cat([ctx, se_emb], dim=1)
        history = torch.cat([ctx, torch.zeros_like(ctx)], dim=1)
        voice = torch.cat([torch.zeros_like(se_emb), se_emb], dim=1)
        opts = torch.stack([joint, history, voice])  # [3, B, 2, llm_dim]
        cue = torch.as_tensor(cue_index, device=opts.device)
        if cue.ndim == 0:
            return opts[cue]
        return opts[cue, torch.arange(opts.shape[1], device=opts.device)]

    def decode(self, w: torch.Tensor, masks: torch.Tensor, T: int) -> torch.Tensor:
        """Masked encoder frames -> ConvTranspose decoder -> length fix to T,
        fp32 [B, T, n_streams]. ``context`` decodes only mask 0."""
        cfg, cd = self.cfg, self.cfg.compute_dtype
        streams = [0] if cfg.variant == "context" else list(range(cfg.num_spks))
        wt = self.decoder.weight.to(cd)
        outs = []
        for s in streams:
            sep_h = (w * masks[:, s]).transpose(1, 2)  # [B, N, L]
            outs.append(F.conv_transpose1d(sep_h, wt, stride=cfg.enc_stride)[:, 0])
        est = torch.stack(outs, dim=-1)
        T_est = est.shape[1]
        if T > T_est:
            est = F.pad(est, (0, 0, 0, T - T_est))
        else:
            est = est[:, :T]
        return est.float()

    def select(self, pred_head: torch.Tensor) -> torch.Tensor:
        sel = self.context_selector
        return pred_head.float() @ sel.weight.t().float() + sel.bias.float()

    def forward(self, mix, ctx=None, se=None, cue_index=None):
        cfg = self.cfg
        T = mix.shape[1]
        w = self.encode(mix)
        if cfg.add_se and ctx is not None:
            ctx = self.fuse_cues(ctx, se, cue_index)
        masks, pred_head = self.masknet(w, ctx if cfg.add_ctx else None)
        est = self.decode(w, masks, T)
        if cfg.variant == "contsep":
            return est, self.select(pred_head)
        return est
