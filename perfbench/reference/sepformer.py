"""Plain fp32 PyTorch reference of the Sepformer family, its losses and its optimizer.

A frozen copy of the mathematics the benchmark holds the port against. It
imports nothing of the port (nor JAX): it works from a configuration dict
and a dict of weights (:mod:`perfbench.weights`), in fp32 with TF32 off,
in blocks of mixtures so that it fits beside nothing else on the card.

* :func:`forward` — the separator: encoder (Conv1d + ReLU), GroupNorm(1),
  1x1, 50%-overlap chunks, dual-path blocks (context token prepended to both
  views, sinusoidal PE, pre-LN layers, final LN, GroupNorm + skip), PReLU
  mask head with overlap-add and the tanh x sigmoid gate, ConvTranspose1d
  decoder; ``context`` decodes stream 0 alone, ``contsep`` all streams and
  the selector logits from the inter output at the context position.
* :func:`loss_fn` — ``context``: -SI-SNR of stream 0; ``contsep``:
  permutation-invariant -SI-SNR plus ``ctx_weight`` times the selector's CE
  (or BCE) against the stream closest to the target.
* :class:`AdamWAmsgrad` — clip by global norm, AMSGrad on bias-corrected
  moments, decoupled decay, the learning rate: optax's chain and order.

``prec`` puts the products into a lower precision, for the benchmark's
controls: ``"fp8"`` rounds both operands of every product (forward and
backward) to float8 e4m3 with a scale per row of the left and per column
of the right operand; ``"int4"`` rounds the transformer stacks'
projections to symmetric int4 the same way (inference only).
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-6
GN_EPS = 1e-8
SNR_EPS = 1e-8
PRECISIONS = (None, "fp8", "int4")


def fp32_only():
    """fp32 products everywhere: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------- lower-precision products (controls)


def _round_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _round_int4(x: torch.Tensor, dim: int) -> torch.Tensor:
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 7.0
    return torch.round(x / s).clamp(-7, 7) * s


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _round_fp8(a, -1) @ _round_fp8(b, -2)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = _round_fp8(g, -1) @ _round_fp8(b.transpose(-1, -2), -2)
        gb = _round_fp8(a.transpose(-1, -2), -1) @ _round_fp8(g, -2)
        return ga, gb


def matmul(a, b, prec=None, site="glue"):
    """a @ b in fp32, or with its operands rounded as ``prec`` says."""
    if prec == "fp8":
        return _Fp8Matmul.apply(a, b)
    if prec == "int4" and site == "stack":
        return _round_int4(a, -1) @ _round_int4(b, -2)
    return a @ b


def linear(x, P, name, prec=None, site="glue"):
    y = matmul(x, P[f"{name}.weight"].t(), prec, site)
    b = P.get(f"{name}.bias")
    return y if b is None else y + b


# ---------------------------------------------------------------- the separator


def sinusoidal_pe(length: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device) * (-math.log(10000.0) / d))
    pe = torch.zeros(length, d, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def layer_norm(x, P, name):
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"], P[f"{name}.bias"], LN_EPS)


def group_norm1(x, P, name):
    """One group: statistics per sample over every other axis, then a
    per-channel (last axis) scale and offset."""
    axes = tuple(range(1, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + GN_EPS) * P[f"{name}.weight"] + P[f"{name}.bias"]


def chunk_shapes(L: int, K: int) -> tuple[int, int]:
    """(gap, S): trailing pad and number of 50%-overlapped chunks of L frames."""
    P = K // 2
    gap = K - (P + L % K) % K
    return gap, (L + gap) // P + 1


def segment(x, K):
    B, L, N = x.shape
    P = K // 2
    gap, S = chunk_shapes(L, K)
    x = F.pad(x, (0, 0, P, gap + P))
    idx = (torch.arange(S, device=x.device) * P)[:, None] + torch.arange(K, device=x.device)
    return x[:, idx], gap  # [B, S, K, N]


def overlap_add(y, gap):
    B, S, K, N = y.shape
    P = K // 2
    out = torch.zeros(B, (S - 1) * P + K, N, dtype=y.dtype, device=y.device)
    for s in range(S):
        out[:, s * P:s * P + K] += y[:, s]
    return out[:, P:out.shape[1] - P - gap]


def attention(x, P, name, H, prec=None):
    """Multi-head self-attention of [G, L, D], q|k|v packed in in_proj."""
    G, L, D = x.shape
    hd = D // H
    qkv = linear(x, P, f"{name}.in_proj", prec, "stack")
    q, k, v = (t.reshape(G, L, H, hd).transpose(1, 2) for t in qkv.split(D, dim=-1))
    s = matmul(q, k.transpose(-1, -2), prec, "attn") / math.sqrt(hd)
    o = matmul(torch.softmax(s, dim=-1), v, prec, "attn")
    return linear(o.transpose(1, 2).reshape(G, L, D), P, f"{name}.out_proj", prec, "stack")


def encoder_layer(x, P, name, H, prec=None):
    x = x + attention(layer_norm(x, P, f"{name}.norm1"), P, f"{name}.self_att", H, prec)
    h = torch.relu(linear(layer_norm(x, P, f"{name}.norm2"), P, f"{name}.ffn_1", prec, "stack"))
    return x + linear(h, P, f"{name}.ffn_2", prec, "stack")


def transformer_stack(x, P, name, cfg, prec=None, remat=False):
    x = x + sinusoidal_pe(x.shape[1], x.shape[2], x.device)
    for j in range(cfg["num_tf_layers"]):
        lyr = f"{name}.layers.{j}"
        if remat and torch.is_grad_enabled():
            x = checkpoint(encoder_layer, x, P, lyr, cfg["nhead"], prec, use_reentrant=False)
        else:
            x = encoder_layer(x, P, lyr, cfg["nhead"], prec)
    return layer_norm(x, P, f"{name}.norm")


def _forward(cfg, P, mix, ctx, prec, remat, with_head=False):
    B, T = mix.shape
    spk, D, N, K = cfg["num_spks"], cfg["d_model"], cfg["enc_channels"], cfg["chunk_size"]
    w = torch.relu(F.conv1d(mix[:, None], P["encoder.weight"], stride=cfg["enc_stride"])).transpose(1, 2)
    L = w.shape[1]
    x = linear(group_norm1(w, P, "masknet.norm"), P, "masknet.conv1d", prec)
    x, gap = segment(x, K)
    S = x.shape[1]
    add_ctx = cfg["variant"] in ("contsep", "context")
    Tc = ctx.shape[1] if add_ctx else 0
    head = None
    for i in range(cfg["num_dp_layers"]):
        blk = f"masknet.dual_mdl.{i}"
        intra = x.reshape(B * S, K, D)
        if Tc:
            c = linear(ctx, P, f"{blk}.intra_context_mapper", prec)
            intra = torch.cat([c[:, None].expand(B, S, Tc, D).reshape(B * S, Tc, D), intra], dim=1)
        intra = transformer_stack(intra, P, f"{blk}.intra_mdl", cfg, prec, remat)[:, Tc:].reshape(B, S, K, D)
        intra = group_norm1(intra, P, f"{blk}.intra_norm") + x
        inter = intra.transpose(1, 2).reshape(B * K, S, D)
        if Tc:
            c = linear(ctx, P, f"{blk}.inter_context_mapper", prec)
            inter = torch.cat([c[:, None].expand(B, K, Tc, D).reshape(B * K, Tc, D), inter], dim=1)
        inter = transformer_stack(inter, P, f"{blk}.inter_mdl", cfg, prec, remat)
        head = inter[:, 0].reshape(B, K, D).mean(dim=1)
        inter = inter[:, Tc:].reshape(B, K, S, D).transpose(1, 2)
        x = group_norm1(inter, P, f"{blk}.inter_norm") + intra
    # mask head
    a = P["masknet.prelu_alpha"]
    x = torch.where(x >= 0, x, a * x)
    x = linear(x, P, "masknet.conv2d", prec).reshape(B, S, K, spk, D).permute(0, 3, 1, 2, 4)
    g = overlap_add(x.reshape(B * spk, S, K, D), gap)  # [B*spk, L, D]
    g = torch.tanh(linear(g, P, "masknet.output", prec)) * torch.sigmoid(linear(g, P, "masknet.output_gate", prec))
    masks = torch.relu(linear(g, P, "masknet.end_conv1x1", prec)).reshape(B, spk, L, N)
    # decoder
    streams = [0] if cfg["variant"] == "context" else range(spk)
    outs = [F.conv_transpose1d((w * masks[:, s]).transpose(1, 2), P["decoder.weight"], stride=cfg["enc_stride"])[:, 0]
            for s in streams]
    est = torch.stack(outs, dim=-1)
    est = F.pad(est, (0, 0, 0, T - est.shape[1])) if T > est.shape[1] else est[:, :T]
    if cfg["variant"] == "contsep":
        return (est, linear(head, P, "context_selector")) + ((head,) if with_head else ())
    return est


def forward(cfg: dict, P: dict, mix, ctx=None, prec=None, block: int = 4, remat: bool = False,
            with_head: bool = False):
    """The separator on ``mix [B, T]`` (and ``ctx [B, Tc, llm_dim]``), ``block``
    mixtures at a time: est ``[B, T, streams]`` fp32 (and the selector
    logits ``[B, n]`` for ``contsep``, with ``with_head`` also the
    selector's input ``[B, D]``)."""
    if prec not in PRECISIONS:
        raise ValueError(f"prec must be one of {PRECISIONS}")
    outs = [_forward(cfg, P, mix[b:b + block], None if ctx is None else ctx[b:b + block], prec, remat, with_head)
            for b in range(0, mix.shape[0], block)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


# ---------------------------------------------------------------- losses


def si_snr(pred, target):
    """Zero-mean scale-invariant SNR in dB along the last axis (eps 1e-8)."""
    pred = pred - pred.mean(dim=-1, keepdim=True)
    target = target - target.mean(dim=-1, keepdim=True)
    proj = (pred * target).sum(-1, keepdim=True) * target / ((target * target).sum(-1, keepdim=True) + SNR_EPS)
    noise = pred - proj
    return 10.0 * torch.log10((proj * proj).sum(-1) / ((noise * noise).sum(-1) + SNR_EPS) + SNR_EPS)


def per_mixture_loss(cfg: dict, train: dict, out, batch) -> torch.Tensor:
    """Each mixture's term of the loss ``[B]`` (the loss is their mean)."""
    gt = batch["gt"]
    if cfg["variant"] == "context":
        return -si_snr(out[:, :, 0], gt)
    est, logits = out
    targets = torch.cat([gt[:, :, None], batch["noises"]], dim=-1)
    C = est.shape[-1]
    pair = si_snr(est.transpose(1, 2)[:, :, None], targets.transpose(1, 2)[:, None])  # [B, est, target]
    pit = torch.stack([torch.stack([pair[:, p[c], c] for c in range(C)], -1).mean(-1)
                       for p in itertools.permutations(range(C))], -1).amax(-1)
    label = si_snr(est.detach().transpose(1, 2), gt[:, None]).argmax(-1)
    if train.get("use_ce", True):
        sel = -torch.log_softmax(logits, -1).gather(-1, label[:, None])[:, 0]
    else:
        z, y = logits[:, 0], label.float()
        sel = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))
    return train.get("ctx_weight", 1.0) * sel - pit


def loss_and_grads(cfg: dict, train: dict, P: dict, batch: dict, prec=None, block: int = 4):
    """The batch's mean loss and its gradient for every leaf of ``P``, a
    block of mixtures at a time (each mixture's terms depend on it alone),
    the layers recomputed in the backward."""
    B = batch["mixed"].shape[0]
    leaves = {k: v.detach().requires_grad_(True) for k, v in P.items()}
    grads = {k: torch.zeros_like(v) for k, v in P.items()}
    total = 0.0
    for b in range(0, B, block):
        part = {k: v[b:b + block] for k, v in batch.items()}
        out = _forward(cfg, leaves, part["mixed"], part.get("ctx_feat"), prec, True)
        loss = per_mixture_loss(cfg, train, out, part).sum() / B
        for k, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)):
            if g is not None:
                grads[k] += g
        total += float(loss.detach())
    return total, grads


# ---------------------------------------------------------------- optimizer


def cosine_warmup(base_lr: float, total: int, warmup: int):
    """Update k (1-based) runs at f(k - 1): linear 0 -> 1 over ``warmup``,
    then cosine to 0 at ``total``; in float32."""
    import numpy as np

    def lr(count: int) -> float:
        it = np.float32(count)
        warm = it / np.float32(max(warmup, 1))
        prog = (it - np.float32(warmup)) / np.float32(max(total - warmup, 1))
        cos = np.float32(0.5) * (np.float32(1.0) + np.cos(np.float32(math.pi) * prog, dtype=np.float32))
        return float(np.float32(base_lr) * (warm if it <= warmup else cos))

    return lr


class AdamWAmsgrad:
    """clip_by_global_norm -> AMSGrad (bias-corrected moments, running max of
    the corrected second moment) -> + weight_decay * p -> * -lr, skipping a
    step whose gradients are not all finite."""

    def __init__(self, lr, weight_decay=1e-6, clip_norm=5.0, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.wd, self.clip, self.b1, self.b2, self.eps = lr, weight_decay, clip_norm, b1, b2, eps
        self.count = 0
        self.mu = self.nu = self.nu_max = None

    def step(self, P: dict, grads: dict) -> dict:
        """Update ``P`` in place; returns the gradients as the moments took
        them (after the clip)."""
        if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
            return {}
        if self.mu is None:
            self.mu = {k: torch.zeros_like(v) for k, v in P.items()}
            self.nu = {k: torch.zeros_like(v) for k, v in P.items()}
            self.nu_max = {k: torch.zeros_like(v) for k, v in P.items()}
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        if not bool(norm < self.clip):
            grads = {k: g / norm * self.clip for k, g in grads.items()}
        lr = self.lr(self.count)
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        with torch.no_grad():
            for k, p in P.items():
                g = grads[k]
                self.mu[k].mul_(self.b1).add_((1 - self.b1) * g)
                self.nu[k].mul_(self.b2).add_((1 - self.b2) * g * g)
                torch.maximum(self.nu_max[k], self.nu[k] / bc2, out=self.nu_max[k])
                u = (self.mu[k] / bc1) / (torch.sqrt(self.nu_max[k]) + self.eps) + self.wd * p
                p.add_(-lr * u)
        return grads
