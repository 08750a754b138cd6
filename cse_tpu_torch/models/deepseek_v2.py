"""DeepSeek-V2 in PyTorch: the frozen dialog-history encoder (one prefill).

The separator is conditioned on an LLM's last hidden state over the dialog
history (``models/context_encoder.py``). This module is that encoder for a
``deepseek_v2`` checkout (DeepSeek-V2-Lite: 27 layers at hidden 2048), after
DeepSeek's published ``modeling_deepseek.py``: token embedding -> per layer
(RMSNorm, multi-head latent attention with YaRN RoPE, RMSNorm, a dense
SwiGLU for the first ``first_k_dense_replace`` layers and a mixture of
experts after) -> final RMSNorm. The LM head is not used: the encoder reads
hidden states only.

* **Latent attention (MLA), no q LoRA.** ``q_proj`` gives each head a
  ``qk_nope`` part and a ``qk_rope`` part; ``kv_a_proj_with_mqa`` gives a
  ``kv_lora_rank`` latent and one rope key that every head shares; the
  latent is RMS-normed and ``kv_b_proj`` expands it to each head's
  ``qk_nope`` key and ``v_head`` value. Scores over ``qk_nope + qk_rope``,
  softmax scale ``(qk_nope + qk_rope)^-1/2 x mscale(factor, mscale_all_dim)^2``.
* **YaRN RoPE** on the rope parts (:func:`yarn_inv_freq`): frequencies
  blended between the original and the ``factor``-scaled ones by a linear
  ramp over the correction range of ``beta_fast`` / ``beta_slow``; cos and
  sin times ``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``;
  DeepSeek's pairing (each adjacent pair of a head's rope part rotates
  together, the output in de-interleaved order).
* **Mixture of experts.** The router is an fp32 softmax over
  ``n_routed_experts``; greedy top-k (``num_experts_per_tok``), renormalised
  only under ``norm_topk_prob``, times ``routed_scaling_factor``. Every
  token reaches every expert it chose (no capacity factor, nothing
  dropped): the tokens' k slots are sorted by expert and each expert's
  SwiGLU runs on its contiguous rows as one grouped product
  (``torch._grouped_mm`` with the experts' offsets, which stay on the
  device). The shared experts (one SwiGLU of width ``n_shared x
  moe_intermediate_size``) take every token and add to the routed sum.

Departures from the published code, each on purpose:

* Products run in the weights' dtype (bf16), as there; the RMSNorm
  statistics, the router's logits and softmax, the attention softmax and
  the weighted sum of the routed experts' outputs run in fp32. The softmax
  scale multiplies the scores after they are cast to fp32 (the published
  code scales the bf16 product).
* The attention after the projections is ``ops/mla.py``: on the card the
  hand-written ``mla_prefill_bf16_kernel`` (fp32 scores kept on chip, the
  masked tiles skipped, each row's first real token given as an index),
  where a pad query, whose keys are all masked, gets 0; on the CPU its plain
  twin, which masks with one finite additive bias of ``-1e30``
  (``llama.py``'s), so a pad query gets a finite softmax row there too.
* **Positions count from each row's first real token** (``cumsum(mask) -
  1``), not over the padded width, so a left-padded history gets the same
  vector as the history alone, whatever request it is batched in.

The weights are a dict of frozen tensors in the checkout's ``[out, in]``
layout (:func:`params_from_state_dict`), the experts stacked per layer as
``[E, out, in]``. Everything runs on the card unless the caller asks for the
CPU. The spans (``utils/profiling.py::span``) are ``cse/ctx.encode`` around
the whole prefill, ``cse/ctx.embed`` (lookup, positions, the mask as a bias or
each row's first real token, rope tables),
``cse/ctx.mla[B=..,T=..]``, ``cse/ctx.dense_mlp`` and ``cse/ctx.moe.route``
/ ``.experts`` / ``.shared`` (each with ``[B=..,T=..]``). With ``counters``
(:class:`cse_tpu_torch.utils.profiling.DeviceCounters`) the forward counts,
on the device, the real and the padded tokens, each MoE layer's tokens
per expert (``expert_tokens.<layer>``) and, where the attention kernel
runs, the (query tile, key tile) pairs of every head and layer that it
computes and skips (``mla.tiles_run``, ``mla.tiles_skipped``). The
prefill reads nothing back to the host (the experts' offsets stay on the
device; ``torch.bincount`` would read its input's maximum); a profile shows
any read as an ``aten::_local_scalar_dense`` or a blocking CUDA call inside
``cse/ctx.encode``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import zlib

import torch
import torch.nn.functional as F

from cse_tpu_torch.compat.safetensors_io import SafetensorsFile
from cse_tpu_torch.core.device import resolve_device
from cse_tpu_torch.ops.mla import attention_bias, first_real, mla_attention, mla_attention_plain, tile_counts
from cse_tpu_torch.utils.profiling import DeviceCounters, span

SWIGLU = ("gate_proj", "up_proj", "down_proj")


@dataclasses.dataclass(frozen=True)
class Yarn:
    """``rope_scaling`` of type ``yarn``."""

    factor: float = 40.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    """The keys of a ``deepseek_v2`` ``config.json`` that the prefill reads
    (DeepSeek-V2-Lite's values by default)."""

    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: Yarn | None = Yarn()
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    initializer_range: float = 0.02

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe(self, i: int) -> bool:
        return bool(self.n_routed_experts) and i >= self.first_k_dense_replace and i % self.moe_layer_freq == 0

    @classmethod
    def from_dict(cls, d: dict) -> "DeepseekV2Config":
        """A ``config.json`` dict; raises for a variant this prefill does not
        compute (q LoRA, group-limited routing, another scoring or activation,
        attention biases, another rope scaling)."""
        unsupported = {"q_lora_rank": (None,), "topk_method": ("greedy",), "scoring_func": ("softmax",),
                       "hidden_act": ("silu",), "attention_bias": (False,)}
        for key, ok in unsupported.items():
            if d.get(key, ok[0]) not in ok:
                raise ValueError(f"deepseek_v2: {key}={d[key]!r} is not supported (only {ok[0]!r})")
        rs = d.get("rope_scaling")
        yarn = None
        if rs is not None:
            kind = rs.get("type", rs.get("rope_type"))
            if kind != "yarn":
                raise ValueError(f"deepseek_v2: rope_scaling type {kind!r} is not supported (only 'yarn')")
            yarn = Yarn(**{f.name: rs[f.name] for f in dataclasses.fields(Yarn) if f.name in rs})
        names = {f.name for f in dataclasses.fields(cls)} - {"rope_scaling"}
        return cls(**{k: d[k] for k in names if k in d}, rope_scaling=yarn)

    @classmethod
    def from_json(cls, path: str) -> "DeepseekV2Config":
        """From ``path/config.json`` (or ``path`` itself if it is the file)."""
        if os.path.isdir(path):
            path = os.path.join(path, "config.json")
        with open(path) as f:
            return cls.from_dict(json.load(f))


# ---------------------------------------------------------------- positions


def yarn_mscale(scale: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0


def softmax_scale(cfg: DeepseekV2Config) -> float:
    """``qk_head_dim^-1/2``, times ``mscale(factor, mscale_all_dim)^2`` under YaRN."""
    s = cfg.qk_head_dim ** -0.5
    y = cfg.rope_scaling
    if y is not None and y.mscale_all_dim:
        s *= yarn_mscale(y.factor, y.mscale_all_dim) ** 2
    return s


def yarn_inv_freq(cfg: DeepseekV2Config, device=None) -> torch.Tensor:
    """The rope part's inverse frequencies [qk_rope / 2] in fp32 (plain RoPE
    without ``rope_scaling``)."""
    d, base = cfg.qk_rope_head_dim, cfg.rope_theta
    extra = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))
    y = cfg.rope_scaling
    if y is None:
        return extra
    inter = 1.0 / (y.factor * base ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))

    def dim_of(rotations):
        return d * math.log(y.original_max_position_embeddings / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(dim_of(y.beta_fast)), 0)
    high = min(math.ceil(dim_of(y.beta_slow)), d - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float32, device=device) - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp  # 1: the original frequency, 0: the scaled one
    return inter * (1 - keep) + extra * keep


def rope_mscale(cfg: DeepseekV2Config) -> float:
    y = cfg.rope_scaling
    return 1.0 if y is None else yarn_mscale(y.factor, y.mscale) / yarn_mscale(y.factor, y.mscale_all_dim)


def positions(mask: torch.Tensor) -> torch.Tensor:
    """Each token's position counted from its row's first real token; pads
    before it get 0."""
    return (torch.cumsum(mask.long(), dim=1) - 1).clamp_min(0)


def rope_tables(pos: torch.Tensor, cfg: DeepseekV2Config, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [B, 1, T, qk_rope / 2] at positions ``pos`` [B, T], times
    the rope mscale, computed in fp32 and cast to ``dtype``."""
    ang = pos.float()[..., None] * yarn_inv_freq(cfg, pos.device)
    m = rope_mscale(cfg)
    return (torch.cos(ang) * m).to(dtype)[:, None], (torch.sin(ang) * m).to(dtype)[:, None]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate each adjacent pair (2i, 2i+1) of x [B, H, T, d] by angle i;
    the result in de-interleaved order (evens' outputs, then odds'), as
    DeepSeek's ``apply_rotary_pos_emb`` gives it."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------- layers


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """w * x / rms(x), the statistics and the scaling in fp32, rounded to x's
    dtype before w; the mean of squares from one fp32 read of x (no fp32
    copy of x is kept)."""
    var = torch.linalg.vector_norm(x, dim=-1, keepdim=True, dtype=torch.float32).square_().div_(x.shape[-1])
    return w * (x * torch.rsqrt(var + eps)).to(x.dtype)


def mla(h: torch.Tensor, lp: dict, cfg: DeepseekV2Config, cos, sin, bias=None, first=None) -> torch.Tensor:
    """Latent attention of the normed h [B, T, D] -> [B, T, D]: on the card
    the kernel under ``first`` (each row's first real token, int32 [B]), on
    the CPU the plain twin under ``bias`` (:func:`attention_bias`)."""
    B, T, _ = h.shape
    H, dn, dr, dv, r = (cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim,
                        cfg.kv_lora_rank)
    q = F.linear(h, lp["q"])
    q_pe = q.view(B, T, H, dn + dr)[..., dn:].transpose(1, 2)
    q_pe.copy_(apply_rope(q_pe, cos, sin))  # in place: q stays q_proj's [B, T, H (dn + dr)]
    latent, k_pe = F.linear(h, lp["kv_a"]).split([r, dr], dim=-1)
    kv = F.linear(rms_norm(latent, lp["kv_ln"], cfg.rms_norm_eps), lp["kv_b"])
    k_pe = apply_rope(k_pe.view(B, 1, T, dr), cos, sin).view(B, T, dr)
    widths = (dn, dr, dv)
    if h.is_cuda:
        o = mla_attention(q, kv, k_pe, first, softmax_scale(cfg), widths)
    else:
        o = mla_attention_plain(q, kv, k_pe, bias, softmax_scale(cfg), widths)
    return F.linear(o, lp["o"])


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    return F.linear(F.silu(F.linear(x, gate)) * F.linear(x, up), down)


def route(x: torch.Tensor, router: torch.Tensor, cfg: DeepseekV2Config) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 softmax over the experts, greedy top-k: (weights fp32 [N, k],
    experts [N, k])."""
    scores = torch.softmax(F.linear(x.float(), router.float()), dim=-1)
    w, idx = torch.topk(scores, cfg.num_experts_per_tok, dim=-1)
    if cfg.norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return w * cfg.routed_scaling_factor, idx


def _grouped(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows [offs[e-1], offs[e]) of x times expert e's ``w[e]`` [out, in], one grouped product."""
    return torch._grouped_mm(x, w.transpose(-1, -2), offs=offs)


def moe(h: torch.Tensor, lp: dict, cfg: DeepseekV2Config, layer: int, counters=None, routes=None) -> torch.Tensor:
    """The mixture of experts on h [B, T, D]: routed top-k plus the shared
    experts. ``routes``: a list that gets the experts each token chose [B T, k]."""
    B, T, D = h.shape
    x = h.reshape(B * T, D)
    shape = {"B": B, "T": T}
    with span("ctx.moe.route", shape):
        w, idx = route(x, lp["router"], cfg)
        if routes is not None:
            routes.append(idx)
        k = idx.shape[1]
        flat = idx.reshape(-1)
        order = torch.argsort(flat, stable=True)
        # (bincount would read the largest expert index back to size its output: a host sync a layer)
        counts = torch.zeros(lp["experts_gate"].shape[0], dtype=torch.int64, device=x.device).scatter_add_(
            0, flat, torch.ones_like(flat))
        offs = torch.cumsum(counts, 0).to(torch.int32)
        xs = x.index_select(0, order // k)
        if counters is not None:
            counters.add(f"expert_tokens.{layer}", counts)
    with span("ctx.moe.experts", shape):
        a = F.silu(_grouped(xs, lp["experts_gate"], offs)) * _grouped(xs, lp["experts_up"], offs)
        y = _grouped(a, lp["experts_down"], offs)
        slots = torch.empty_like(y).index_copy_(0, order, y)
        routed = (slots.view(B * T, k, D).float() * w[..., None]).sum(dim=1).to(x.dtype)
    with span("ctx.moe.shared", shape):
        return (routed + swiglu(x, lp["shared_gate"], lp["shared_up"], lp["shared_down"])).view(B, T, D)


@torch.no_grad()
def deepseek_v2_forward(params: dict, ids: torch.Tensor, mask: torch.Tensor, cfg: DeepseekV2Config,
                        counters=None, routes=None) -> torch.Tensor:
    """ids, mask [B, T] (left padding) -> the final-normed hidden state
    [B, T, hidden] in the weights' dtype. ``routes``: a list that gets each
    MoE layer's top-k experts of every token, [B T, k] (padding included)."""
    with span("ctx.encode"):
        embed = params["embed"]
        dev = embed.device
        ids, mask = ids.to(dev), mask.to(dev)
        B, T = ids.shape
        with span("ctx.embed"):
            x = embed[ids.long()]
            cos, sin = rope_tables(positions(mask), cfg, x.dtype)
            # the card's kernel takes each row's first real token; the CPU's plain twin the bias
            on_card = dev.type == "cuda"
            first = first_real(mask) if on_card else None
            bias = None if on_card else attention_bias(mask)
            if counters is not None:
                real = mask.bool().sum()
                counters.add("tokens_real", real)
                counters.add("tokens_padded", B * T - real)
                if on_card:
                    run, skipped = tile_counts(first, T)
                    per = cfg.num_attention_heads * cfg.num_hidden_layers
                    counters.add("mla.tiles_run", run * per)
                    counters.add("mla.tiles_skipped", skipped * per)
        eps = cfg.rms_norm_eps
        for i, lp in enumerate(params["layers"]):
            with span("ctx.mla", {"B": B, "T": T}):
                x = x + mla(rms_norm(x, lp["input_ln"], eps), lp, cfg, cos, sin, bias, first)
            h = rms_norm(x, lp["post_ln"], eps)
            if "router" in lp:
                x = x + moe(h, lp, cfg, i, counters, routes)
            else:
                with span("ctx.dense_mlp"):
                    x = x + swiglu(h, lp["gate"], lp["up"], lp["down"])
        return rms_norm(x, params["final_ln"], eps)


# ---------------------------------------------------------------- weights


def hf_shapes(cfg: DeepseekV2Config) -> dict[str, tuple[int, ...]]:
    """Every tensor of a checkout that the prefill reads, by name, with its
    shape (``[out, in]`` for a matrix); the LM head is not one of them."""
    D, H, r = cfg.hidden_size, cfg.num_attention_heads, cfg.kv_lora_rank

    def swiglu(prefix, width):
        return {f"{prefix}.gate_proj.weight": (width, D), f"{prefix}.up_proj.weight": (width, D),
                f"{prefix}.down_proj.weight": (D, width)}

    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, D), "model.norm.weight": (D,)}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        a = f"{p}.self_attn"
        shapes.update({f"{p}.input_layernorm.weight": (D,), f"{p}.post_attention_layernorm.weight": (D,),
                       f"{a}.q_proj.weight": (H * cfg.qk_head_dim, D),
                       f"{a}.kv_a_proj_with_mqa.weight": (r + cfg.qk_rope_head_dim, D),
                       f"{a}.kv_a_layernorm.weight": (r,),
                       f"{a}.kv_b_proj.weight": (H * (cfg.qk_nope_head_dim + cfg.v_head_dim), r),
                       f"{a}.o_proj.weight": (D, H * cfg.v_head_dim)})
        if cfg.is_moe(i):
            shapes[f"{p}.mlp.gate.weight"] = (cfg.n_routed_experts, D)
            for e in range(cfg.n_routed_experts):
                shapes.update(swiglu(f"{p}.mlp.experts.{e}", cfg.moe_intermediate_size))
            shapes.update(swiglu(f"{p}.mlp.shared_experts", cfg.moe_intermediate_size * cfg.n_shared_experts))
        else:
            shapes.update(swiglu(f"{p}.mlp", cfg.intermediate_size))
    return shapes


def hf_names(cfg: DeepseekV2Config) -> list[str]:
    """Every tensor name of a checkout that the prefill reads (the LM head
    is not one of them)."""
    return list(hf_shapes(cfg))


def params_from_state_dict(get, cfg: DeepseekV2Config, dtype=torch.bfloat16, device=None) -> dict:
    """The prefill's weight dict from ``get(name)`` -> a tensor under
    DeepSeek's names (:func:`hf_names`), each moved to ``device`` in
    ``dtype`` as it is read; the router is kept in fp32 (an exact upcast of
    a bf16 checkout). Each routed expert matrix is copied into its layer's
    stack ``[E, out, in]`` and not kept otherwise, so a ``get`` that hands
    over its tensor (``dict.pop``) holds the model once."""
    dev = resolve_device(device)

    def t(name, to=dtype):
        return get(name).to(device=dev, dtype=to)

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        a = f"{p}.self_attn"
        lp = {"input_ln": t(f"{p}.input_layernorm.weight"), "post_ln": t(f"{p}.post_attention_layernorm.weight"),
              "q": t(f"{a}.q_proj.weight"), "kv_a": t(f"{a}.kv_a_proj_with_mqa.weight"),
              "kv_ln": t(f"{a}.kv_a_layernorm.weight"), "kv_b": t(f"{a}.kv_b_proj.weight"),
              "o": t(f"{a}.o_proj.weight")}
        if cfg.is_moe(i):
            lp["router"] = t(f"{p}.mlp.gate.weight", torch.float32)
            for n in SWIGLU:
                first = t(f"{p}.mlp.experts.0.{n}.weight")
                stack = torch.empty((cfg.n_routed_experts, *first.shape), dtype=dtype, device=dev)
                stack[0].copy_(first)
                del first
                for e in range(1, cfg.n_routed_experts):
                    stack[e].copy_(t(f"{p}.mlp.experts.{e}.{n}.weight"))
                lp[f"experts_{n.split('_')[0]}"] = stack
                lp[f"shared_{n.split('_')[0]}"] = t(f"{p}.mlp.shared_experts.{n}.weight")
        else:
            lp.update({n.split("_")[0]: t(f"{p}.mlp.{n}.weight") for n in SWIGLU})
        layers.append(lp)
    return {"embed": t("model.embed_tokens.weight"), "final_ln": t("model.norm.weight"), "layers": layers}


def load_deepseek_v2_params(path: str, dtype=torch.bfloat16, device=None) -> tuple[dict, DeepseekV2Config]:
    """A local checkout (``config.json`` + ``*.safetensors``, DeepSeek's
    names) read one tensor at a time (:mod:`compat.safetensors_io`) onto
    ``device`` (the card unless ``device="cpu"``)."""
    cfg = DeepseekV2Config.from_json(path)
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    where = {}
    for f in files:
        h = SafetensorsFile(f)
        where.update({k: h for k in h.keys()})
    missing = [n for n in hf_names(cfg) if n not in where]
    if missing:
        raise KeyError(f"{path}: {len(missing)} tensors missing, e.g. {missing[:3]}")
    return params_from_state_dict(lambda n: where[n].get(n), cfg, dtype, device), cfg


def random_deepseek_v2_params(cfg: DeepseekV2Config, dtype=torch.bfloat16, seed: int = 0, device=None) -> dict:
    """Seeded weights in the prefill's layout (:func:`params_from_state_dict`),
    drawn on ``device`` (the card unless ``device="cpu"``) one tensor at a
    time as it is read, so that the model is held once. Each tensor, under
    DeepSeek's name, has its own generator, seeded from ``seed`` and the
    crc32 of the name: matrices and the embedding N(0, initializer_range^2)
    in ``dtype``, norm scales 1; the router as the others, then upcast."""
    dev = resolve_device(device)
    shapes = hf_shapes(cfg)

    def draw(name):
        shape = shapes[name]
        if len(shape) == 1:
            return torch.ones(shape, dtype=dtype, device=dev)
        crc = zlib.crc32(name.encode()) & 0x7FFFFFFF
        g = torch.Generator(device=dev).manual_seed((seed * 1_000_003 + crc) % (1 << 63))
        return torch.randn(shape, generator=g, dtype=dtype, device=dev) * cfg.initializer_range

    return params_from_state_dict(draw, cfg, dtype, dev)


class DeepseekV2ContextEncoder(torch.nn.Module):
    """Frozen DeepSeek-V2 prefill -> the last ``ctx_length`` hidden states,
    fp32 ``[B, ctx_length, hidden]`` (``LlamaContextEncoder``'s contract;
    left padding puts those at the end). Built from a checkout ``path`` or
    from ``params`` and ``cfg`` directly; the weights are a dict of frozen
    tensors on ``device`` (the card unless ``device="cpu"``). ``counters``
    (:class:`DeviceCounters`, made here) accumulates over every call."""

    is_stub = False

    def __init__(self, path: str | None = None, ctx_length: int = 1, dtype=torch.bfloat16, device=None,
                 params: dict | None = None, cfg: DeepseekV2Config | None = None):
        super().__init__()
        if params is None:
            params, cfg = load_deepseek_v2_params(path, dtype=dtype, device=device)
        self.params, self.cfg = params, cfg
        self.ctx_length = ctx_length
        self.counters = DeviceCounters()

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return deepseek_v2_forward(self.params, ids, mask, self.cfg, self.counters)[:, -self.ctx_length:].float()

    def pure(self):
        """(apply(params, ids, mask), params), the signature the train and
        eval steps thread; params is the weight dict itself (no copy)."""
        cfg, ctx_length, counters = self.cfg, self.ctx_length, self.counters

        def apply(params, ids, mask):
            return deepseek_v2_forward(params, ids, mask, cfg, counters)[:, -ctx_length:].float()

        return apply, self.params
