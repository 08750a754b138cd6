"""Plain fp32 PyTorch reference of the DeepSeek-V2 history encoder, and its seeded weights.

A frozen copy of the mathematics of DeepSeek's ``modeling_deepseek.py``
prefill that the benchmark holds the port's encoder against. It imports
nothing of the port, of JAX or of ``transformers``: it works from the
published ``config.json`` keys (a dict) and a dict of weights under
DeepSeek's names, in fp32 with TF32 off.

* :func:`draw_weights` — the benchmark's seeded weights, bf16 on the device,
  one generator a tensor keyed by its name: matrices and the embedding
  N(0, s^2) for the configuration's ``initializer_range`` s (DeepSeek's
  0.02 where it names none), norm scales 1. The LM head is not drawn: the
  encoder reads hidden states only.
* :func:`encode` — each history alone and unpadded (positions 0..n-1), layer
  by layer: the layer's bf16 weights are upcast to fp32 once (exact) and
  every history goes through it before the next layer's are made, so the
  reference holds one fp32 layer beside the bf16 weights. Per layer: RMSNorm,
  latent attention (a query and the latent's keys and values per head, one
  rope key shared by the heads, YaRN-scaled rotary on adjacent pairs as
  complex numbers, causal softmax at the YaRN softmax scale), RMSNorm, then
  the dense SwiGLU or the mixture: fp32 softmax over the experts, greedy
  top-k, and for each token the sum over its k experts of weight x the
  expert's SwiGLU (computed expert by expert over the tokens that chose it),
  plus the shared experts. The tokens of all histories go through the
  token-wise products together; attention runs history by history.
  Returns each history's last final-normed hidden state.

With ``force`` the experts are not chosen: each token takes the k experts
given for it (another model's choices, as the program's), weighted by this
router's probabilities of them. The comparison that holds the program to its
own routes uses it, so that a route flipped by rounding near a tie is not
read as a gap of the mathematics.

``prec="fp8_experts"`` is the benchmark's control: every expert's weights
(the routed and the shared) rounded to float8 e4m3 with a scale per output
row, the rest as above.
"""

from __future__ import annotations

import math
import zlib

import torch

INIT_STD = 0.02
PRECISIONS = (None, "fp8_experts")
SWIGLU = ("gate_proj", "up_proj", "down_proj")


def fp32_only():
    """fp32 products everywhere: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def is_moe(enc: dict, i: int) -> bool:
    return bool(enc["n_routed_experts"]) and i >= enc["first_k_dense_replace"] and i % enc["moe_layer_freq"] == 0


def param_spec(enc: dict) -> list[tuple[str, tuple[int, ...]]]:
    """Every weight the prefill reads, as (DeepSeek's name, shape [out, in])."""
    D, H, r = enc["hidden_size"], enc["num_attention_heads"], enc["kv_lora_rank"]
    dn, dr, dv = enc["qk_nope_head_dim"], enc["qk_rope_head_dim"], enc["v_head_dim"]
    Ie, E = enc["moe_intermediate_size"], enc["n_routed_experts"]
    Is = Ie * enc["n_shared_experts"]

    def swiglu(prefix, width):
        return [(f"{prefix}.gate_proj.weight", (width, D)), (f"{prefix}.up_proj.weight", (width, D)),
                (f"{prefix}.down_proj.weight", (D, width))]

    spec = [("model.embed_tokens.weight", (enc["vocab_size"], D))]
    for i in range(enc["num_hidden_layers"]):
        p = f"model.layers.{i}"
        spec += [(f"{p}.input_layernorm.weight", (D,)), (f"{p}.post_attention_layernorm.weight", (D,)),
                 (f"{p}.self_attn.q_proj.weight", (H * (dn + dr), D)),
                 (f"{p}.self_attn.kv_a_proj_with_mqa.weight", (r + dr, D)),
                 (f"{p}.self_attn.kv_a_layernorm.weight", (r,)),
                 (f"{p}.self_attn.kv_b_proj.weight", (H * (dn + dv), r)),
                 (f"{p}.self_attn.o_proj.weight", (D, H * dv))]
        if is_moe(enc, i):
            spec.append((f"{p}.mlp.gate.weight", (E, D)))
            for e in range(E):
                spec += swiglu(f"{p}.mlp.experts.{e}", Ie)
            spec += swiglu(f"{p}.mlp.shared_experts", Is)
        else:
            spec += swiglu(f"{p}.mlp", enc["intermediate_size"])
    spec.append(("model.norm.weight", (D,)))
    return spec


def draw_weights(enc: dict, seed: int, device, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """The seeded weights (see the module docstring), the same for the same seed."""
    std = enc.get("initializer_range", INIT_STD)
    out = {}
    for name, shape in param_spec(enc):
        if len(shape) == 1:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        crc = zlib.crc32(name.encode()) & 0x7FFFFFFF
        g = torch.Generator(device=device).manual_seed((seed * 1_000_003 + crc) % (1 << 63))
        out[name] = torch.randn(shape, generator=g, dtype=dtype, device=device) * std
    return out


# ---------------------------------------------------------------- the mathematics


def _round_fp8_rows(w: torch.Tensor) -> torch.Tensor:
    s = w.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 448.0
    return (w / s).to(torch.float8_e4m3fn).float() * s


def _mscale(scale: float, m: float) -> float:
    return 0.1 * m * math.log(scale) + 1.0 if scale > 1 else 1.0


def yarn(enc: dict, device) -> tuple[torch.Tensor, float, float]:
    """(inverse frequencies [rope / 2], cos/sin multiplier, softmax scale)."""
    d, base = enc["qk_rope_head_dim"], float(enc["rope_theta"])
    scale = (enc["qk_nope_head_dim"] + d) ** -0.5
    j = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    freq = base ** -j
    rs = enc.get("rope_scaling")
    if rs is None:
        return freq, 1.0, scale
    f, orig = float(rs["factor"]), rs["original_max_position_embeddings"]

    def correction(rot):  # the dimension whose wavelength fits ``rot`` turns into the original context
        return d * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    lo, hi = max(math.floor(correction(rs["beta_fast"])), 0), min(math.ceil(correction(rs["beta_slow"])), d - 1)
    ramp = ((torch.arange(d // 2, dtype=torch.float32, device=device) - lo) / max(hi - lo, 1e-3)).clamp(0, 1)
    freq = (freq / f) * ramp + freq * (1 - ramp)
    m_all = rs.get("mscale_all_dim", 0)
    if m_all:
        scale *= _mscale(f, m_all) ** 2
    return freq, _mscale(f, rs.get("mscale", 1)) / _mscale(f, m_all), scale


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rotary(x, angles, m):
    """Adjacent pairs of x [..., n, d] as complex numbers times e^(i angle) m."""
    z = torch.view_as_complex(x.reshape(*x.shape[:-1], -1, 2).contiguous())
    return torch.view_as_real(z * torch.polar(torch.full_like(angles, m), angles)).flatten(-2)


def attention(h, L, enc, freq, m, scale):
    """Latent attention of one history's normed h [n, D] with layer weights L."""
    n = h.shape[0]
    H, r = enc["num_attention_heads"], enc["kv_lora_rank"]
    dn, dr, dv = enc["qk_nope_head_dim"], enc["qk_rope_head_dim"], enc["v_head_dim"]
    q = (h @ L["q"].t()).view(n, H, dn + dr).transpose(0, 1)  # [H, n, dn + dr]
    kv_a = h @ L["kv_a"].t()
    latent, k_rope = kv_a[:, :r], kv_a[:, r:]
    kv = (rms_norm(latent, L["kv_ln"], enc["rms_norm_eps"]) @ L["kv_b"].t()).view(n, H, dn + dv).transpose(0, 1)
    angles = torch.arange(n, dtype=torch.float32, device=h.device)[:, None] * freq
    q = torch.cat([q[..., :dn], rotary(q[..., dn:], angles, m)], dim=-1)
    k = torch.cat([kv[..., :dn], rotary(k_rope, angles, m).expand(H, n, dr)], dim=-1)
    s = (q @ k.transpose(-1, -2)) * scale
    s = s.masked_fill(torch.ones(n, n, dtype=torch.bool, device=h.device).triu(1), float("-inf"))
    o = torch.softmax(s, dim=-1) @ kv[..., dn:]
    return o.transpose(0, 1).reshape(n, H * dv) @ L["o"].t()


def swiglu(x, L, prefix=""):
    g, u, d = (L[f"{prefix}.{n}" if prefix else n] for n in SWIGLU)
    return (torch.nn.functional.silu(x @ g.t()) * (x @ u.t())) @ d.t()


def moe(x, L, enc, routes=None, force=None):
    """The mixture on x [N, D]; appends each token's top-k experts to
    ``routes``; ``force`` [N, k'] gives each token's experts instead."""
    k = enc["num_experts_per_tok"]
    scores = torch.softmax(x @ L["router"].t(), dim=-1)
    if force is None:
        top_w, top_e = torch.topk(scores, k, dim=-1)
    else:
        top_e = force.to(x.device).long()
        top_w = scores.gather(1, top_e)
    if enc["norm_topk_prob"]:
        top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-20)
    top_w = top_w * enc["routed_scaling_factor"]
    if routes is not None:
        routes.append(top_e)
    y = torch.zeros_like(x)
    for e in range(enc["n_routed_experts"]):
        tok, slot = (top_e == e).nonzero(as_tuple=True)
        if tok.numel():
            y.index_add_(0, tok, top_w[tok, slot, None] * swiglu(x[tok], L, f"experts.{e}"))
    return y + swiglu(x, L, "shared_experts")


def _layer(W, enc, i, prec):
    """Layer i's weights in fp32 under short names."""
    p = f"model.layers.{i}"
    L = {}
    for name, t in W.items():
        if name.startswith(p + "."):
            short = name[len(p) + 1:].removesuffix(".weight")
            short = short.replace("self_attn.", "").replace("mlp.", "")
            w = t.float()
            if prec == "fp8_experts" and (short.startswith("experts.") or short.startswith("shared_experts.")):
                w = _round_fp8_rows(w)
            L[short] = w
    L["q"], L["kv_a"], L["kv_ln"], L["kv_b"], L["o"] = (L.pop(k) for k in ("q_proj", "kv_a_proj_with_mqa",
                                                                             "kv_a_layernorm", "kv_b_proj", "o_proj"))
    if "gate" in L:
        L["router"] = L.pop("gate")
    return L


@torch.no_grad()
def encode(enc: dict, W: dict, histories: list[torch.Tensor], prec=None, routes=None, force=None) -> torch.Tensor:
    """Each history's (ids [n]) last final-normed hidden state, fp32 [len, D].
    ``routes``: a list that gets, per MoE layer, the top-k experts of every
    token of the histories in order ([sum n, k]); ``force``: such a list,
    the experts each token takes."""
    if prec not in PRECISIONS:
        raise ValueError(f"unknown precision {prec!r}")
    emb = W["model.embed_tokens.weight"]
    sizes = [int(h.numel()) for h in histories]
    x = torch.cat([emb[h.to(emb.device).long()] for h in histories]).float()
    freq, m, scale = yarn(enc, emb.device)
    eps = enc["rms_norm_eps"]
    layer = iter(force or [])
    for i in range(enc["num_hidden_layers"]):
        L = _layer(W, enc, i, prec)
        h = rms_norm(x, L["input_layernorm"], eps)
        x = x + torch.cat([attention(part, L, enc, freq, m, scale) for part in h.split(sizes)])
        h = rms_norm(x, L["post_attention_layernorm"], eps)
        x = x + (moe(h, L, enc, routes, next(layer) if force else None) if is_moe(enc, i) else swiglu(h, L))
        del L
    last = torch.cumsum(torch.tensor(sizes, device=x.device), 0) - 1
    return rms_norm(x[last], W["model.norm.weight"].float(), eps)
