"""Llama-3 in PyTorch: the frozen dialog-history encoder and causal-LM scoring.

Port of ``cse_tpu/models/llama.py``. The reference conditions every CSE model
on a frozen ``transformers.LlamaModel`` (``train_ContSep.py:163-165,379-380``)
and scores cascaded transcripts with ``LlamaForCausalLM``
(``test_cascaded.py:111,230``). Both are one prefill, no generation: token
embedding -> per layer (RMSNorm, GQA attention with RoPE, SwiGLU MLP) ->
final RMSNorm [-> LM head].

The weights keep the JAX package's layout: a dict whose ``layers`` entry
stacks each layer matrix as ``[n_layers, din, dout]`` (the forward indexes
layer i, a view). They are frozen (``requires_grad=False``). ``quant="int8"``
stores the seven layer matrices as per-output-channel int8 ``{"w", "s"}``
(weight-only: the product runs in the activation dtype on ``w.to(dtype)``,
a copy of the matrix for each call on the card, and the scale multiplies the
product); ``quant="w8a8"`` stores the same payload as ``{"w8", "s"}`` and
also quantizes the activations per token, so the product runs int8 x int8
-> int32 (``torch._int_mm``). Payloads and scales equal the JAX package's
bit for bit.

The forward computes the JAX function, not HF's: a finite ``-1e30`` bias for
causal masking and key padding together (a pad query, every key masked,
still gets a finite softmax row, where ``-inf`` or a boolean mask would give
NaN and spread it through P·V to real rows), plain products with an fp32
softmax, positions ``arange(T)`` over the padded width, RoPE in the
half-split convention with cos and sin cast to the activation dtype, and
GQA as ``repeat_interleave`` of the key-value heads.

Tensor parallelism over a mesh's model axis (``core/mesh.py``), Megatron
style as ``llama_shardings`` lays it out: each rank holds a block of the
vocabulary of ``embed`` and of ``lm_head``'s columns, the columns of ``q``,
``k``, ``v``, ``gate`` and ``up``, and the rows of ``o`` and ``down``. The
forward then makes the reductions GSPMD inserts in the JAX package explicit:
the masked local lookup of ``embed`` and the row-sharded products are summed
over the model group, and the logits are gathered over it. Unlike JAX's
literal column split, a rank holds the key-value heads its own query heads
read (query head j reads kv head j // (H / KV)), so where KV < n_model a
kv head sits on several ranks. The int8 scales follow their matrix's output
axis (replicated for ``o`` and ``down``). Under w8a8 the row-sharded inputs
take the row max over the group before they are quantized and the int32
accumulators are summed over it, so the result has the unsharded bits.

Weights load from a local HF checkout (``config.json`` + ``*.safetensors``)
through :mod:`cse_tpu_torch.compat.safetensors_io`, one tensor at a time.
Everything runs on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import zlib

import torch
import torch.distributed as dist
import torch.nn.functional as F

from cse_tpu_torch.compat.safetensors_io import SafetensorsFile
from cse_tpu_torch.core.device import resolve_device
from cse_tpu_torch.core.mesh import MODEL_AXIS

LAYER_MATRICES = ("q", "k", "v", "o", "gate", "up", "down")
_HF_NAMES = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj", "down": "mlp.down_proj"}
# torch._int_mm on the card takes more than 16 rows: a product of 16 or fewer is padded
# with zero rows to INT_MM_PAD_ROWS (a whole number of 16-row tiles)
INT_MM_PAD_ROWS = 32


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    tie_word_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_json(cls, path: str) -> "LlamaConfig":
        with open(os.path.join(path, "config.json")) as f:
            d = json.load(f)
        return cls(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            num_key_value_heads=d.get("num_key_value_heads", d["num_attention_heads"]),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            rope_theta=d.get("rope_theta", 10000.0),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
        )


def _const(x: torch.Tensor, v: float) -> torch.Tensor:
    """``v`` as a 0-d fp32 tensor on ``x``'s device: PyTorch on the card
    divides by a Python scalar as a multiply by its reciprocal, by a tensor
    exactly, as JAX does."""
    return torch.full((), v, dtype=torch.float32, device=x.device)


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in place (nothing when ``group`` is None)."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def _mm(h: torch.Tensor, w, group=None) -> torch.Tensor:
    """h @ w for a plain tensor or one of the two int8 dict forms:
    ``{"w": int8 [din, dout], "s": f32 [1, dout]}`` (weight-only: the payload
    converts to h's dtype, the per-output-channel scale multiplies the
    product) and ``{"w8": int8, "s": f32}`` (w8a8, :func:`_mm_w8a8`).
    ``group``: ``w`` is this rank's block of rows and ``h`` its block of
    columns; the partial products are summed over the group (before the
    scale)."""
    if isinstance(w, dict):
        if "w8" in w:
            return _mm_w8a8(h, w["w8"], w["s"], group)
        return _sum(h @ w["w"].to(h.dtype), group) * w["s"].to(h.dtype)
    return _sum(h @ w, group)


def _mm_w8a8(h: torch.Tensor, w8: torch.Tensor, s: torch.Tensor, group=None) -> torch.Tensor:
    """Dynamic-activation int8 product: each token row of ``h`` quantizes to
    symmetric int8 with its own scale sa = max(rowmax|h|, 1e-12) / 127 (|h| /
    sa <= 127, so no clip), int8 x int8 -> int32 (``torch._int_mm``), then
    ``acc * sa * s`` in fp32, cast to h's dtype. A product of at most 16
    rows is padded with zero rows (the card's ``_int_mm`` takes more than 16).
    ``group`` (``h`` a block of the row's columns): the row max is the max
    over the group and the int32 accumulators are summed over it."""
    hf = h.float()
    amax = hf.abs().amax(dim=-1, keepdim=True)
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    sa = amax.clamp_min(1e-12) / _const(h, 127.0)
    hq = torch.round(hf / sa).to(torch.int8)
    lead, K = hq.shape[:-1], hq.shape[-1]
    a = hq.reshape(-1, K)
    M = a.shape[0]
    if M <= 16:
        a = torch.cat([a, a.new_zeros(INT_MM_PAD_ROWS - M, K)])
    acc = _sum(torch._int_mm(a, w8)[:M].reshape(*lead, w8.shape[-1]), group)
    return (acc.float() * sa * s.float()).to(h.dtype)


def quantize_llama_params(params: dict, mode: str = "int8") -> dict:
    """Per-output-channel symmetric int8 quantization of the seven stacked
    layer matrices; embeddings, norms and the LM head keep their dtype. Each
    ``[L, din, dout]`` weight becomes ``{"w": int8, "s": f32 [L, 1, dout]}``
    with s = max(max|w| over din / 127, 1e-12) and w = clip(round(w / s),
    -127, 127), in fp32 on the weight's device. ``mode="w8a8"`` stores the
    same payload under ``"w8"``."""
    if mode not in ("int8", "w8a8"):
        raise ValueError(f"unknown quant mode {mode!r} ('int8' or 'w8a8')")
    out = dict(params)
    out["layers"] = dict(params["layers"])
    for name in LAYER_MATRICES:
        out["layers"][name] = _quantize(params["layers"][name], mode)
    return out


def _quantize(w: torch.Tensor, mode: str) -> dict:
    w = w.float()
    s = (w.abs().amax(dim=-2, keepdim=True) / _const(w, 127.0)).clamp_min(1e-12)
    q = torch.round(w / s).clamp(-127, 127).to(torch.int8)
    if mode == "int8":
        return {"w": q, "s": s}
    return {"w8": _k_major(q), "s": s}


def _k_major(w8: torch.Tensor) -> torch.Tensor:
    """``w8 [..., K, N]`` (the same values) stored K-major, a transposed view
    of a contiguous ``[..., N, K]``: the layout the card's ``torch._int_mm``
    takes for its second operand (cuBLASLt's int8 "TN" form)."""
    return w8.transpose(-1, -2).contiguous().transpose(-1, -2)


def _inv_freq(dh: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, dh, 2, dtype=torch.float32, device=device) / torch.full(
        (), float(dh), device=device)
    return 1.0 / (theta ** exponent)


def _rope_tables(T: int, dh: int, theta: float, dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """RoPE's cos and sin [1, 1, T, dh/2] at positions ``arange(T)``, cast
    to the activation dtype ``dtype`` (JAX's ``_rope``, taken once for every
    layer)."""
    ang = torch.arange(T, device=device, dtype=torch.float32)[:, None] * _inv_freq(dh, theta, device)
    return torch.cos(ang).to(dtype)[None, None], torch.sin(ang).to(dtype)[None, None]


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of x [B, H, T, dh], HF half-split convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer(params: dict, i: int) -> dict:
    """Layer i's weights: views of the stacked tensors."""
    return {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict) else v[i])
            for k, v in params["layers"].items()}


@dataclasses.dataclass(frozen=True)
class _Rank:
    """A rank's part of the tensor-parallel forward: its model group, its
    query and key-value heads, the local kv head each local query head
    reads, and the first vocabulary row it holds."""

    group: object
    heads: int
    kv_heads: int
    kv_index: torch.Tensor
    vocab0: int


def _kv_heads(cfg: LlamaConfig, m: int, n: int) -> tuple[int, int]:
    """The kv heads [lo, hi) that model rank m of n reads: its query heads
    are the m-th block of H / n, and query head j reads kv head j // (H / KV)."""
    H, KV = cfg.num_attention_heads, cfg.num_key_value_heads
    if H % n:
        raise ValueError(f"{H} query heads do not split over {n} model ranks")
    per, rep = H // n, H // KV
    return (m * per) // rep, ((m + 1) * per - 1) // rep + 1


def _rank_of(cfg: LlamaConfig, mesh, vocab_rows: int, device) -> _Rank | None:
    if mesh is None or mesh.n_model == 1:
        return None
    m, n = mesh.model_index, mesh.n_model
    H, KV = cfg.num_attention_heads, cfg.num_key_value_heads
    lo, hi = _kv_heads(cfg, m, n)
    per = H // n
    kv_index = torch.tensor([(m * per + j) // (H // KV) - lo for j in range(per)], device=device)
    return _Rank(mesh.model_group, per, hi - lo, kv_index, m * vocab_rows)


@torch.no_grad()
def llama_forward(params: dict, ids: torch.Tensor, mask: torch.Tensor, cfg: LlamaConfig,
                  return_logits: bool = False, mesh=None) -> torch.Tensor:
    """ids, mask [B, T] -> last hidden state [B, T, D] in the weights' float
    dtype, or fp32 logits [B, T, V]. ``mesh``: ``params`` are this rank's
    shards (:func:`llama_shardings`) and the forward runs tensor-parallel
    over the mesh's model group; every rank of the group returns the whole
    result."""
    embed = params["embed"]
    dev = embed.device
    ids, mask = ids.to(dev), mask.to(dev)
    B, T = ids.shape
    H, KV, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    tp = _rank_of(cfg, mesh, embed.shape[0], dev)
    group = None if tp is None else tp.group
    if tp is None:
        x = embed[ids.long()]
    else:  # vocab-sharded: the rows this rank holds, zeros elsewhere, summed over the group
        H, KV = tp.heads, tp.kv_heads
        local = ids.long() - tp.vocab0
        hit = (local >= 0) & (local < embed.shape[0])
        x = _sum(torch.where(hit[..., None], embed[local.clamp(0, embed.shape[0] - 1)], 0), group)
    cos, sin = _rope_tables(T, dh, cfg.rope_theta, x.dtype, dev)
    # additive attention bias: causal + key padding, finite (see the module docstring)
    causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    keep = mask.bool()[:, None, None, :] & causal
    bias = torch.where(keep, 0.0, -1e30).float()
    root_dh = _const(x, math.sqrt(dh))
    for i in range(cfg.num_hidden_layers):
        lp = _layer(params, i)
        h = _rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
        q = _mm(h, lp["q"]).reshape(B, T, H, dh).transpose(1, 2)
        k = _mm(h, lp["k"]).reshape(B, T, KV, dh).transpose(1, 2)
        v = _mm(h, lp["v"]).reshape(B, T, KV, dh).transpose(1, 2)
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)
        if tp is not None:  # the kv head each of this rank's query heads reads
            k = k.index_select(1, tp.kv_index)
            v = v.index_select(1, tp.kv_index)
        elif KV != H:  # grouped-query: each kv head serves H / KV query heads in a row
            k = k.repeat_interleave(H // KV, dim=1)
            v = v.repeat_interleave(H // KV, dim=1)
        logits = torch.matmul(q, k.transpose(-1, -2)).float() / root_dh + bias
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        attn = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, H * dh)
        x = x + _mm(attn, lp["o"], group)
        h = _rms_norm(x, lp["post_ln"], cfg.rms_norm_eps)
        x = x + _mm(F.silu(_mm(h, lp["gate"])) * _mm(h, lp["up"]), lp["down"], group)
    x = _rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
    if return_logits:
        head = params["lm_head"] if "lm_head" in params else embed.t()
        logits = (x @ head).float()
        if tp is None:
            return logits
        blocks = [torch.empty_like(logits) for _ in range(mesh.n_model)]
        dist.all_gather(blocks, logits, group=group)  # the vocabulary blocks in model-rank order
        return torch.cat(blocks, dim=-1)
    return x


# --------------------------------------------------------------------------
# weights and their tensor-parallel layout
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's layout over a mesh: for each dimension the mesh axis it is
    split over (``MODEL_AXIS``), or None where every rank holds it whole."""

    mesh: object
    spec: tuple


def llama_shardings(mesh) -> dict:
    """Megatron-style tensor parallelism over the mesh's model axis for the
    stacked layout (the JAX package's specs): ``embed`` split over the
    vocabulary, ``lm_head`` and ``q``, ``k``, ``v``, ``gate``, ``up`` over
    their output columns, ``o`` and ``down`` over their input rows. ``k`` and
    ``v`` split by the query heads that read them (:func:`_kv_heads`)."""
    def ns(*spec):
        return Sharding(mesh, spec)

    col, row = ns(None, None, MODEL_AXIS), ns(None, MODEL_AXIS, None)
    return {
        "embed": ns(MODEL_AXIS, None),
        "final_ln": ns(None),
        "lm_head": ns(None, MODEL_AXIS),
        "layers": {"input_ln": ns(None, None), "post_ln": ns(None, None), "q": col, "k": col, "v": col,
                   "o": row, "gate": col, "up": col, "down": row},
    }


def _lookup(tree: dict, path: tuple) -> Sharding:
    """The sharding of the leaf at ``path`` (keys, e.g. ``("layers", "o",
    "s")``). An int8 scale ``[L, 1, dout]`` takes only its matrix's output
    axis: the shards of a row-sharded ``o`` / ``down`` are partial sums over
    the whole dout, so their scales are held whole."""
    node = tree
    for key in path:
        if isinstance(node, dict) and key in node:
            node = node[key]
    if path[-1] == "s" and isinstance(node, Sharding):
        out_axis = node.spec[2] if len(node.spec) > 2 else None
        return Sharding(node.mesh, (None, None, out_axis))
    return node


def _placer(cfg: LlamaConfig, mesh):
    """``put(path, leaf)``: this rank's block of a leaf (or of each entry of
    an int8 dict leaf), a tensor of its own; the leaf itself without a model
    axis to split over."""
    if mesh is None or mesh.n_model == 1:
        return lambda path, leaf: leaf
    tree, m, n = llama_shardings(mesh), mesh.model_index, mesh.n_model

    def put(path, leaf):
        if isinstance(leaf, dict):
            return {k: put(path + (k,), v) for k, v in leaf.items()}
        x = leaf
        for dim, axis in enumerate(_lookup(tree, path).spec):
            if axis != MODEL_AXIS:
                continue
            if path[:2] in (("layers", "k"), ("layers", "v")):
                lo, hi = (h * cfg.head_dim for h in _kv_heads(cfg, m, n))
            elif x.shape[dim] % n:
                raise ValueError(f"{'/'.join(path)}: dimension {dim} ({x.shape[dim]}) does not split over {n} ranks")
            else:
                lo, hi = m * x.shape[dim] // n, (m + 1) * x.shape[dim] // n
            x = x.narrow(dim, lo, hi - lo)
        if x is leaf:
            return leaf
        if path[-1] == "w8":  # a fresh K-major payload (see _k_major)
            return x.transpose(-1, -2).clone(memory_format=torch.contiguous_format).transpose(-1, -2)
        return x.clone(memory_format=torch.contiguous_format)

    return put


def load_llama_params(path: str, dtype=torch.bfloat16, quant: str | None = None,
                      device=None, mesh=None) -> tuple[dict, LlamaConfig]:
    """Load a local HF Llama checkout into the stacked layout on ``device``
    (the card unless ``device="cpu"``). Each tensor is read from its file's
    mapping, moved to the device and transposed into its stacked slot there;
    ``quant`` ("int8" or "w8a8") quantizes each stacked matrix on the device
    in fp32 as it is completed, so the full-precision stack of one matrix is
    the most that is ever held beside the payloads. ``mesh``: each leaf is
    cut to this rank's block (:func:`llama_shardings`) as it is completed,
    after quantization (the scales are those of the whole matrix)."""
    if quant not in (None, "int8", "w8a8"):
        raise ValueError(f"unknown quant mode {quant!r} ('int8' or 'w8a8')")
    dev = resolve_device(device)
    cfg = LlamaConfig.from_json(path)
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    where = {}  # tensor name -> the file that holds it
    for f in files:
        h = SafetensorsFile(f)
        where.update({k: h for k in h.keys()})

    def get(name, to=dtype):
        return where[name].get(name).to(device=dev, dtype=to)

    put = _placer(cfg, mesh)

    L = cfg.num_hidden_layers
    layers = {}
    for key, hf in (("input_ln", "input_layernorm"), ("post_ln", "post_attention_layernorm")):
        layers[key] = torch.stack([get(f"model.layers.{i}.{hf}.weight") for i in range(L)])
    to = torch.float32 if quant else dtype  # quantization reads fp32, as the JAX loader does
    for key in LAYER_MATRICES:
        stack = None
        for i in range(L):
            w = get(f"model.layers.{i}.{_HF_NAMES[key]}.weight", to).t()  # [dout, din] -> [din, dout]
            if stack is None:
                stack = torch.empty((L, *w.shape), dtype=to, device=dev)
            stack[i].copy_(w)
        layers[key] = put(("layers", key), _quantize(stack, quant) if quant else stack)
        del stack
    params = {"embed": put(("embed",), get("model.embed_tokens.weight")), "layers": layers,
              "final_ln": get("model.norm.weight")}
    if not cfg.tie_word_embeddings and "lm_head.weight" in where:
        params["lm_head"] = put(("lm_head",), get("lm_head.weight").t().contiguous())
    return params, cfg


def random_llama_params(cfg: LlamaConfig, dtype=torch.float32, seed: int = 0, quant: str | None = None,
                        with_lm_head: bool = True, device=None, mesh=None) -> dict:
    """Random weights in the stacked layout, drawn on ``device`` (the card
    unless ``device="cpu"``). Each leaf has its own generator, seeded from
    ``seed`` and the crc32 of its path ("layers/q/w", "embed", ...), as the
    JAX package derives its per-leaf keys, so shared leaves are the same with
    or without the LM head. The bits differ from ``jax.random``'s.

    ``quant`` ("int8" or "w8a8") draws int8 payloads uniform in [-127, 127]
    and fills the fp32 scales with the float form's scale / 42, never
    building full-precision layer matrices (the bench stands up the 32-layer
    8B shape this way). ``with_lm_head=False`` leaves the [D, vocab] head out.
    ``mesh``: each leaf is cut to this rank's block as it is drawn (the same
    values as the unsharded draw)."""
    if quant not in (None, "int8", "w8a8"):
        raise ValueError(f"unknown quant mode {quant!r} ('int8' or 'w8a8')")
    dev = resolve_device(device)
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    H, KV, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def gen(tag):
        crc = zlib.crc32(tag.encode()) & 0x7FFFFFFF
        return torch.Generator(device=dev).manual_seed((seed << 31) ^ crc)

    def normal(tag, shape, scale):
        return torch.randn(shape, generator=gen(tag), dtype=dtype, device=dev) * scale

    put = _placer(cfg, mesh)

    def w(tag, *shape, scale=None):
        return put(tuple(tag.split("/")), draw(tag, *shape, scale=scale))

    def draw(tag, *shape, scale=None):
        scale = scale or 1.0 / math.sqrt(shape[-2] if len(shape) > 1 else shape[0])
        if quant and len(shape) == 3:
            s = torch.full((shape[0], 1, shape[2]), scale / 42.0, dtype=torch.float32, device=dev)
            if quant == "int8":
                return {"w": torch.randint(-127, 128, shape, generator=gen(f"{tag}/w"), dtype=torch.int8,
                                           device=dev), "s": s}
            kn = (shape[0], shape[2], shape[1])  # drawn K-major (see _k_major)
            return {"w8": torch.randint(-127, 128, kn, generator=gen(f"{tag}/w8"), dtype=torch.int8,
                                        device=dev).transpose(-1, -2), "s": s}
        return normal(tag, shape, scale)

    params = {"embed": w("embed", cfg.vocab_size, D, scale=0.02),
              "final_ln": torch.ones(D, dtype=dtype, device=dev)}
    if with_lm_head:
        params["lm_head"] = w("lm_head", D, cfg.vocab_size)
    params["layers"] = {
        "input_ln": torch.ones(L, D, dtype=dtype, device=dev),
        "post_ln": torch.ones(L, D, dtype=dtype, device=dev),
        "q": w("layers/q", L, D, H * dh),
        "k": w("layers/k", L, D, KV * dh),
        "v": w("layers/v", L, D, KV * dh),
        "o": w("layers/o", L, H * dh, D),
        "gate": w("layers/gate", L, D, I),
        "up": w("layers/up", L, D, I),
        "down": w("layers/down", L, I, D),
    }
    return params


class LlamaContextEncoder(torch.nn.Module):
    """Frozen Llama prefill -> the last ``ctx_length`` hidden states, fp32
    ``[B, ctx_length, hidden]``.

    The reference reads ``last_hidden_state[:, -1:]`` (ContSep,
    ``train_ContSep.py:380``) or ``[:, -ctx_length:]`` (ContExt,
    ``train_ContExt.py:362``); left padding puts those at the end. The
    weights are a dict of frozen tensors on ``device`` (the card unless
    ``device="cpu"``), not parameters of the module; with a ``mesh``, this
    rank's shards, and every call runs tensor-parallel over its model group."""

    is_stub = False

    def __init__(self, path: str, ctx_length: int = 1, dtype=torch.bfloat16, quant: str | None = None,
                 device=None, mesh=None):
        super().__init__()
        self.params, self.cfg = load_llama_params(path, dtype=dtype, quant=quant, device=device, mesh=mesh)
        self.ctx_length = ctx_length
        self.mesh = mesh

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return llama_forward(self.params, ids, mask, self.cfg, mesh=self.mesh)[:, -self.ctx_length:].float()

    def pure(self):
        """(apply(params, ids, mask), params), the signature the train and
        eval steps thread; params is the weight dict itself (no copy)."""
        cfg, ctx_length, mesh = self.cfg, self.ctx_length, self.mesh

        def apply(params, ids, mask):
            return llama_forward(params, ids, mask, cfg, mesh=mesh)[:, -ctx_length:].float()

        return apply, self.params

    def score_logits(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Causal-LM logits [B, T, V] (fp32) for cascaded stream scoring."""
        return llama_forward(self.params, ids, mask, self.cfg, return_logits=True, mesh=self.mesh)
