"""cse_tpu_torch.models.deepseek_v2 (the DeepSeek-V2 history encoder) on the
CPU at a tiny size: hidden 64, 4 heads, latent 32, rope 16, nope 32, v 32,
8 experts, top-2, 1 shared, 3 layers with the first dense, DeepSeek-V2-Lite's
YaRN (factor 40, mscale 0.707).

Held against the benchmark's plain fp32 reference
(``perfbench/reference/deepseek_v2.py``, written from DeepSeek's published
code and independent of the port: its rotary works on complex pairs, its
experts run token by token's choices, each history alone and unpadded) on
the same seeded weights, and against ``transformers``' ``DeepseekV2Model``
where that applies.

Bars, fp32 on the CPU: the whole forward, MLA alone and the MoE alone within
rel L2 1e-5 of the reference (measured 1e-7 to 3e-7: the same mathematics,
only the summation order differs); ``transformers`` within 1e-5 on the real
positions (measured 9e-7). ``transformers`` 4.57 leaves DeepSeek's
mscale(factor, mscale_all_dim)^2 out of the softmax scale and pairs the rope
lanes its own way, so it is compared with ``rope_scaling`` None, where the
two models are the same function; YaRN is held against the reference and
the closed form. bf16 weights and products within rel L2 3e-2 of the fp32
forward (3 layers of bf16 rounding; measured below 1e-2). A history alone
and left-padded in a batch: within 1e-5 in fp32.
"""

import json
import math

import pytest
import torch

from cse_tpu_torch.models import deepseek_v2 as dv
from perfbench.reference import deepseek_v2 as ref

torch.set_num_threads(1)

TINY = {"vocab_size": 320, "hidden_size": 64, "intermediate_size": 128, "moe_intermediate_size": 32,
        "num_hidden_layers": 3, "num_attention_heads": 4, "num_key_value_heads": 4, "n_routed_experts": 8,
        "n_shared_experts": 1, "num_experts_per_tok": 2, "first_k_dense_replace": 1, "moe_layer_freq": 1,
        "kv_lora_rank": 32, "q_lora_rank": None, "qk_nope_head_dim": 32, "qk_rope_head_dim": 16,
        "v_head_dim": 32, "rms_norm_eps": 1e-6, "rope_theta": 10000,
        "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096, "beta_fast": 32,
                         "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707},
        "routed_scaling_factor": 1.0, "norm_topk_prob": False, "topk_method": "greedy", "scoring_func": "softmax",
        "hidden_act": "silu", "attention_bias": False, "model_type": "deepseek_v2"}
LENGTHS = [7, 12, 1, 10]
WIDTH = 12
FP32_BAR = 1e-5


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _weights(cfg=TINY, seed=3, dtype=torch.float32):
    """The reference's seeded weights at a scale that makes the layers matter
    (std 0.2: the benchmark's 0.02 leaves a tiny model's residual all but
    untouched)."""
    w = ref.draw_weights(cfg, seed, "cpu", dtype=torch.float32)
    return {k: (v * 10 if v.dim() > 1 else v).to(dtype) for k, v in w.items()}


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, TINY["vocab_size"], (len(LENGTHS), WIDTH), generator=g)
    mask = torch.arange(WIDTH)[None] >= WIDTH - torch.tensor(LENGTHS)[:, None]
    return ids, mask


def _port(W, cfg=TINY, dtype=torch.float32):
    c = dv.DeepseekV2Config.from_dict(cfg)
    return dv.params_from_state_dict(W.__getitem__, c, dtype=dtype, device="cpu"), c


def test_forward_matches_the_reference():
    W = _weights()
    P, cfg = _port(W)
    ids, mask = _inputs()
    out = dv.deepseek_v2_forward(P, ids, mask, cfg)[:, -1]
    want = ref.encode(TINY, W, [ids[b, WIDTH - n:] for b, n in enumerate(LENGTHS)])
    assert _rel(out, want) < FP32_BAR


def test_mla_alone_matches_the_reference():
    W = _weights()
    P, cfg = _port(W)
    L = ref._layer(W, TINY, 1, None)
    g = torch.Generator().manual_seed(1)
    h = torch.randn(1, 9, 64, generator=g)
    mask = torch.ones(1, 9, dtype=torch.bool)
    cos, sin = dv.rope_tables(dv.positions(mask), cfg, h.dtype)
    got = dv.mla(h, P["layers"][1], cfg, cos, sin, dv.attention_bias(mask))[0]
    freq, m, scale = ref.yarn(TINY, "cpu")
    assert _rel(got, ref.attention(h[0], L, TINY, freq, m, scale)) < FP32_BAR


def test_moe_alone_matches_the_reference():
    W = _weights()
    P, cfg = _port(W)
    L = ref._layer(W, TINY, 2, None)
    h = torch.randn(2, 11, 64, generator=torch.Generator().manual_seed(2))
    routes = []
    got = dv.moe(h, P["layers"][2], cfg, 2, routes=routes)
    want_routes = []
    want = ref.moe(h.reshape(-1, 64), L, TINY, want_routes)
    assert _rel(got.reshape(-1, 64), want) < FP32_BAR
    assert torch.equal(routes[0].sort(-1).values, want_routes[0].sort(-1).values)


def test_yarn_tables_and_softmax_scale_against_the_closed_form():
    full = dv.DeepseekV2Config()  # DeepSeek-V2-Lite
    m = 0.1 * 0.707 * math.log(40) + 1
    assert dv.softmax_scale(full) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert m * m == pytest.approx(1.5896, abs=1e-4)
    assert dv.rope_mscale(full) == 1.0
    d, base = 64, 10000.0
    corr = [d * math.log(4096 / (r * 2 * math.pi)) / (2 * math.log(base)) for r in (32, 1)]
    lo, hi = max(math.floor(corr[0]), 0), min(math.ceil(corr[1]), d - 1)
    want = []
    for i in range(d // 2):
        extra = base ** (-2 * i / d)
        ramp = min(max((i - lo) / (hi - lo), 0.0), 1.0)
        want.append(extra / 40 * ramp + extra * (1 - ramp))
    assert (lo, hi) == (10, 23)
    assert torch.allclose(dv.yarn_inv_freq(full), torch.tensor(want), rtol=1e-6, atol=0)
    freq, mult, scale = ref.yarn(json.loads(json.dumps(TINY | {"qk_rope_head_dim": 64, "qk_nope_head_dim": 128})),
                                 "cpu")
    assert torch.allclose(freq, torch.tensor(want), rtol=1e-6, atol=0)
    assert (mult, scale) == (1.0, pytest.approx(dv.softmax_scale(full), rel=1e-12))
    plain = dv.DeepseekV2Config(rope_scaling=None)
    assert dv.softmax_scale(plain) == 192 ** -0.5 and torch.allclose(
        dv.yarn_inv_freq(plain), base ** (-torch.arange(0, d, 2) / d))


def test_a_history_alone_and_left_padded_in_a_batch():
    W = _weights()
    P, cfg = _port(W)
    ids, mask = _inputs()
    batched = dv.deepseek_v2_forward(P, ids, mask, cfg)[:, -1]
    for b, n in enumerate(LENGTHS):
        alone = dv.deepseek_v2_forward(P, ids[b:b + 1, WIDTH - n:], torch.ones(1, n, dtype=torch.bool), cfg)[0, -1]
        assert _rel(batched[b], alone) < FP32_BAR


def test_positions_count_from_the_first_real_token():
    mask = torch.tensor([[0, 0, 1, 1, 1], [1, 1, 1, 1, 1]], dtype=torch.bool)
    assert dv.positions(mask).tolist() == [[0, 0, 0, 1, 2], [0, 1, 2, 3, 4]]


def test_a_router_that_sends_every_token_to_one_expert_drops_nothing():
    """Expert 3 is every token's first choice: all N tokens run through it
    (no capacity), and the output is the reference's."""
    W = _weights()
    W["model.layers.2.mlp.gate.weight"][3] = 0.0
    W["model.layers.2.mlp.gate.weight"][3, 0] = 1e4  # a positive first coordinate picks expert 3
    P, cfg = _port(W)
    h = torch.randn(3, 8, 64, generator=torch.Generator().manual_seed(4))
    h[..., 0] = h[..., 0].abs() + 1.0
    counters = dv.DeviceCounters()
    routes = []
    got = dv.moe(h, P["layers"][2], cfg, 2, counters, routes)
    assert (routes[0] == 3).any(dim=-1).all()
    counts = counters.read()["expert_tokens.2"]
    assert counts[3] == 24 and sum(counts) == 24 * 2
    assert _rel(got.reshape(-1, 64), ref.moe(h.reshape(-1, 64), ref._layer(W, TINY, 2, None), TINY)) < FP32_BAR


def test_bf16_follows_fp32():
    W = _weights()
    ids, mask = _inputs()
    P32, cfg = _port(W)
    P16, _ = _port({k: v.to(torch.bfloat16) for k, v in W.items()}, dtype=torch.bfloat16)
    a = dv.deepseek_v2_forward(P32, ids, mask, cfg)
    b = dv.deepseek_v2_forward(P16, ids, mask, cfg).float()
    assert b.dtype == torch.float32 and _rel(b[mask], a[mask]) < 3e-2


def _reads(fn):
    """The host reads inside ``cse/ctx.encode`` in a profile of ``fn()``
    (``perfbench/host_reads.py``, the benchmark's count)."""
    from perfbench.host_reads import count_reads

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        fn()
    return count_reads(prof.events(), "cse/ctx.encode")


def _sized_by_the_host(monkeypatch):
    """Plant a dispatch that sizes its counts on the host, as
    ``torch.bincount`` does: one read a MoE layer."""
    scatter = torch.Tensor.scatter_add_

    def counted(self, dim, index, src):
        n = int(index.max()) + 1  # the read
        return scatter(self, dim, index, src) if n else self

    monkeypatch.setattr(torch.Tensor, "scatter_add_", counted)


def test_counters_count_tokens_and_calls_without_host_reads(monkeypatch):
    W = _weights()
    P, cfg = _port(W)
    ids, mask = _inputs()
    counters = dv.DeviceCounters()

    def twice():
        dv.deepseek_v2_forward(P, ids, mask, cfg, counters)
        dv.deepseek_v2_forward(P, ids, mask, cfg, counters)

    clean = _reads(twice)
    assert clean["occurrences"] == 2
    c = counters.read()
    assert c["tokens_real"] == 2 * sum(LENGTHS)
    assert c["tokens_padded"] == 2 * (len(LENGTHS) * WIDTH - sum(LENGTHS))
    assert sorted(k for k in c if k.startswith("expert_tokens")) == ["expert_tokens.1", "expert_tokens.2"]
    assert all(sum(c[f"expert_tokens.{i}"]) == 2 * len(LENGTHS) * WIDTH * 2 for i in (1, 2))
    # a dispatch sized on the host reads once a MoE layer, and the profile counts it. (On the CPU
    # torch._grouped_mm's fallback reads each expert's offset too; on the card the clean count is
    # 0, test_the_encoder_reads_nothing_back_on_the_card.)
    _sized_by_the_host(monkeypatch)
    assert _reads(twice) == {"reads": clean["reads"] + 2 * 2, "occurrences": 2}


def test_random_params_are_keyed_by_path():
    """Seeded per tensor name, and the same weights as the benchmark's draw
    (``draw_weights``) read through ``params_from_state_dict``: one
    generator, one distribution."""
    cfg = dv.DeepseekV2Config.from_dict(TINY)
    a = dv.random_deepseek_v2_params(cfg, seed=5, device="cpu")
    b = dv.random_deepseek_v2_params(cfg, seed=5, device="cpu")
    c = dv.random_deepseek_v2_params(cfg, seed=6, device="cpu")
    assert torch.equal(a["layers"][2]["experts_gate"], b["layers"][2]["experts_gate"])
    assert not torch.equal(a["layers"][2]["experts_gate"], c["layers"][2]["experts_gate"])
    assert a["layers"][1]["experts_down"].shape == (8, 64, 32) and "router" not in a["layers"][0]
    assert a["layers"][1]["router"].dtype == torch.float32 and a["layers"][1]["q"].dtype == torch.bfloat16
    drawn = ref.draw_weights(TINY, 5, "cpu")
    want = dv.params_from_state_dict(drawn.__getitem__, cfg, device="cpu")
    assert torch.equal(a["embed"], want["embed"])
    for got, exp in zip(a["layers"], want["layers"]):
        assert got.keys() == exp.keys() and all(torch.equal(got[k], exp[k]) for k in got)
    assert set(drawn) == set(dv.hf_names(cfg))


def test_config_refuses_what_the_prefill_does_not_compute():
    for key, value in (("q_lora_rank", 1536), ("topk_method", "group_limited_greedy"), ("scoring_func", "sigmoid")):
        with pytest.raises(ValueError, match=key):
            dv.DeepseekV2Config.from_dict(TINY | {key: value})
    with pytest.raises(ValueError, match="rope_scaling"):
        dv.DeepseekV2Config.from_dict(TINY | {"rope_scaling": {"type": "linear", "factor": 2}})
    assert dv.DeepseekV2Config.from_dict(TINY | {"rope_scaling": None}).rope_scaling is None


# ---------------------------------------------------------------- checkouts


def _write_checkout(path, W, cfg=TINY):
    from chip_smoke import write_safetensors

    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(cfg))
    half = len(W) // 2  # two shards, as a released checkout has several
    names = list(W)
    write_safetensors(str(path / "model-00001.safetensors"), {k: W[k] for k in names[:half]})
    write_safetensors(str(path / "model-00002.safetensors"),
                      {**{k: W[k] for k in names[half:]}, "lm_head.weight": torch.zeros(cfg["vocab_size"], 64)})


def test_load_reads_a_checkout_and_build_context_encoder_dispatches_on_model_type(tmp_path):
    from cse_tpu_torch.models.context_encoder import build_context_encoder
    from cse_tpu_torch.models.llama import LlamaContextEncoder

    W = _weights()
    _write_checkout(tmp_path / "ds", W)
    P, cfg = dv.load_deepseek_v2_params(str(tmp_path / "ds"), dtype=torch.float32, device="cpu")
    want, _ = _port(W)
    assert cfg == dv.DeepseekV2Config.from_dict(TINY)
    for a, b in zip(P["layers"], want["layers"]):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    enc = build_context_encoder(str(tmp_path / "ds"), ctx_length=1, device="cpu")
    assert isinstance(enc, dv.DeepseekV2ContextEncoder) and not enc.is_stub
    ids, mask = _inputs()
    out = enc(ids, mask)
    assert out.shape == (len(LENGTHS), 1, 64) and out.dtype == torch.float32
    apply, params = enc.pure()
    assert torch.equal(apply(params, ids, mask), out)
    with pytest.raises(ValueError, match="no quant"):
        build_context_encoder(str(tmp_path / "ds"), device="cpu", quant="int8")
    # a checkout of another model_type (or none) stays Llama's
    from chip_smoke import write_llama_dir

    write_llama_dir(str(tmp_path / "llama"), 320, 32, 64, 1, 4, 2, torch.float32, torch.Generator().manual_seed(0))
    assert isinstance(build_context_encoder(str(tmp_path / "llama"), device="cpu"), LlamaContextEncoder)


def test_serving_engine_with_the_encoder_is_encoder_then_engine():
    from cse_tpu_torch.models import Sepformer, SepformerConfig
    from cse_tpu_torch.serving import ServingEngine

    torch.manual_seed(0)
    cfg = SepformerConfig(variant="contsep", num_spks=3, ce=True, enc_channels=16, enc_kernel=8, enc_stride=4,
                          d_model=32, nhead=4, d_ffn=64, num_tf_layers=1, num_dp_layers=1, chunk_size=10, llm_dim=64)
    model = Sepformer(cfg)
    W = _weights()
    P, c = _port(W)
    enc = dv.DeepseekV2ContextEncoder(params=P, cfg=c)
    ids, mask = _inputs()
    mix = torch.randn(len(LENGTHS), 1200)
    for quant in (None, "w8a8"):
        with_enc = ServingEngine(cfg, model, device="cpu", quant=quant, context_encoder=enc)
        est, logits = with_enc(mix, ids=ids, mask=mask)
        plain = ServingEngine(cfg, model, device="cpu", quant=quant)
        want_est, want_logits = plain(mix, enc(ids, mask))
        assert torch.equal(est, want_est) and torch.equal(logits, want_logits)
    with pytest.raises(ValueError, match="context_encoder"):
        plain(mix, ids=ids, mask=mask)


def test_matches_transformers_without_rope_scaling(tmp_path):
    """``transformers``' DeepseekV2 on the same weights (its own checkout,
    saved by it and read by the port's loader), rope_scaling None: see the
    module docstring for why only there."""
    hf = pytest.importorskip("transformers")
    if not hasattr(hf, "DeepseekV2ForCausalLM"):
        pytest.skip("this transformers has no DeepseekV2ForCausalLM")
    keys = {k: v for k, v in TINY.items() if k not in ("model_type", "moe_layer_freq", "rope_scaling")}
    model = hf.DeepseekV2ForCausalLM(hf.DeepseekV2Config(**keys, rope_scaling=None,
                                                          attn_implementation="eager")).eval()
    torch.manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() > 1:
                p.normal_(0.0, 0.2)
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    P, cfg = dv.load_deepseek_v2_params(str(tmp_path), dtype=torch.float32, device="cpu")
    assert cfg.rope_scaling is None
    ids, mask = _inputs()
    got = dv.deepseek_v2_forward(P, ids, mask, cfg)
    with torch.no_grad():
        want = model.model(input_ids=ids, attention_mask=mask.long(), position_ids=dv.positions(mask)).last_hidden_state
    assert _rel(got[mask], want[mask]) < FP32_BAR


@pytest.mark.cuda
def test_the_encoder_reads_nothing_back_on_the_card(monkeypatch):
    """A forward on the card under CUDA's sync debug mode: no operation of
    the prefill (the dispatch included) waits for the device. The profile's
    count agrees, and counts a dispatch sized on the host (as
    ``torch.bincount`` sizes its output) at least once a MoE layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    W = {k: v.cuda() for k, v in _weights(dtype=torch.bfloat16).items()}
    cfg = dv.DeepseekV2Config.from_dict(TINY)
    P = dv.params_from_state_dict(W.__getitem__, cfg, device="cuda")
    ids, mask = (t.cuda() for t in _inputs())
    counters = dv.DeviceCounters()
    dv.deepseek_v2_forward(P, ids, mask, cfg, counters)  # warm: the first call may load libraries
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dv.deepseek_v2_forward(P, ids, mask, cfg, counters)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _reads(lambda: dv.deepseek_v2_forward(P, ids, mask, cfg, counters)) == {"reads": 0, "occurrences": 1}

    def bincount_dispatch(self, dim, index, src):
        return self.copy_(torch.bincount(index, minlength=self.shape[0]))

    monkeypatch.setattr(torch.Tensor, "scatter_add_", bincount_dispatch)
    sized = _reads(lambda: dv.deepseek_v2_forward(P, ids, mask, cfg, counters))
    assert sized["occurrences"] == 1 and sized["reads"] >= 2  # bincount reads its input's range: each MoE layer
