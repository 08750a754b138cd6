"""cse_tpu_torch.models.llama against cse_tpu.models.llama (and transformers)
on a tiny random Llama that transformers saves into a temp directory (vocab
320, so that ByteTokenizer ids fit; 2 layers, 4 query and 2 key-value heads),
on the CPU in fp32.

Bars: hidden states and logits 2e-4 against both packages' reference on the
non-pad positions (tests/test_llama.py); int8 1e-4 against JAX's int8 (the
same payloads, only the summation order differs); w8a8 rel L2 1e-3 against
JAX's w8a8 (a one-ulp difference in h / sa can flip an activation's int8
rounding); quantized payloads and scales equal (atol 0); int8 within 1e-5 of
the forward on explicitly dequantized weights; int8 and w8a8 within rel L2
1e-2 of fp32 (tests/test_llama.py). Left-padded rows (none, some and all
but one position padded): every position, pad rows included, finite and
within 2e-4 of JAX's in each form. The port's safetensors reader gives the
same tensors as ``safetensors.safe_open`` (bits equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cse_tpu.models import llama as jl
from cse_tpu_torch.compat.jax_params import llama_params_from_jax
from cse_tpu_torch.compat.safetensors_io import SafetensorsFile
from cse_tpu_torch.models import llama as tl

torch.set_num_threads(1)

QUANTS = [None, "int8", "w8a8"]


@pytest.fixture(scope="module")
def tiny_llama(tmp_path_factory):
    from transformers import LlamaConfig as HFConfig, LlamaForCausalLM

    torch.manual_seed(0)
    cfg = HFConfig(vocab_size=320, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                   rope_theta=10000.0, tie_word_embeddings=False, attn_implementation="eager")
    model = LlamaForCausalLM(cfg).eval()
    d = tmp_path_factory.mktemp("llama")
    model.save_pretrained(str(d), safe_serialization=True)
    return model, str(d)


@pytest.fixture(scope="module")
def jax_params(tiny_llama):
    """cse_tpu's fp32 weights in each quant form, as numpy trees."""
    _, path = tiny_llama
    out = {}
    for quant in QUANTS:
        params, cfg = jl.load_llama_params(path, dtype=jnp.float32, quant=quant)
        out[quant] = (params, cfg)
    return out


def _inputs():
    """Left-padded rows: none, some and all but one position."""
    ids = np.array([[1, 5, 9, 17, 33, 300], [0, 0, 1, 7, 21, 99], [0, 0, 0, 0, 0, 257]], np.int32)
    mask = np.array([[1, 1, 1, 1, 1, 1], [0, 0, 1, 1, 1, 1], [0, 0, 0, 0, 0, 1]], np.int32)
    return ids, mask


def _jax_forward(jax_params, quant, return_logits=False):
    params, cfg = jax_params[quant]
    ids, mask = _inputs()
    return np.asarray(jl.llama_forward(params, jnp.asarray(ids), jnp.asarray(mask), cfg, return_logits=return_logits))


def _port_forward(path, quant, return_logits=False, dtype=torch.float32):
    params, cfg = tl.load_llama_params(path, dtype=dtype, quant=quant, device="cpu")
    ids, mask = _inputs()
    return tl.llama_forward(params, torch.from_numpy(ids), torch.from_numpy(mask), cfg,
                            return_logits=return_logits).float().numpy()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("return_logits", [False, True])
def test_fp32_matches_jax(tiny_llama, jax_params, return_logits):
    _, path = tiny_llama
    got = _port_forward(path, None, return_logits)
    want = _jax_forward(jax_params, None, return_logits)
    m = _inputs()[1].astype(bool)
    assert got.shape == want.shape == ((3, 6, 320) if return_logits else (3, 6, 32))
    np.testing.assert_allclose(got[m], want[m], rtol=2e-4, atol=2e-4)


def test_hidden_states_match_transformers(tiny_llama):
    model, path = tiny_llama
    ids, mask = _inputs()
    with torch.no_grad():
        ref = model.model(input_ids=torch.tensor(ids, dtype=torch.long),
                          attention_mask=torch.tensor(mask, dtype=torch.long)).last_hidden_state.numpy()
    got = _port_forward(path, None)
    m = mask.astype(bool)
    np.testing.assert_allclose(got[m], ref[m], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("quant", QUANTS)
def test_left_padded_rows_are_finite_everywhere(tiny_llama, jax_params, quant):
    """The finite -1e30 bias: a pad query with every key masked still gets a
    finite softmax row, so no NaN reaches the next layer's keys and values
    (or the real rows through P·V). Pad positions match JAX's too."""
    _, path = tiny_llama
    got = _port_forward(path, quant)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax_forward(jax_params, quant), rtol=2e-4, atol=2e-4)


def test_int8_matches_jax(tiny_llama, jax_params):
    _, path = tiny_llama
    m = _inputs()[1].astype(bool)
    np.testing.assert_allclose(_port_forward(path, "int8")[m], _jax_forward(jax_params, "int8")[m],
                               rtol=1e-4, atol=1e-4)


def test_w8a8_matches_jax(tiny_llama, jax_params):
    _, path = tiny_llama
    m = _inputs()[1].astype(bool)
    assert _rel(_port_forward(path, "w8a8")[m], _jax_forward(jax_params, "w8a8")[m]) <= 1e-3


@pytest.mark.parametrize("quant", ["int8", "w8a8"])
@pytest.mark.parametrize("route", ["load", "quantize_llama_params"])
def test_quantized_payloads_equal_jax(tiny_llama, jax_params, quant, route):
    _, path = tiny_llama
    if route == "load":
        params, _ = tl.load_llama_params(path, dtype=torch.float32, quant=quant, device="cpu")
    else:
        full, _ = tl.load_llama_params(path, dtype=torch.float32, device="cpu")
        params = tl.quantize_llama_params(full, quant)
    want = jax_params[quant][0]
    key = "w" if quant == "int8" else "w8"
    for name in tl.LAYER_MATRICES:
        got, exp = params["layers"][name], want["layers"][name]
        assert set(got) == set(exp) == {key, "s"}, name
        assert got[key].dtype == torch.int8 and got["s"].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(exp[key]), err_msg=name)
        np.testing.assert_array_equal(got["s"].numpy(), np.asarray(exp["s"]), err_msg=name)
    assert params["embed"].dtype == torch.float32 and params["final_ln"].dtype == torch.float32


def test_int8_matches_explicit_dequant(tiny_llama):
    _, path = tiny_llama
    q, cfg = tl.load_llama_params(path, dtype=torch.float32, quant="int8", device="cpu")
    deq = dict(q, layers={k: (v["w"].float() * v["s"] if isinstance(v, dict) else v) for k, v in q["layers"].items()})
    ids, mask = (torch.from_numpy(a) for a in _inputs())
    np.testing.assert_allclose(tl.llama_forward(q, ids, mask, cfg).numpy(),
                               tl.llama_forward(deq, ids, mask, cfg).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", ["int8", "w8a8"])
def test_quantized_close_to_fp32(tiny_llama, quant):
    _, path = tiny_llama
    m = _inputs()[1].astype(bool)
    assert _rel(_port_forward(path, quant)[m], _port_forward(path, None)[m]) < 1e-2


@pytest.mark.parametrize("rows", [5, 16, 40])
def test_mm_w8a8_matches_numpy_oracle(rows):
    """Per-token symmetric max-scaling, int32 accumulation, two-scale
    dequant; at most 16 rows go through the zero-row padding the card's
    ``torch._int_mm`` needs."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((rows, 16)).astype(np.float32)
    h[2] = 0.0  # an all-zero token row: the sa floor keeps it finite
    w8 = rng.integers(-127, 128, (16, 24), dtype=np.int8)
    s = (rng.uniform(0.5, 2.0, (1, 24)) / 100).astype(np.float32)
    sa = np.maximum(np.max(np.abs(h), axis=-1, keepdims=True), 1e-12) / 127.0
    hq = np.round(h.astype(np.float64) / sa)
    assert np.abs(hq).max() <= 127
    expect = (hq @ w8.astype(np.float64)) * sa * s
    got = tl._mm_w8a8(torch.from_numpy(h), torch.from_numpy(w8), torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-6, atol=1e-6)
    want = np.asarray(jl._mm_w8a8(jnp.asarray(h), jnp.asarray(w8), jnp.asarray(s)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # K-major storage (the loader's) gives the same product
    k_major = torch.from_numpy(w8).t().contiguous().t()
    np.testing.assert_array_equal(tl._mm_w8a8(torch.from_numpy(h), k_major, torch.from_numpy(s)).numpy(), got)


@pytest.mark.parametrize("quant", QUANTS)
def test_context_encoder_and_scorer(tiny_llama, jax_params, quant):
    _, path = tiny_llama
    enc = tl.LlamaContextEncoder(path, ctx_length=2, dtype=torch.float32, quant=quant, device="cpu")
    ids, mask = (torch.from_numpy(a) for a in _inputs())
    out = enc(ids, mask)
    assert out.shape == (3, 2, 32) and out.dtype == torch.float32 and not enc.is_stub
    np.testing.assert_array_equal(out.numpy(), _port_forward(path, quant)[:, -2:])
    apply, params = enc.pure()
    assert params is enc.params
    assert torch.equal(apply(params, ids, mask), out)
    logits = enc.score_logits(ids, mask)
    assert logits.shape == (3, 6, 320) and logits.dtype == torch.float32 and torch.isfinite(logits).all()
    want = _jax_forward(jax_params, quant, return_logits=True)
    m = mask.numpy().astype(bool)
    assert _rel(logits.numpy()[m], want[m]) <= 1e-3
    assert all(not t.requires_grad for t in _leaves(enc.params))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("quant", QUANTS)
def test_random_params_layouts(quant):
    cfg = tl.LlamaConfig(vocab_size=300, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2)
    rp = tl.random_llama_params(cfg, dtype=torch.bfloat16, quant=quant, with_lm_head=False, device="cpu")
    want = jl.random_llama_params(jl.LlamaConfig(**vars(cfg)), dtype=jnp.bfloat16, quant=quant, with_lm_head=False)
    flat = lambda t: {"/".join(str(getattr(p, "key", p)) for p in k): v
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    got, exp = flat(rp), flat(want)
    assert set(got) == set(exp) and "lm_head" not in got
    for k in exp:
        assert tuple(got[k].shape) == exp[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(exp[k].dtype), k
    if quant:
        key = "w" if quant == "int8" else "w8"
        q = rp["layers"]["q"]
        assert int(q[key].min()) >= -127 and int(q[key].max()) <= 127
        np.testing.assert_array_equal(q["s"].numpy(), np.asarray(want["layers"]["q"]["s"]))
    # per-leaf generators: the head changes no other leaf; another seed changes them
    with_head = tl.random_llama_params(cfg, dtype=torch.bfloat16, quant=quant, device="cpu")
    assert tuple(with_head["lm_head"].shape) == (32, 300)
    assert torch.equal(with_head["embed"], rp["embed"])
    other = tl.random_llama_params(cfg, dtype=torch.bfloat16, seed=1, quant=quant, with_lm_head=False, device="cpu")
    assert not torch.equal(other["embed"], rp["embed"])
    ids, mask = (torch.from_numpy(a % 300) for a in _inputs())
    assert torch.isfinite(tl.llama_forward(rp, ids, mask, cfg).float()).all()


@pytest.mark.parametrize("quant", QUANTS)
def test_params_from_jax_round_trip(tiny_llama, jax_params, quant):
    """JAX's tree through the carrier equals the port's own load, bit for bit,
    and gives JAX's forward."""
    _, path = tiny_llama
    params, cfg = jax_params[quant]
    carried = llama_params_from_jax(jax.tree.map(np.asarray, params))
    loaded, tcfg = tl.load_llama_params(path, dtype=torch.float32, quant=quant, device="cpu")
    a, b = dict(_walk(carried)), dict(_walk(loaded))
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].stride() == b[k].stride() and torch.equal(a[k], b[k]), k
    ids, mask = (torch.from_numpy(x) for x in _inputs())
    m = mask.numpy().astype(bool)
    got = tl.llama_forward(carried, ids, mask, tcfg).numpy()
    np.testing.assert_allclose(got[m], _jax_forward(jax_params, quant)[m], rtol=2e-4, atol=2e-4)


def test_params_from_jax_reads_bf16_bits():
    x = jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)), jnp.bfloat16)
    got = llama_params_from_jax({"embed": np.asarray(x)})["embed"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(x.astype(jnp.float32)))


def _walk(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_norm_and_rope_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 6, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = np.broadcast_to(np.arange(6)[None], (2, 6))
    np.testing.assert_allclose(tl._rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
                               np.asarray(jl._rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)), rtol=1e-6, atol=1e-6)
    cos, sin = tl._rope_tables(6, 16, 500000.0, torch.float32, "cpu")
    np.testing.assert_allclose(tl._apply_rope(torch.from_numpy(x), cos, sin).numpy(),
                               np.asarray(jl._rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["F32", "BF16"])
def test_safetensors_reader_matches_safe_open(tmp_path, dtype):
    from safetensors import safe_open
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    dt = torch.float32 if dtype == "F32" else torch.bfloat16
    tensors = {"a.weight": torch.randn(7, 5, generator=g).to(dt), "b": torch.randn(11, generator=g).to(dt),
               "empty": torch.zeros(0, 3, dtype=dt), "scalar": torch.tensor(2.5).to(dt)}
    p = str(tmp_path / "m.safetensors")
    save_file(tensors, p, metadata={"format": "pt"})
    with SafetensorsFile(p) as f, safe_open(p, framework="pt") as ref:
        assert sorted(f.keys()) == sorted(ref.keys())
        for k in ref.keys():
            got, want = f.get(k), ref.get_tensor(k)
            assert got.dtype == want.dtype == dt and got.shape == want.shape, k
            assert torch.equal(got.view(torch.int16 if dt == torch.bfloat16 else torch.int32),
                               want.view(torch.int16 if dt == torch.bfloat16 else torch.int32)), k


def test_llama_raises_without_a_card_unless_asked_for_the_cpu(tiny_llama, monkeypatch):
    _, path = tiny_llama
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.load_llama_params(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.random_llama_params(tl.LlamaConfig(num_hidden_layers=1, vocab_size=8, hidden_size=8,
                                              intermediate_size=8, num_attention_heads=2, num_key_value_heads=1))
    with pytest.raises(ValueError, match="quant"):
        tl.load_llama_params(path, quant="int4", device="cpu")
