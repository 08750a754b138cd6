"""cse_tpu_torch.models.context_encoder against cse_tpu's stub encoder with
its two tables carried across (atol 1e-6: the same fp32 arithmetic; only the
cumulative sum's order may differ), and the train/eval steps with
``llm_apply`` against the same steps fed the encoder's output as ``ctx_feat``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cse_tpu.models.context_encoder import HashProjectionEncoder as JaxEncoder
from cse_tpu_torch.compat.jax_params import hash_encoder_tables
from cse_tpu_torch.models.context_encoder import (
    HashProjectionEncoder,
    build_context_encoder,
    llama_weights_available,
)
from cse_tpu_torch.models.sepformer import Sepformer, SepformerConfig
from cse_tpu_torch.train.optimizer import build_optimizer
from cse_tpu_torch.train.step import TrainConfig, make_eval_step, make_loss_fn, make_train_step

torch.set_num_threads(1)


def jax_tables(dim, seed=0):
    """The tables cse_tpu's ``_hash_encode`` draws (context_encoder.py:64-66)."""
    key = jax.random.key(seed)
    w = jax.random.normal(key, (1, 1, dim)) * 0.02
    p = jax.random.uniform(jax.random.fold_in(key, 1), (1, 1, dim)) * 6.283
    return np.asarray(w), np.asarray(p)


def _ids_mask(rng, B=3, T=12):
    """Left-padded rows: 0, some and nearly all padding."""
    ids = rng.integers(1, 258, size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    for b, pad in list(enumerate((0, 5, T - 1)))[:B]:
        mask[b, :pad] = 0
        ids[b, :pad] = 0
    return ids, mask


@pytest.mark.parametrize("ctx_length", [1, 4])
def test_hash_encode_matches_with_tables_carried_across(rng, ctx_length):
    dim = 64
    ids, mask = _ids_mask(rng)
    want = np.asarray(JaxEncoder(dim=dim, ctx_length=ctx_length)(jnp.asarray(ids), jnp.asarray(mask)))
    enc = HashProjectionEncoder(dim=dim, ctx_length=ctx_length, tables=hash_encoder_tables(*jax_tables(dim)))
    got = enc(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.shape == (3, ctx_length, dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    apply, params = enc.pure()
    torch.testing.assert_close(apply(params, torch.from_numpy(ids), torch.from_numpy(mask)), got, rtol=0, atol=0)


def test_pad_width_does_not_change_the_feature(rng):
    enc = HashProjectionEncoder(dim=32, ctx_length=1)
    ids, mask = _ids_mask(rng, T=10)
    pad = lambda a: np.concatenate([np.zeros((3, 6), a.dtype), a], axis=1)
    a = enc(torch.from_numpy(ids), torch.from_numpy(mask))
    b = enc(torch.from_numpy(pad(ids)), torch.from_numpy(pad(mask)))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_default_tables_come_from_the_seed():
    a, b, c = (HashProjectionEncoder(dim=16, seed=s) for s in (0, 0, 1))
    assert torch.equal(a.w, b.w) and torch.equal(a.p, b.p) and not torch.equal(a.w, c.w)
    assert a.is_stub and set(dict(a.named_buffers())) == {"w", "p"}
    assert float(a.p.min()) >= 0 and float(a.p.max()) <= 6.283


def test_build_context_encoder(tmp_path, monkeypatch):
    """No weights: the stub. A directory with config.json: the Llama encoder,
    against cse_tpu's build_context_encoder on the same files (both bf16 by
    default, each on its own CPU products: rel L2 <= 2e-2, the bf16 bar), in
    each quant form; on the card unless the caller asks for the CPU."""
    from transformers import LlamaConfig as HFConfig, LlamaForCausalLM

    from cse_tpu.models.context_encoder import build_context_encoder as jax_build
    from cse_tpu_torch.models.llama import LlamaContextEncoder

    enc = build_context_encoder("__none__", ctx_length=2, dim=8, device="cpu")
    assert isinstance(enc, HashProjectionEncoder) and enc.ctx_length == 2 and enc.dim == 8
    torch.manual_seed(0)
    LlamaForCausalLM(HFConfig(vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                              num_attention_heads=4, num_key_value_heads=2, attn_implementation="eager")
                     ).save_pretrained(str(tmp_path), safe_serialization=True)
    assert llama_weights_available(str(tmp_path)) and not llama_weights_available("__none__")
    ids, mask = _ids_mask(np.random.default_rng(0), T=12)
    for quant in (None, "int8", "w8a8"):
        enc = build_context_encoder(str(tmp_path), ctx_length=2, quant=quant, device="cpu")
        assert isinstance(enc, LlamaContextEncoder) and not enc.is_stub
        got = enc(torch.from_numpy(ids), torch.from_numpy(mask))
        want = np.asarray(jax_build(str(tmp_path), ctx_length=2, quant=quant)(jnp.asarray(ids), jnp.asarray(mask)))
        assert got.shape == (3, 2, 32) and got.dtype == torch.float32 and torch.isfinite(got).all()
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel <= 2e-2, (quant, rel)
    assert isinstance(build_context_encoder(str(tmp_path), force_stub=True), HashProjectionEncoder)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_context_encoder(str(tmp_path))


TINY = dict(num_spks=2, enc_channels=32, enc_kernel=8, enc_stride=4, d_model=32, nhead=4, d_ffn=64,
            num_tf_layers=1, num_dp_layers=1, chunk_size=16, llm_dim=24, pe_max_len=256)


@pytest.mark.parametrize("variant", ["context", "contsep"])
def test_steps_with_llm_apply_equal_steps_with_ctx_feat(rng, variant):
    ids, mask = _ids_mask(rng, B=2)
    enc = HashProjectionEncoder(dim=24, ctx_length=1)
    apply, params = enc.pure()
    batch = {"mixed": rng.standard_normal((2, 400)).astype(np.float32),
             "gt": rng.standard_normal((2, 400)).astype(np.float32),
             "noises": rng.standard_normal((2, 400, 1)).astype(np.float32)}
    with_ids = dict(batch, context_ids=ids, context_mask=mask)
    with_feat = dict(batch, ctx_feat=enc(torch.from_numpy(ids), torch.from_numpy(mask)).numpy())
    tc = TrainConfig(variant=variant)
    make = lambda: Sepformer(SepformerConfig(variant=variant, **TINY), generator=torch.Generator().manual_seed(3))

    to_t = lambda b: {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    m1, m2 = make(), make()
    l1, _ = make_loss_fn(m1, tc, apply, llm_params=params)(to_t(with_ids))
    l2, _ = make_loss_fn(m2, tc)(to_t(with_feat))
    assert float(l1.detach()) == float(l2.detach())
    l1.backward()
    l2.backward()
    for (k, p), q in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(p.grad, q.grad), k

    s1 = make_train_step(make(), build_optimizer(1e-3), tc, device="cpu", llm_apply=apply, llm_params=params)
    s2 = make_train_step(make(), build_optimizer(1e-3), tc, device="cpu")
    r1, r2 = s1(with_ids), s2(with_feat)
    assert r1 == r2 and all(isinstance(v, float) for v in r1.values())
    t1 = s1.tensors(with_ids)  # the same step, metrics left on the device as 0-d tensors
    assert set(t1) == set(r1) and all(isinstance(v, torch.Tensor) and v.ndim == 0 for v in t1.values())
    assert float(t1["loss"]) == s2(with_feat)["loss"]

    e1 = make_eval_step(make(), tc, device="cpu", llm_apply=apply, llm_params=params)(with_ids)
    e2 = make_eval_step(make(), tc, device="cpu")(with_feat)
    assert torch.equal(e1[0], e2[0]) and e1[0].shape == (2, 400)
