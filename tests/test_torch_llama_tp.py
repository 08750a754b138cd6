"""The port's tensor-parallel Llama (``models/llama.py::llama_shardings``) on
the CPU: four gloo processes load tests/test_torch_llama.py's tiny checkout
(vocab 320, 2 layers, 4 query and 2 key-value heads) sharded over a model
axis of 4 (KV < n_model: a kv head on two ranks) and over a 2 x 2 mesh (KV
== n_model), in fp32, int8 and w8a8, and run the hidden states and
``score_logits``.

Bars (tests/test_llama.py's TP cases): rtol 1e-4 / atol 1e-4 on the unmasked
rows against the port's unsharded forward and against JAX's forward over
``make_mesh(n_data=2, n_model=4)`` (the conftest's virtual devices); the
ranks' outputs are the same bits; w8a8 has the unsharded bits (its row max
and int32 sums are reduced exactly). The shards' shapes: ``o`` / ``down``
keep their scales whole, column-sharded matrices cut theirs with the
payload, and each rank holds the kv columns its query heads read. The four
children run under tests/torch_ranks.py's group deadline.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cse_tpu.core.mesh import make_mesh as jax_make_mesh
from cse_tpu.models import llama as jl
from cse_tpu_torch.models import llama as tl
from torch_ranks import launch, tagged

torch.set_num_threads(1)

QUANTS = [None, "int8", "w8a8"]
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
IDS = [[1, 5, 9, 17, 33, 300], [0, 0, 1, 7, 21, 99], [0, 0, 0, 0, 0, 257]]
MASK = [[1, 1, 1, 1, 1, 1], [0, 0, 1, 1, 1, 1], [0, 0, 0, 0, 0, 1]]
TOL = dict(rtol=1e-4, atol=1e-4)
# tests/test_llama.py's random_llama_params configuration
RANDOM_CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2)

CHILD = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from cse_tpu_torch.core import mesh as M
from cse_tpu_torch.models import llama as tl

M.distributed_init_if_needed(device="cpu")
path, out, ids, mask = sys.argv[1], sys.argv[2], *(torch.tensor(json.loads(a)) for a in sys.argv[3:5])
meshes = {name: M.make_mesh(*json.loads(sys.argv[5])[name], device="cpu") for name in ("1x4", "2x2")}
res, shapes = {}, {}
for quant in (None, "int8", "w8a8"):
    for name, mesh in meshes.items():
        enc = tl.LlamaContextEncoder(path, ctx_length=2, dtype=torch.float32, quant=quant, device="cpu", mesh=mesh)
        tag = f"{quant}/{name}"
        res[tag + "/hidden"] = tl.llama_forward(enc.params, ids, mask, enc.cfg, mesh=mesh).numpy()
        res[tag + "/logits"] = enc.score_logits(ids, mask).numpy()
        res[tag + "/ctx"] = enc(ids, mask).numpy()
        lay = enc.params["layers"]
        shapes[tag] = {k: {kk: list(vv.shape) for kk, vv in lay[k].items()} if isinstance(lay[k], dict)
                       else list(lay[k].shape) for k in tl.LAYER_MATRICES}
        shapes[tag].update(embed=list(enc.params["embed"].shape), lm_head=list(enc.params["lm_head"].shape))
        if quant == "int8":
            res[tag + "/k_w"] = lay["k"]["w"].numpy()
# random weights drawn sharded: the shards of the unsharded draw
rp = tl.random_llama_params(tl.LlamaConfig(**json.loads(sys.argv[6])), quant="w8a8", with_lm_head=False,
                            device="cpu", mesh=meshes["1x4"])
res["random/w8a8/1x4/hidden"] = tl.llama_forward(rp, ids % 64, mask, tl.LlamaConfig(**json.loads(sys.argv[6])),
                                                 mesh=meshes["1x4"]).numpy()
np.savez(os.path.join(out, f"rank{M.process_index()}.npz"), **res)
print("SHAPES", json.dumps(shapes), flush=True)
"""


@pytest.fixture(scope="module")
def tiny_llama(tmp_path_factory):
    from transformers import LlamaConfig as HFConfig, LlamaForCausalLM

    torch.manual_seed(0)
    cfg = HFConfig(vocab_size=320, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                   rope_theta=10000.0, tie_word_embeddings=False, attn_implementation="eager")
    d = tmp_path_factory.mktemp("llama_tp")
    LlamaForCausalLM(cfg).eval().save_pretrained(str(d), safe_serialization=True)
    return str(d)


@pytest.fixture(scope="module")
def ranks(tiny_llama, tmp_path_factory):
    out = tmp_path_factory.mktemp("llama_tp_out")
    outs = launch(["-c", CHILD, tiny_llama, out, json.dumps(IDS), json.dumps(MASK), json.dumps(MESHES),
                   json.dumps(RANDOM_CFG)], 4)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(4)], tagged(outs)


def _unsharded(path, quant, **kw):
    params, cfg = tl.load_llama_params(path, dtype=torch.float32, quant=quant, device="cpu")
    return tl.llama_forward(params, torch.tensor(IDS), torch.tensor(MASK), cfg, **kw).numpy(), params


def _jax_tp(path, quant, return_logits=False):
    mesh = jax_make_mesh(n_data=2, n_model=4)
    params, cfg = jl.load_llama_params(path, dtype=jnp.float32, mesh=mesh, quant=quant)
    fwd = jax.jit(lambda p, i, m: jl.llama_forward(p, i, m, cfg, return_logits=return_logits))
    return np.asarray(fwd(params, jnp.asarray(IDS, jnp.int32), jnp.asarray(MASK, jnp.int32)))


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kind", ["hidden", "logits"])
def test_tensor_parallel_matches_unsharded_and_jax_mesh(tiny_llama, ranks, quant, mesh, kind):
    res, _ = ranks
    tag = f"{quant}/{mesh}/{kind}"
    got = res[0][tag]
    assert all(np.array_equal(got, r[tag]) for r in res[1:])  # every rank returns the same bits
    m = np.asarray(MASK, bool)
    ref, _ = _unsharded(tiny_llama, quant, return_logits=kind == "logits")
    np.testing.assert_allclose(got[m], ref[m], **TOL)
    if quant == "w8a8":
        assert np.array_equal(got, ref)
    np.testing.assert_allclose(got[m], _jax_tp(tiny_llama, quant, kind == "logits")[m], **TOL)


def test_encoder_reads_the_last_positions(ranks):
    res, _ = ranks
    for quant in QUANTS:
        for mesh in MESHES:
            hidden, ctx = (res[0][f"{quant}/{mesh}/{k}"] for k in ("hidden", "ctx"))
            assert ctx.shape == (3, 2, 32) and np.array_equal(ctx, hidden[:, -2:])


def test_shard_layout(tiny_llama, ranks):
    """int8 on the 1 x 4 mesh: q / gate / up cut their payload and scale by
    columns, o / down their payload by rows under a whole scale; k holds the
    8 columns of the one kv head its query head reads (rank m: head m // 2).
    On 2 x 2 each rank holds one of the two kv heads."""
    res, shapes = ranks
    L, D, dh, I, V = 2, 32, 8, 64, 320
    got = shapes[0]["SHAPES"]["int8/1x4"]
    assert got["q"] == {"w": [L, D, 8], "s": [L, 1, 8]}
    assert got["k"] == got["v"] == {"w": [L, D, dh], "s": [L, 1, dh]}
    assert got["o"] == {"w": [L, 8, D], "s": [L, 1, D]}
    assert got["down"] == {"w": [L, I // 4, D], "s": [L, 1, D]}
    assert got["gate"] == got["up"] == {"w": [L, D, I // 4], "s": [L, 1, I // 4]}
    assert got["embed"] == [V // 4, D] and got["lm_head"] == [D, V // 4]
    assert shapes[0]["SHAPES"]["None/2x2"]["k"] == [L, D, dh]
    assert shapes[0]["SHAPES"]["w8a8/1x4"]["o"] == {"w8": [L, 8, D], "s": [L, 1, D]}
    _, full = _unsharded(tiny_llama, "int8")
    for r in range(4):
        kv = r // 2
        np.testing.assert_array_equal(res[r]["int8/1x4/k_w"], full["layers"]["k"]["w"][:, :, kv * dh:(kv + 1) * dh])


def test_random_params_drawn_sharded_give_the_unsharded_bits(ranks):
    res, _ = ranks
    cfg = tl.LlamaConfig(**RANDOM_CFG)
    rp = tl.random_llama_params(cfg, quant="w8a8", with_lm_head=False, device="cpu")
    want = tl.llama_forward(rp, torch.tensor(IDS) % 64, torch.tensor(MASK), cfg).numpy()
    for r in res:
        assert np.array_equal(r["random/w8a8/1x4/hidden"], want)


def test_shardings_tree_and_scale_lookup():
    from cse_tpu_torch.core.mesh import make_mesh

    tree = tl.llama_shardings(make_mesh(device="cpu"))
    assert tree["embed"].spec == ("model", None) and tree["lm_head"].spec == (None, "model")
    assert tree["layers"]["o"].spec == tree["layers"]["down"].spec == (None, "model", None)
    assert tl._lookup(tree, ("layers", "o", "s")).spec == (None, None, None)
    assert tl._lookup(tree, ("layers", "q", "s")).spec == (None, None, "model")
    assert tl._lookup(tree, ("layers", "k", "w8")).spec == (None, None, "model")
