"""The port's ``hf_port`` against the JAX package's.

Tiny HF models built from config objects (never ``from_pretrained``) go
through both packages' porters: the trees are equal leaf for leaf (same
paths, shapes, dtypes and values) for ``gpt2``, ``bert``, ``vit`` and
``llama``, tied and untied. Each tree loads strictly into the port's model
of that name and gives HF's logits (fp32, atol 2e-4, rtol 1e-4, the JAX
package's golden tolerance). ``port_llama``'s three refusals,
``validate_params`` naming missing, extra and mismatched leaves, and
``port_from_hf``'s ``KeyError`` follow the reference.
"""

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu import hf_port as jax_hf_port
from distributeddeeplearning_tpu_torch import hf_port, models
from distributeddeeplearning_tpu_torch.weights import from_jax_params

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)


def _hf(name, tie=False):
    t = transformers
    torch.manual_seed(0)
    if name == "gpt2":
        return t.GPT2LMHeadModel(t.GPT2Config(
            vocab_size=97, n_positions=64, n_embd=64, n_layer=2, n_head=4,
            activation_function="gelu_new", resid_pdrop=0.0, embd_pdrop=0.0,
            attn_pdrop=0.0)).eval()
    if name == "bert":
        return t.BertForMaskedLM(t.BertConfig(
            vocab_size=97, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            max_position_embeddings=64, type_vocab_size=2,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            hidden_act="gelu")).eval()
    if name == "vit":
        return t.ViTForImageClassification(t.ViTConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=256, image_size=32, patch_size=8,
            num_channels=3, num_labels=10, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0, hidden_act="gelu")).eval()
    return t.LlamaForCausalLM(t.LlamaConfig(
        vocab_size=97, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-6,
        tie_word_embeddings=tie)).eval()


def _port_model(name, tie=False):
    kw = {
        "gpt2": dict(size="tiny", vocab_size=97, max_len=64),
        "bert": dict(size="tiny", vocab_size=97, max_len=64),
        "vit": dict(size="tiny", num_classes=10, image_size=32,
                    patch_size=8, num_layers=2, num_heads=4, embed_dim=64),
        "llama": dict(size="tiny", vocab_size=97, max_len=64,
                      tie_embeddings=tie),
    }[name]
    return models.get_model(name, **kw)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


CASES = [("gpt2", False), ("bert", False), ("vit", False), ("llama", False),
         ("llama", True)]


@pytest.mark.parametrize("name,tie", CASES)
def test_trees_equal_the_jax_package_s(name, tie):
    hf = _hf(name, tie)
    want = _flat(jax_hf_port.port_from_hf(name, hf))
    got = _flat(hf_port.port_from_hf(name, hf))
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        assert np.array_equal(got[k], v), k


@pytest.mark.parametrize("name,tie", CASES)
def test_ported_trees_load_and_give_hf_logits(name, tie):
    hf = _hf(name, tie)
    params = hf_port.port_from_hf(name, hf)
    model = _port_model(name, tie)
    hf_port.validate_params(model, params)
    model.load_state_dict(from_jax_params(params), strict=True)
    rng = np.random.default_rng(0)
    if name == "vit":
        x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
        with torch.no_grad():
            want = hf(torch.from_numpy(x).permute(0, 3, 1, 2)).logits
            got = model(torch.from_numpy(x))
    else:
        tok = torch.from_numpy(rng.integers(0, 97, (2, 13)))
        with torch.no_grad():
            want = hf(tok).logits
            got = model(tok)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4,
                               rtol=1e-4)


_LLAMA = dict(vocab_size=64, hidden_size=64, intermediate_size=128,
              num_hidden_layers=1, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=32,
              tie_word_embeddings=False)


@pytest.mark.parametrize("extra,match", [
    (dict(attention_bias=True), "attention_bias"),
    (dict(mlp_bias=True), "mlp_bias"),
    (dict(head_dim=8), "head_dim"),
])
def test_port_llama_refuses_unrepresentable_checkpoints(extra, match):
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        **_LLAMA, **extra))
    with pytest.raises(ValueError, match=match) as jerr:
        jax_hf_port.port_llama(hf)
    with pytest.raises(ValueError, match=match) as err:
        hf_port.port_llama(hf)
    assert str(err.value) == str(jerr.value)


def test_validate_params_catches_a_tie_mismatch():
    params = hf_port.port_llama(_hf("llama", tie=False))
    hf_port.validate_params(_port_model("llama"), params)
    with pytest.raises(ValueError, match=r"extra leaves: \['lm_head'\]"):
        hf_port.validate_params(_port_model("llama", tie=True), params)
    tied = hf_port.port_llama(_hf("llama", tie=True))
    with pytest.raises(ValueError, match=r"missing leaves: \['lm_head'\]"):
        hf_port.validate_params(_port_model("llama"), tied)


def test_validate_params_names_a_deep_mismatched_leaf():
    """A wrong head_dim reshape deep in the tree ([E, H, D] -> [E, H/2,
    2D], the same element count) names the leaf and both shapes."""
    params = hf_port.port_llama(_hf("llama"))
    leaf = params["block_1"]["attn"]["query"]["kernel"]
    params["block_1"]["attn"]["query"]["kernel"] = leaf.reshape(
        leaf.shape[0], leaf.shape[1] // 2, leaf.shape[2] * 2)
    with pytest.raises(ValueError, match=r"block_1\.attn\.query\.kernel: "
                       r"want \(64, 4, 16\), got \(64, 2, 32\)"):
        hf_port.validate_params(_port_model("llama"), params)


def test_port_from_hf_names_what_it_has():
    with pytest.raises(KeyError, match=r"no HF porter for 'resnet50'; have "
                       r"\['bert', 'gpt2', 'llama', 'vit'\]"):
        hf_port.port_from_hf("resnet50", object())
    assert sorted(hf_port.PORTERS) == sorted(jax_hf_port.PORTERS)
