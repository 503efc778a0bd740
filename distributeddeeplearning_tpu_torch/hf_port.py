"""HuggingFace -> port weight porting (the switching user's on-ramp): the
JAX package's ``hf_port.py``.

Converts a ``transformers`` torch model's state dict into the flax
parameter tree the JAX package's models take, a nested dict of numpy
arrays; the port's models keep the same names and layouts, so
``weights.from_jax_params`` turns the tree into their ``state_dict``:

    from transformers import LlamaForCausalLM
    hf = LlamaForCausalLM.from_pretrained(local_dir)   # no network needed
    params = hf_port.port_from_hf("llama", hf)
    model = models.get_model("llama", size="300m")
    hf_port.validate_params(model, params)
    model.load_state_dict(weights.from_jax_params(params), strict=True)

Supported: ``gpt2`` (GPT2LMHeadModel), ``bert`` (BertForMaskedLM), ``vit``
(ViTForImageClassification), ``llama`` (LlamaForCausalLM); each function
returns the tree the JAX package's function of the same name returns.
Architecture dims are read from ``hf_model.config``. The module imports
neither ``transformers`` nor ``torch``: a port function only calls the HF
model's own methods. :func:`to_pipelined` restacks a GPT-2 or Llama tree
for ``gpt2_pp`` / ``llama_pp``; a pipeline rank then loads its rows of it
(``weights.rank_rows``):

    tree = hf_port.to_pipelined(hf_port.port_from_hf("gpt2", hf), 4)
    model = models.get_model("gpt2_pp", size="124m", num_stages=4, mesh=m)
    hf_port.validate_params(model, tree)
    model.load_state_dict(weights.rank_rows(weights.from_jax_params(tree),
                                            model.stage_rows))
"""

from __future__ import annotations

import numpy as np


def t2n(t):
    return t.detach().cpu().numpy()


def split_heads(w, n_heads, head_dim):
    """[in, out] -> [in, heads, kv]."""
    return w.reshape(w.shape[0], n_heads, head_dim)


def _linear(sd, key):
    """torch Linear -> flax dense kernel ([out,in] -> [in,out])."""
    return {"kernel": sd[f"{key}.weight"].T, "bias": sd[f"{key}.bias"]}


def _ln(sd, key):
    return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}


def _state_dict(hf_model):
    return {k: t2n(v) for k, v in hf_model.state_dict().items()}


def port_gpt2(hf_model):
    """GPT2LMHeadModel -> ``models/gpt2.py`` params."""
    cfg = hf_model.config
    n_layers, n_heads = cfg.n_layer, cfg.n_head
    head_dim = cfg.n_embd // n_heads
    d = n_heads * head_dim
    sd = _state_dict(hf_model)
    p = {
        "wte": {"embedding": sd["transformer.wte.weight"]},
        "wpe": {"embedding": sd["transformer.wpe.weight"]},
        "ln_f": _ln(sd, "transformer.ln_f"),
        "h": {},
    }
    for i in range(n_layers):
        pre = f"transformer.h.{i}"
        # HF Conv1D weights are [in, out] already.
        qw, kw, vw = np.split(sd[f"{pre}.attn.c_attn.weight"], 3, axis=1)
        qb, kb, vb = np.split(sd[f"{pre}.attn.c_attn.bias"], 3)
        p["h"][f"block_{i}"] = {
            "ln1": _ln(sd, f"{pre}.ln_1"),
            "ln2": _ln(sd, f"{pre}.ln_2"),
            "attn": {
                "query": {
                    "kernel": split_heads(qw, n_heads, head_dim),
                    "bias": qb.reshape(n_heads, head_dim),
                },
                "key": {
                    "kernel": split_heads(kw, n_heads, head_dim),
                    "bias": kb.reshape(n_heads, head_dim),
                },
                "value": {
                    "kernel": split_heads(vw, n_heads, head_dim),
                    "bias": vb.reshape(n_heads, head_dim),
                },
                "out": {
                    "kernel": sd[f"{pre}.attn.c_proj.weight"].reshape(
                        n_heads, head_dim, d
                    ),
                    "bias": sd[f"{pre}.attn.c_proj.bias"],
                },
            },
            "mlp": {
                "fc_in": {
                    "kernel": sd[f"{pre}.mlp.c_fc.weight"],
                    "bias": sd[f"{pre}.mlp.c_fc.bias"],
                },
                "fc_out": {
                    "kernel": sd[f"{pre}.mlp.c_proj.weight"],
                    "bias": sd[f"{pre}.mlp.c_proj.bias"],
                },
            },
        }
    return p


def port_bert(hf_model):
    """BertForMaskedLM -> ``models/bert.py`` params."""
    cfg = hf_model.config
    n_layers, n_heads = cfg.num_hidden_layers, cfg.num_attention_heads
    head_dim = cfg.hidden_size // n_heads
    d = n_heads * head_dim
    sd = _state_dict(hf_model)
    emb = "bert.embeddings"
    p = {
        "word_embeddings": {"embedding": sd[f"{emb}.word_embeddings.weight"]},
        "position_embeddings": {
            "embedding": sd[f"{emb}.position_embeddings.weight"]
        },
        "token_type_embeddings": {
            "embedding": sd[f"{emb}.token_type_embeddings.weight"]
        },
        "embeddings_ln": _ln(sd, f"{emb}.LayerNorm"),
        "mlm_transform": _linear(sd, "cls.predictions.transform.dense"),
        "mlm_ln": _ln(sd, "cls.predictions.transform.LayerNorm"),
        "mlm_bias": sd["cls.predictions.bias"],
        "encoder": {},
    }
    for i in range(n_layers):
        pre = f"bert.encoder.layer.{i}"

        def heads(key):
            lin = _linear(sd, key)
            return {
                "kernel": lin["kernel"].reshape(d, n_heads, head_dim),
                "bias": lin["bias"].reshape(n_heads, head_dim),
            }

        out_lin = _linear(sd, f"{pre}.attention.output.dense")
        p["encoder"][f"block_{i}"] = {
            "attn": {
                "query": heads(f"{pre}.attention.self.query"),
                "key": heads(f"{pre}.attention.self.key"),
                "value": heads(f"{pre}.attention.self.value"),
                "out": {
                    "kernel": out_lin["kernel"].reshape(n_heads, head_dim, d),
                    "bias": out_lin["bias"],
                },
            },
            "ln1": _ln(sd, f"{pre}.attention.output.LayerNorm"),
            "ln2": _ln(sd, f"{pre}.output.LayerNorm"),
            "mlp": {
                "fc_in": _linear(sd, f"{pre}.intermediate.dense"),
                "fc_out": _linear(sd, f"{pre}.output.dense"),
            },
        }
    return p


def port_vit(hf_model):
    """ViTForImageClassification -> ``models/vit.py`` params."""
    cfg = hf_model.config
    n_layers, n_heads = cfg.num_hidden_layers, cfg.num_attention_heads
    head_dim = cfg.hidden_size // n_heads
    d = n_heads * head_dim
    sd = _state_dict(hf_model)
    p = {
        "patch_embed": {
            # torch conv [out, in, h, w] -> flax [h, w, in, out]
            "kernel": sd["vit.embeddings.patch_embeddings.projection.weight"]
            .transpose(2, 3, 1, 0),
            "bias": sd["vit.embeddings.patch_embeddings.projection.bias"],
        },
        "cls_token": sd["vit.embeddings.cls_token"].reshape(1, d),
        "pos_embed": sd["vit.embeddings.position_embeddings"][0],
        "ln_f": _ln(sd, "vit.layernorm"),
        "head": _linear(sd, "classifier"),
        "encoder": {},
    }
    for i in range(n_layers):
        pre = f"vit.encoder.layer.{i}"

        def heads(key):
            lin = _linear(sd, key)
            return {
                "kernel": lin["kernel"].reshape(d, n_heads, head_dim),
                "bias": lin["bias"].reshape(n_heads, head_dim),
            }

        out_lin = _linear(sd, f"{pre}.attention.output.dense")
        p["encoder"][f"block_{i}"] = {
            "attn": {
                "query": heads(f"{pre}.attention.attention.query"),
                "key": heads(f"{pre}.attention.attention.key"),
                "value": heads(f"{pre}.attention.attention.value"),
                "out": {
                    "kernel": out_lin["kernel"].reshape(n_heads, head_dim, d),
                    "bias": out_lin["bias"],
                },
            },
            "ln1": _ln(sd, f"{pre}.layernorm_before"),
            "ln2": _ln(sd, f"{pre}.layernorm_after"),
            "mlp": {
                "fc_in": _linear(sd, f"{pre}.intermediate.dense"),
                "fc_out": _linear(sd, f"{pre}.output.dense"),
            },
        }
    return p


def port_llama(hf_model):
    """LlamaForCausalLM -> ``models/llama.py`` params."""
    cfg = hf_model.config
    n_layers, n_heads = cfg.num_hidden_layers, cfg.num_attention_heads
    n_kv_heads = cfg.num_key_value_heads
    head_dim = cfg.hidden_size // n_heads
    # Exact-port guarantees: refuse what our Llama cannot represent rather
    # than silently dropping tensors (bias'd projections — Qwen-style
    # variants) or mis-reshaping (decoupled cfg.head_dim).
    if getattr(cfg, "attention_bias", False):
        raise ValueError(
            "attention_bias=True checkpoints are not portable: "
            "models/llama.py projections are bias-free"
        )
    if getattr(cfg, "mlp_bias", False):
        raise ValueError(
            "mlp_bias=True checkpoints are not portable: "
            "models/llama.py MLP projections are bias-free"
        )
    cfg_head_dim = getattr(cfg, "head_dim", None)
    if cfg_head_dim is not None and cfg_head_dim != head_dim:
        raise ValueError(
            f"decoupled head_dim {cfg_head_dim} != hidden_size/num_heads "
            f"{head_dim} is not representable by models/llama.py"
        )
    sd = _state_dict(hf_model)

    def heads(key, n):
        w = sd[f"{key}.weight"].T  # [embed, n*head_dim]
        return {"kernel": w.reshape(w.shape[0], n, head_dim)}

    p = {
        "embed": {"embedding": sd["model.embed_tokens.weight"]},
        "norm": {"scale": sd["model.norm.weight"]},
    }
    # Tied checkpoints (Llama-3.2-class) have no independent lm_head
    # tensor; build the model with tie_embeddings=True (validate_params
    # names a mismatch: the extra or missing lm_head).
    if not getattr(cfg, "tie_word_embeddings", False):
        p["lm_head"] = sd["lm_head.weight"].T
    for i in range(n_layers):
        pre = f"model.layers.{i}"
        p[f"block_{i}"] = {
            "attn_norm": {"scale": sd[f"{pre}.input_layernorm.weight"]},
            "mlp_norm": {
                "scale": sd[f"{pre}.post_attention_layernorm.weight"]
            },
            "attn": {
                "query": heads(f"{pre}.self_attn.q_proj", n_heads),
                "key": heads(f"{pre}.self_attn.k_proj", n_kv_heads),
                "value": heads(f"{pre}.self_attn.v_proj", n_kv_heads),
                "out": {
                    "kernel": (lambda w: w.reshape(
                        n_heads, head_dim, w.shape[-1]
                    ))(sd[f"{pre}.self_attn.o_proj.weight"].T)
                },
            },
            "mlp": {
                "gate": {"kernel": sd[f"{pre}.mlp.gate_proj.weight"].T},
                "up": {"kernel": sd[f"{pre}.mlp.up_proj.weight"].T},
                "down": {"kernel": sd[f"{pre}.mlp.down_proj.weight"].T},
            },
        }
    return p


PORTERS = {
    "gpt2": port_gpt2,
    "bert": port_bert,
    "vit": port_vit,
    "llama": port_llama,
}


def port_from_hf(model_name: str, hf_model):
    """Port a transformers model's weights for the named zoo model."""
    if model_name not in PORTERS:
        raise KeyError(
            f"no HF porter for {model_name!r}; have {sorted(PORTERS)}"
        )
    return PORTERS[model_name](hf_model)


def to_pipelined(params, num_stages: int):
    """A FLAT GPT-2 or Llama tree (an HF port's too) -> the stage-stacked
    tree of ``gpt2_pp`` / ``llama_pp``: the per-layer blocks (GPT-2's
    ``h/block_i``, Llama's top-level ``block_i``) grouped into
    ``num_stages`` contiguous stages and stacked on a leading stage axis
    under ``h/stages/block_j`` (j the stage-local layer); the embeddings,
    the final norm and the head map through unchanged. The JAX package's
    ``to_pipelined``, on numpy leaves."""
    if "h" in params:  # GPT-2 family: blocks live under 'h'
        blocks = dict(params["h"])
        other = {k: v for k, v in params.items() if k != "h"}
    else:  # Llama family: blocks at the top level
        blocks = {k: v for k, v in params.items() if k.startswith("block_")}
        other = {k: v for k, v in params.items()
                 if not k.startswith("block_")}
    n_layers = len(blocks)
    missing = [f"block_{i}" for i in range(n_layers)
               if f"block_{i}" not in blocks]
    if missing or not n_layers:
        raise ValueError(
            f"unrecognized flat param tree (layers={n_layers}, "
            f"missing={missing[:3]})"
        )
    if n_layers % num_stages:
        raise ValueError(
            f"num_layers={n_layers} not divisible by num_stages={num_stages}"
        )
    per = n_layers // num_stages

    def stack(trees):
        if hasattr(trees[0], "items"):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack([np.asarray(t) for t in trees])

    stages = {f"block_{j}": stack([blocks[f"block_{s * per + j}"]
                                   for s in range(num_stages)])
              for j in range(per)}
    return {**other, "h": {"stages": stages}}


def _flat_shapes(tree, prefix: str = "") -> dict:
    """A nested dict tree -> {dotted leaf path: shape}: the names
    ``weights.from_jax_params`` gives the leaves."""
    out = {}
    for key, leaf in tree.items():
        name = f"{prefix}{key}"
        if hasattr(leaf, "items"):
            out.update(_flat_shapes(leaf, f"{name}."))
        else:
            out[name] = tuple(np.shape(leaf))
    return out


def validate_params(model, params) -> None:
    """Raise if ``params`` (a ported tree) does not match ``model``'s own
    parameters, by flattened name and shape, naming the missing, the extra
    and the mismatched leaves. A pipelined model's stage leaves are held at
    their whole ``[num_stages, ...]`` shape, whichever rows the rank holds. A strict ``load_state_dict`` refuses such a
    tree too, but without saying which checkpoint setting is at fault:
    run this after porting.

        params = hf_port.port_from_hf("llama", hf)
        hf_port.validate_params(model, params)
    """
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    shards = getattr(model, "shards", None)
    if shards is not None:  # a rank holds its blocks of the leaves it cuts
        want = {k: shards.whole_shape(k, s) for k, s in want.items()}
    rows = getattr(model, "stage_rows", None)
    if rows is not None:  # a pipeline rank holds some rows of the stack
        want = {k: rows.whole_shape(k, s) for k, s in want.items()}
    got = _flat_shapes(params)
    if want == got:
        return
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    mismatched = sorted(k for k in set(want) & set(got) if want[k] != got[k])
    detail = []
    if missing:
        detail.append(f"missing leaves: {missing[:5]}")
    if extra:
        detail.append(f"extra leaves: {extra[:5]}")
    if mismatched:
        detail.append(
            "shape mismatches: "
            + "; ".join(f"{k}: want {want[k]}, got {got[k]}"
                        for k in mismatched[:5])
        )
    raise ValueError(
        "ported params do not match the model's param tree ("
        + "; ".join(detail)
        + " — check model kwargs, e.g. tie_embeddings vs the checkpoint's"
        " tie_word_embeddings)"
    )
