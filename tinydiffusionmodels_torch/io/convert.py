"""Weight bridge between the JAX package and the port (counterpart of the
text maps in ``io/checkpoint.py``, which imports jax and so is not imported).

- ``*_state_from_jax``: the JAX package's parameter trees (leaves as numpy
  arrays, or anything ``np.asarray`` takes) -> the port's state dicts, with
  the same transposes as ``io/checkpoint.py`` (linear weights (in, out) ->
  (out, in); fused qkv (d, 3d) -> (3d, d)).
- ``text_checkpoint_dict``: the dict layout ``train/text_train.py`` writes,
  built from the port's modules, so the JAX CLI reads what the port saves.
- ``tiny_gpt_state_from_jax`` / ``tiny_gpt_params_dict``: the guided
  sampler's base LM both ways, so each CLI loads the other's
  ``lm_ckpt.pth`` (``{"params": <JAX tree>}``).
- ``gemma_state_from_jax``: the JAX Gemma's parameter tree (``models/
  gemma.py``'s, as ``gemma_from_hf_state_dict`` builds it) -> the port's
  ``Gemma`` state dict, HF's names (the inverse of that conversion).
- ``unet_state_from_jax`` / ``unet_params_dict``: the MNIST UNet both ways
  (conv kernels HWIO <-> OIHW, ``time_emb`` (in, out) <-> (out, in), no
  ``skip`` keys for an identity skip); ``unet_checkpoint_dict`` is the bare
  state dict both CLIs save as the MNIST ``.pth``.
- ``state_from_checkpoint`` / ``config_from_state_dict``: a loaded
  checkpoint's numpy state dict -> tensors, and the model shape it implies.
- ``params_tree`` / ``state_from_tree``: a trainer's model (the text
  trainer's joint ``ModuleDict``, or the UNet) <-> the JAX package's
  parameter tree of it; ``adamw_state_to_jax`` / ``adamw_state_from_jax``
  move AdamW's moments and step through them to and from optax
  ``adamw``'s state leaves, the ``opt_state_leaves`` of a resume file.
- ``classifier_state_from_jax``: the fidelity classifier's JAX tree ->
  the port's ``DigitClassifier`` state dict.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

if TYPE_CHECKING:  # the models load their initial weights through here
    from tinydiffusionmodels_torch.models.transformer import (
        TinyTransformer,
        TransformerConfig,
    )


def _t(x) -> torch.Tensor:
    """``x`` as a float32 tensor: a tensor stays on its device (the
    initialisers' trees, ``models.init``), anything else goes through
    numpy."""
    if torch.is_tensor(x):
        return x.detach().to(torch.float32).contiguous()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _permute(x, *axes):
    """``x`` (a tensor, or anything numpy takes) with its axes permuted."""
    if torch.is_tensor(x):
        return x.permute(*axes)
    return np.asarray(x).transpose(axes)


def _lin(p: dict, name: str, sd: dict) -> None:
    sd[f"{name}.weight"] = _t(_permute(p["w"], 1, 0))
    sd[f"{name}.bias"] = _t(p["b"])


def transformer_state_from_jax(params: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX TinyTransformer params -> TinyTransformer state dict."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _lin(params["time_emb"], "time_emb", sd)
    if "pos_emb" in params:
        sd["pos_emb.weight"] = _t(params["pos_emb"])
    if "selfcond_proj" in params:
        _lin(params["selfcond_proj"], "selfcond_proj", sd)
    for i, layer in enumerate(params["layers"]):
        pre = f"encoder.layers.{i}"
        attn = layer["self_attn"]
        sd[f"{pre}.self_attn.in_proj_weight"] = _t(
            _permute(attn["in_proj"]["w"], 1, 0))
        sd[f"{pre}.self_attn.in_proj_bias"] = _t(attn["in_proj"]["b"])
        _lin(attn["out_proj"], f"{pre}.self_attn.out_proj", sd)
        _lin(layer["linear1"], f"{pre}.linear1", sd)
        _lin(layer["linear2"], f"{pre}.linear2", sd)
        for norm in ("norm1", "norm2"):
            sd[f"{pre}.{norm}.weight"] = _t(layer[norm]["scale"])
            sd[f"{pre}.{norm}.bias"] = _t(layer[norm]["bias"])
    return sd


def rounding_state_from_jax(params: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX rounding params {'decoder': {'w', 'b'}} -> LearnedRounding."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _lin(params["decoder"], "decoder", sd)
    return sd


def embedding_state_from_jax(params: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX embedding params {'weight'} -> LearnedEmbedding."""
    return OrderedDict([("embeddings.weight", _t(params["weight"]))])


_GPT_LINEARS = (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc"),
                ("mlp", "proj"))


def tiny_gpt_state_from_jax(params: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX TinyGPT params (``init_tiny_gpt``'s tree, or the 'params' of an
    ``lm_ckpt.pth``; ``blocks`` a tuple or list) -> TinyGPT state dict."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    sd["tok_emb.weight"] = _t(params["tok_emb"])
    sd["pos_emb.weight"] = _t(params["pos_emb"])
    for i, blk in enumerate(params["blocks"]):
        pre = f"blocks.{i}"
        for norm in ("ln1", "ln2"):
            sd[f"{pre}.{norm}.weight"] = _t(blk[norm]["scale"])
            sd[f"{pre}.{norm}.bias"] = _t(blk[norm]["bias"])
        for group, name in _GPT_LINEARS:
            _lin(blk[group][name], f"{pre}.{group}.{name}", sd)
    sd["ln_f.weight"] = _t(params["ln_f"]["scale"])
    sd["ln_f.bias"] = _t(params["ln_f"]["bias"])
    sd["lm_head.weight"] = _t(_permute(params["lm_head"]["w"], 1, 0))
    return sd


def tiny_gpt_params_dict(module: torch.nn.Module) -> dict[str, Any]:
    """The inverse of ``tiny_gpt_state_from_jax``: a TinyGPT -> the JAX
    parameter tree with float32 numpy leaves (``blocks`` a list), the
    'params' the JAX CLI saves in ``lm_ckpt.pth``."""
    sd = _numpy_state(module)
    blocks = []
    for i in range(len(module.blocks)):
        pre = f"blocks.{i}"
        blk: dict[str, Any] = {
            norm: {"scale": sd[f"{pre}.{norm}.weight"],
                   "bias": sd[f"{pre}.{norm}.bias"]}
            for norm in ("ln1", "ln2")
        }
        for group, name in _GPT_LINEARS:
            blk.setdefault(group, {})[name] = {
                "w": np.ascontiguousarray(sd[f"{pre}.{group}.{name}.weight"].T),
                "b": sd[f"{pre}.{group}.{name}.bias"],
            }
        blocks.append(blk)
    return {
        "tok_emb": sd["tok_emb.weight"],
        "pos_emb": sd["pos_emb.weight"],
        "blocks": blocks,
        "ln_f": {"scale": sd["ln_f.weight"], "bias": sd["ln_f.bias"]},
        "lm_head": {"w": np.ascontiguousarray(sd["lm_head.weight"].T)},
    }


# JAX Gemma layer key -> the port's (HF's) name under model.layers.N, and
# whether it is a linear weight stored (in, out) in JAX.
_GEMMA_LAYER = (("input_norm", "input_layernorm.weight", False),
                ("q_proj", "self_attn.q_proj.weight", True),
                ("k_proj", "self_attn.k_proj.weight", True),
                ("v_proj", "self_attn.v_proj.weight", True),
                ("o_proj", "self_attn.o_proj.weight", True),
                ("post_attn_norm", "post_attention_layernorm.weight", False),
                ("gate_proj", "mlp.gate_proj.weight", True),
                ("up_proj", "mlp.up_proj.weight", True),
                ("down_proj", "mlp.down_proj.weight", True))


def gemma_state_from_jax(params: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX Gemma params (``{"embed", "layers", "final_norm"}``, leaves as
    numpy arrays) -> the port's ``Gemma`` state dict: linear weights (in,
    out) -> (out, in), the inverse of ``gemma_from_hf_state_dict``. The
    head is tied, so there is no ``lm_head.weight``."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    sd["model.embed_tokens.weight"] = _t(params["embed"])
    for i, layer in enumerate(params["layers"]):
        for key, name, linear in _GEMMA_LAYER:
            x = np.asarray(layer[key])
            sd[f"model.layers.{i}.{name}"] = _t(x.T if linear else x)
    sd["model.norm.weight"] = _t(params["final_norm"])
    return sd


_UNET_BLOCKS = ("rb1", "rb2", "rb3", "rb4")


def _conv(p: dict, name: str, sd: dict) -> None:
    sd[f"{name}.weight"] = _t(_permute(p["w"], 3, 2, 0, 1))
    sd[f"{name}.bias"] = _t(p["b"])


def unet_state_from_jax(params: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX SimpleUNet params (``init_unet``'s tree) -> SimpleUNet state
    dict, in ``io/checkpoint.unet_to_state_dict``'s key order."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name in _UNET_BLOCKS:
        p = params[name]
        _conv(p["conv1"], f"{name}.conv1", sd)
        _conv(p["conv2"], f"{name}.conv2", sd)
        _lin(p["time_emb"], f"{name}.time_emb", sd)
        if p.get("skip") is not None:
            _conv(p["skip"], f"{name}.skip", sd)
    _conv(params["out"], "out", sd)
    return sd


def unet_params_dict(module: torch.nn.Module) -> dict[str, Any]:
    """The inverse of ``unet_state_from_jax``: a SimpleUNet -> the JAX
    parameter tree with float32 numpy leaves (HWIO kernels; ``skip`` None
    for the identity skip)."""
    return _unet_tree(_numpy_state(module))


def _unet_tree(sd: dict) -> dict[str, Any]:
    """``unet_params_dict`` of a SimpleUNet state dict (numpy leaves)."""

    def conv(name):
        return {"w": np.ascontiguousarray(
                    sd[f"{name}.weight"].transpose(2, 3, 1, 0)),
                "b": sd[f"{name}.bias"]}

    params: dict[str, Any] = {}
    for name in _UNET_BLOCKS:
        params[name] = {
            "conv1": conv(f"{name}.conv1"),
            "conv2": conv(f"{name}.conv2"),
            "time_emb": {
                "w": np.ascontiguousarray(sd[f"{name}.time_emb.weight"].T),
                "b": sd[f"{name}.time_emb.bias"]},
            "skip": (conv(f"{name}.skip") if f"{name}.skip.weight" in sd
                     else None),
        }
    params["out"] = conv("out")
    return params


def unet_checkpoint_dict(module: torch.nn.Module) -> "OrderedDict[str, np.ndarray]":
    """The MNIST checkpoint: the UNet's bare state dict with numpy leaves,
    the reference's format (src/mnist.py:165) that the JAX CLI writes with
    ``unet_to_state_dict``."""
    return _numpy_state(module)


def _transformer_tree(sd: dict) -> dict[str, Any]:
    """The inverse of ``transformer_state_from_jax``: a TinyTransformer
    state dict (numpy leaves) -> the JAX parameter tree (``layers`` a
    tuple, as ``io/checkpoint.transformer_from_state_dict`` builds it)."""

    def lin(name):
        return {"w": np.ascontiguousarray(np.asarray(sd[f"{name}.weight"]).T),
                "b": np.asarray(sd[f"{name}.bias"])}

    layers = []
    while f"encoder.layers.{len(layers)}.self_attn.in_proj_weight" in sd:
        pre = f"encoder.layers.{len(layers)}"
        layers.append({
            "self_attn": {
                "in_proj": {
                    "w": np.ascontiguousarray(
                        np.asarray(sd[f"{pre}.self_attn.in_proj_weight"]).T),
                    "b": np.asarray(sd[f"{pre}.self_attn.in_proj_bias"])},
                "out_proj": lin(f"{pre}.self_attn.out_proj"),
            },
            "linear1": lin(f"{pre}.linear1"),
            "linear2": lin(f"{pre}.linear2"),
            **{norm: {"scale": np.asarray(sd[f"{pre}.{norm}.weight"]),
                      "bias": np.asarray(sd[f"{pre}.{norm}.bias"])}
               for norm in ("norm1", "norm2")},
        })
    tree: dict[str, Any] = {"time_emb": lin("time_emb"),
                            "layers": tuple(layers)}
    if "pos_emb.weight" in sd:
        tree["pos_emb"] = np.asarray(sd["pos_emb.weight"])
    if "selfcond_proj.weight" in sd:
        tree["selfcond_proj"] = lin("selfcond_proj")
    return tree


# The text trainer's joint model: key -> (state dict -> JAX tree, JAX tree
# -> state dict).
_JOINT = {
    "diffusion_model": (_transformer_tree, transformer_state_from_jax),
    "rounding_fn": (
        lambda sd: {"decoder": {
            "w": np.ascontiguousarray(np.asarray(sd["decoder.weight"]).T),
            "b": np.asarray(sd["decoder.bias"])}},
        rounding_state_from_jax),
    "embedding_fn": (lambda sd: {"weight": np.asarray(sd["embeddings.weight"])},
                     embedding_state_from_jax),
}


def params_tree(module: torch.nn.Module, sd: dict | None = None) -> dict:
    """The JAX package's parameter tree of a trainer's model: the text
    trainer's joint ``ModuleDict`` ({'diffusion_model', 'rounding_fn'[,
    'embedding_fn']}) or a SimpleUNet. ``sd`` (parameter name -> array)
    replaces the parameters' values, e.g. with AdamW's moments."""
    sd = _numpy_state(module) if sd is None else sd
    if not isinstance(module, torch.nn.ModuleDict):
        return _unet_tree(sd)
    return {key: _JOINT[key][0]({k[len(key) + 1:]: v for k, v in sd.items()
                                 if k.startswith(key + ".")})
            for key in module}


def state_from_tree(module: torch.nn.Module,
                    tree: dict) -> "OrderedDict[str, torch.Tensor]":
    """The inverse of ``params_tree``: a JAX parameter tree -> ``module``'s
    state dict (float32 tensors)."""
    if not isinstance(module, torch.nn.ModuleDict):
        return unet_state_from_jax(tree)
    return OrderedDict((f"{key}.{k}", v) for key in module
                       for k, v in _JOINT[key][1](tree[key]).items())


def _tree_leaves(tree) -> list:
    """The leaves of a parameter tree in ``jax.tree_util``'s order: a
    dict's values by sorted key, a list's or tuple's in order, None
    holding none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _tree_fill(tree, leaves):
    """``tree`` with its leaves taken in turn from the iterator
    ``leaves``, in ``_tree_leaves``' order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_fill(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)([_tree_fill(v, leaves) for v in tree])
    return next(leaves)


def adamw_state_to_jax(optimizer: torch.optim.Optimizer,
                       params: torch.nn.Module, *,
                       schedule: bool) -> list[np.ndarray]:
    """AdamW's state of ``params`` as optax ``adamw``'s state leaves:
    ``[count, *mu, *nu]``, and the schedule's count after them when the
    learning rate is ``schedule``d; ``mu`` and ``nu`` are the moments laid
    out as the JAX parameter tree (``params_tree``: linear weights
    transposed as the parameters are) in its sorted-key leaf order, and
    the counts are int32 (torch's ``state["step"]``). A parameter the
    optimizer does not step (``--freeze_embeddings``' table) gets zero
    moments, as JAX's zero-gradient ones are."""
    step = 0
    mu: dict = {}
    nu: dict = {}
    for name, p in params.named_parameters():
        state = optimizer.state.get(p, {})
        if "exp_avg" in state:
            mu[name] = state["exp_avg"].detach().cpu().numpy()
            nu[name] = state["exp_avg_sq"].detach().cpu().numpy()
            step = int(state["step"].item())
        else:
            mu[name] = nu[name] = np.zeros(tuple(p.shape), np.float32)
    count = np.asarray(step, np.int32)
    leaves = [count, *_tree_leaves(params_tree(params, mu)),
              *_tree_leaves(params_tree(params, nu))]
    if schedule:
        leaves.append(count.copy())
    return leaves


def adamw_state_from_jax(opt_state_leaves: list, params: torch.nn.Module):
    """The inverse of ``adamw_state_to_jax`` (with or without the
    schedule's count): (step, exp_avg, exp_avg_sq), the moments as
    ``params``' state dicts of float32 tensors. Raises ValueError when the
    leaves are not those of ``params``."""
    tree = params_tree(params)
    n = len(_tree_leaves(tree))
    if len(opt_state_leaves) not in (1 + 2 * n, 2 + 2 * n):
        raise ValueError(f"{len(opt_state_leaves)} optimizer leaves for a "
                         f"model of {n} parameters")
    # A saved 0-d count comes back with shape (1,) (both packages' writers).
    step = int(np.asarray(opt_state_leaves[0]).reshape(-1)[0])
    mu, nu = (state_from_tree(params, _tree_fill(tree, iter(leaves)))
              for leaves in (opt_state_leaves[1:1 + n],
                             opt_state_leaves[1 + n:1 + 2 * n]))
    return step, mu, nu


def classifier_state_from_jax(params: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX classifier params (``models/classifier.init_classifier``'s tree)
    -> ``DigitClassifier`` state dict. JAX flattens the (B, 7, 7, 32) map
    in HWC order and the port's NCHW map flattens in CHW order, so
    ``fc1``'s 1568 input rows are permuted from HWC to CHW."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _conv(params["conv1"], "conv1", sd)
    _conv(params["conv2"], "conv2", sd)
    w1 = params["fc1"]["w"]                          # (7*7*32, 128), HWC rows
    if not torch.is_tensor(w1):
        w1 = np.asarray(w1)
    w1 = _permute(w1.reshape(7, 7, 32, -1), 2, 0, 1, 3).reshape(w1.shape)
    _lin({"w": w1, "b": params["fc1"]["b"]}, "fc1", sd)
    _lin(params["fc2"], "fc2", sd)
    return sd


def state_from_checkpoint(sd: dict) -> "OrderedDict[str, torch.Tensor]":
    """A loaded checkpoint's state dict (numpy leaves) -> float32 tensors."""
    return OrderedDict((k, _t(v)) for k, v in sd.items())


def config_from_state_dict(
    sd: dict, cfg: TransformerConfig
) -> TransformerConfig:
    """``cfg`` with every field the state dict determines taken from it:
    width, depth, FFN width, self-conditioning and the absolute-position
    table (present or not, and its length). The JAX package reads the same
    facts off the loaded parameters; rope has no weights, so it stays as
    ``cfg`` (and the checkpoint's 'pos_emb' key) says."""
    depth = 0
    while f"encoder.layers.{depth}.self_attn.in_proj_weight" in sd:
        depth += 1
    if depth == 0:
        raise ValueError("no encoder layers found in state_dict")
    if "pos_emb.weight" in sd:
        pos_emb, max_len = "abs", int(np.shape(sd["pos_emb.weight"])[0])
    else:
        pos_emb = "none" if cfg.pos_kind == "abs" else cfg.pos_kind
        max_len = cfg.max_len
    return dataclasses.replace(
        cfg,
        dim=int(np.shape(sd["time_emb.weight"])[0]),
        depth=depth,
        ffn_dim=int(np.shape(sd["encoder.layers.0.linear1.weight"])[0]),
        self_cond="selfcond_proj.weight" in sd,
        pos_emb=pos_emb,
        max_len=max_len,
    )


def _numpy_state(module: torch.nn.Module) -> "OrderedDict[str, np.ndarray]":
    return OrderedDict(
        (k, v.detach().to("cpu", torch.float32).numpy())
        for k, v in module.state_dict().items()
    )


def text_checkpoint_dict(
    diffusion_model: TinyTransformer,
    rounding: torch.nn.Module,
    embedding: torch.nn.Module | None = None,
    *,
    epoch: int = 0,
    tokenizer_state: dict | None = None,
    parameterization: str = "eps",
    noise_schedule: str = "linear",
    embed_norm: str = "none",
    anchor_ce: float = 0.0,
    extra: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """The checkpoint dict of ``train/text_train._checkpoint_dict``, with
    numpy leaves for ``save_checkpoint``. Positions and self-conditioning
    are the model's own (``diffusion_model.cfg``): rope has no weights, so
    the 'pos_emb' key is its only record. ``anchor_ce`` is recorded only
    when nonzero, and ``extra`` keys ('val_loss', 'final_training') go on
    top, as in the JAX package."""
    cfg = diffusion_model.cfg
    ckpt: dict[str, Any] = {
        "diffusion_model": _numpy_state(diffusion_model),
        "rounding_fn": _numpy_state(rounding),
        "epoch": epoch,
        "parameterization": parameterization,
        "self_cond": cfg.self_cond,
        "noise_schedule": noise_schedule,
        "embed_norm": embed_norm,
        "pos_emb": cfg.pos_kind,
    }
    if anchor_ce:
        ckpt["anchor_ce"] = anchor_ce
    if embedding is not None:
        ckpt["embedding_fn"] = _numpy_state(embedding)
    if tokenizer_state:
        ckpt["tokenizer"] = tokenizer_state
    if extra:
        ckpt.update(extra)
    return ckpt
