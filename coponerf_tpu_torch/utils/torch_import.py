"""Import a checkpoint of the reference PyTorch ``CoPoNeRF`` (``.pth``).

The port's own copy of ``coponerf_tpu/utils/torch_import.py``: the same key
maps take the reference's ``state_dict`` (its module names, torchvision's
ResNet-34 names in the encoder, backbone.py:52-57) to the flax-style tree of
``{"params": ..., "batch_stats": ...}``, converting layouts

    Linear (out, in)            -> kernel (in, out)
    Conv2d (O, I, kh, kw)       -> kernel (kh, kw, I, O)
    1x1 Conv2d / Conv1d head    -> kernel (I, O)
    BatchNorm weight / running_* -> scale / batch_stats mean, var
    LayerNorm / GroupNorm weight -> scale

and ``utils/convert.py:convert`` takes that tree to the port's own keys.
``import_reference`` composes the two and holds the result to the port's
module: every key must land on a parameter or buffer of the shape the
module has, and every parameter and buffer must be covered.

Unused reference parameters (corr_embed CoPoNeRF.py:73, latent_avg_*
:89-93, cross_attn.qkv backbone.py:294, the ResNet's fc head) are skipped,
as the reference's own strict=False load skips them (train.py:116).  The
maps assume torchvision's ResNet-34 block layout (``RESNET_LAYER_BLOCKS``);
a key outside them raises ``KeyError``.

``torch.load`` unpickles the file (``weights_only=False``, as the reference
checkpoints may hold more than tensors): load only files you trust.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from coponerf_tpu_torch.utils.convert import convert

SKIP_PATTERNS = [
    r"^corr_embed\.",
    r"^latent_avg_",
    r"\.cross_attn\.qkv\.",
    r"num_batches_tracked$",
    r"^encoder\.model\.fc\.",
    r"^encoder\.model\.avgpool\.",
]

RESNET_LAYER_BLOCKS = {1: 3, 2: 4, 3: 6, 4: 3}


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """The reference file's ``state_dict`` (under ``"model"`` when the file
    holds more) as numpy arrays."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("model", blob) if isinstance(blob, dict) else blob
    return {k: v.detach().numpy() for k, v in sd.items()}


def _set(tree: dict, path: str, value: np.ndarray) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    if parts[-1] in node:
        raise KeyError(f"two reference keys map to {path}")
    node[parts[-1]] = value


def _linear(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def _conv(w: np.ndarray) -> np.ndarray:
    # torch (O, I, kh, kw) -> flax (kh, kw, I, O)
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _conv1x1_to_dense(w: np.ndarray) -> np.ndarray:
    # torch (O, I, 1, 1) or Conv1d (O, I, 1) -> dense (I, O)
    return np.ascontiguousarray(w.reshape(w.shape[0], w.shape[1]).T)


def _leaf(name: str) -> str:
    return "kernel" if name == "weight" else "bias"


def _weight_kind(name: str, kind: str) -> str:
    return kind if name == "weight" else "raw"


def _map_resnet(key: str) -> Tuple[str, str]:
    """encoder.model.* -> encoder/*: (path, kind)."""
    k = key[len("encoder.model."):]
    if re.match(r"conv1\.weight$", k):
        return "encoder/stem/conv/kernel", "conv"
    m = re.match(r"bn1\.(\w+)$", k)
    if m:
        return f"encoder/stem/bn/{m.group(1)}", "bn"
    m = re.match(r"layer(\d)\.(\d+)\.(conv1|conv2|bn1|bn2)\.(\w+)$", k)
    if m and int(m.group(2)) < RESNET_LAYER_BLOCKS.get(int(m.group(1)), 0):
        stage, block, sub, leaf = m.groups()
        cb = "cb1" if sub in ("conv1", "bn1") else "cb2"
        mod = "conv" if sub.startswith("conv") else "bn"
        name = "kernel" if (mod == "conv" and leaf == "weight") else leaf
        return f"encoder/layer{stage}_{block}/{cb}/{mod}/{name}", mod
    m = re.match(r"layer(\d)\.(\d+)\.downsample\.(0|1)\.(\w+)$", k)
    if m and int(m.group(2)) < RESNET_LAYER_BLOCKS.get(int(m.group(1)), 0):
        stage, block, idx, leaf = m.groups()
        if idx == "0":
            return f"encoder/layer{stage}_{block}/downsample/conv/kernel", "conv"
        return f"encoder/layer{stage}_{block}/downsample/bn/{leaf}", "bn"
    raise KeyError(f"unmapped resnet key: {key}")


def _map_encoder4d(rest: str, prefix: str) -> Tuple[str, str]:
    """conv4d.I.0.{query,supp}_conv.{weight,bias} / conv4d.I.1.{weight,bias}."""
    m = re.match(r"conv4d\.(\d+)\.0\.(query_conv|supp_conv)\.(weight|bias)$", rest)
    if m:
        i, conv, leaf = m.groups()
        return f"{prefix}/conv4d_{i}/{conv}/{_leaf(leaf)}", _weight_kind(leaf, "conv")
    m = re.match(r"conv4d\.(\d+)\.1\.(weight|bias)$", rest)
    if m:
        i, leaf = m.groups()
        return f"{prefix}/gn_{i}/{'scale' if leaf == 'weight' else 'bias'}", "raw"
    raise KeyError(f"unmapped Encoder4D key: {prefix}: {rest}")


def _map_token_mlp(rest: str, prefix: str) -> Tuple[str, str]:
    """Sequential(Linear, DWConv, GELU, Linear): 0 -> fc1, 1.dwconv, 3 -> fc2."""
    m = re.match(r"(0|3)\.(weight|bias)$", rest)
    if m:
        fc = "fc1" if m.group(1) == "0" else "fc2"
        return f"{prefix}/{fc}/Dense_0/{_leaf(m.group(2))}", _weight_kind(m.group(2), "linear")
    m = re.match(r"1\.dwconv\.(weight|bias)$", rest)
    if m:
        return f"{prefix}/dwconv/{_leaf(m.group(1))}", _weight_kind(m.group(1), "conv")
    raise KeyError(f"unmapped token-MLP key: {prefix}: {rest}")


def _map_layernorm(rest: str, prefix: str) -> Tuple[str, str]:
    leaf = rest.split(".")[-1]
    return f"{prefix}/{'scale' if leaf == 'weight' else 'bias'}", "raw"


def _map_ufclayer(rest: str, prefix: str) -> Tuple[str, str]:
    for lin in ("q_proj", "k_proj", "v_proj", "v_cross"):
        m = re.match(rf"{lin}\.(weight|bias)$", rest)
        if m:
            return f"{prefix}/{lin}/Dense_0/{_leaf(m.group(1))}", _weight_kind(m.group(1), "linear")
    for enc in ("v_proj_corr", "mlp_corr", "mlp_refine_corr", "mlp_refine_corr2", "feat_to_corr1",
                "feat_to_corr2"):
        if rest.startswith(enc + "."):
            return _map_encoder4d(rest[len(enc) + 1:], f"{prefix}/{enc}")
    for mlp in ("mlp", "mlp_cross"):
        if rest.startswith(mlp + "."):
            return _map_token_mlp(rest[len(mlp) + 1:], f"{prefix}/{mlp}")
    for ln in ("norm1", "norm2", "norm_cross1", "norm_cross2"):
        if rest.startswith(ln + "."):
            return _map_layernorm(rest, f"{prefix}/{ln}")
    if rest == "pos_embed":
        return f"{prefix}/pos_embed", "raw"
    raise KeyError(f"unmapped UFCLayer key: {prefix}: {rest}")


def _map_mlpseq(rest: str, prefix: str, torch_indices) -> Tuple[str, str]:
    """nn.Sequential of Linears at ``torch_indices`` -> fc0/fc1/fc2."""
    m = re.match(r"(\d+)\.(weight|bias)$", rest)
    if not m or int(m.group(1)) not in torch_indices:
        raise KeyError(f"unmapped {prefix} key: {rest}")
    idx = torch_indices.index(int(m.group(1)))
    return f"{prefix}/fc{idx}/Dense_0/{_leaf(m.group(2))}", _weight_kind(m.group(2), "linear")


def _map_ufc(key: str) -> Tuple[str, str]:
    rest = key[len("feature_cost_aggregation."):]
    m = re.match(r"proj_feat\.(\d)\.0\.(weight|bias)$", rest)
    if m:
        i, leaf = m.groups()
        return (f"feature_cost_aggregation/proj_feat_{i}/Dense_0/{_leaf(leaf)}",
                _weight_kind(leaf, "linear"))
    m = re.match(r"embedding\.(\d+)\.(.*)$", rest)
    if m:
        return _map_encoder4d(m.group(2), f"feature_cost_aggregation/embedding_{m.group(1)}")
    m = re.match(r"layers\.(\d+)\.(\d+)\.(.*)$", rest)
    if m:
        return _map_ufclayer(m.group(3), f"feature_cost_aggregation/layers_{m.group(1)}_{m.group(2)}")
    raise KeyError(f"unmapped UFC key: {key}")


def _map_cross_attention(key: str) -> Tuple[str, str]:
    rest = key[len("cross_attention."):]
    m = re.match(r"cross_attn\.proj_fundamental\.(weight|bias)$", rest)
    if m:
        return (f"cross_attention/cross_attn/proj_fundamental/Dense_0/{_leaf(m.group(1))}",
                _weight_kind(m.group(1), "linear"))
    m = re.match(r"mlp\.(fc1|fc2)\.(weight|bias)$", rest)
    if m:
        return f"cross_attention/mlp/{m.group(1)}/Dense_0/{_leaf(m.group(2))}", _weight_kind(m.group(2), "linear")
    m = re.match(r"(norm1|norm2|norm)\.(weight|bias)$", rest)
    if m:
        return _map_layernorm(rest, f"cross_attention/{m.group(1)}")
    raise KeyError(f"unmapped cross_attention key: {key}")


def _map_phi(key: str) -> Tuple[str, str]:
    rest = key[len("phi."):]
    for pattern, fmt in ((r"(lin_in|lin_out)\.(weight|bias)$", "phi/{0}/Dense_0/{1}"),
                         (r"lin_z\.(\d)\.(weight|bias)$", "phi/lin_z_{0}/Dense_0/{1}"),
                         (r"blocks\.(\d)\.(fc_0|fc_1)\.(weight|bias)$", "phi/block_{0}/{1}/Dense_0/{2}")):
        m = re.match(pattern, rest)
        if m:
            *names, leaf = m.groups()
            return fmt.format(*names, _leaf(leaf)), _weight_kind(leaf, "linear")
    raise KeyError(f"unmapped phi key: {key}")


def _map_key(key: str) -> Tuple[str, str]:
    if key.startswith("encoder.model."):
        return _map_resnet(key)
    if key.startswith("conv_map."):
        leaf = key.split(".")[-1]
        return f"conv_map/{_leaf(leaf)}", _weight_kind(leaf, "conv")
    if key.startswith("feature_cost_aggregation."):
        return _map_ufc(key)
    if key.startswith("cross_attention."):
        return _map_cross_attention(key)
    for head, indices in (("pose_regressor", [0, 2, 4]), ("rotation_regressor", [1, 3, 5]),
                          ("translation_regressor", [1, 3, 5])):
        if key.startswith(head + "."):
            return _map_mlpseq(key[len(head) + 1:], head, indices)
    if key.startswith("phi."):
        return _map_phi(key)
    # 1x1 conv heads (query_encode_latent, latent_value, key_map, ...)
    m = re.match(r"^(\w+)\.(weight|bias)$", key)
    if not m:
        raise KeyError(f"unmapped key: {key}")
    return f"{m.group(1)}/Dense_0/{_leaf(m.group(2))}", _weight_kind(m.group(2), "conv1x1")


_LAYOUT = {"linear": _linear, "conv": _conv, "conv1x1": _conv1x1_to_dense}


def convert_state_dict(sd: Mapping[str, np.ndarray]) -> Tuple[dict, dict]:
    """Reference ``state_dict`` -> (params, batch_stats), nested dicts of
    numpy arrays in the flax layout."""
    params: dict = {}
    batch_stats: dict = {}
    for key, val in sd.items():
        if any(re.search(p, key) for p in SKIP_PATTERNS):
            continue
        path, kind = _map_key(key)
        val = np.asarray(val)
        if kind in _LAYOUT:
            val = _LAYOUT[kind](val)
        elif kind == "bn":
            head, leaf = path.rsplit("/", 1)
            if leaf in ("running_mean", "running_var"):
                _set(batch_stats, f"{head}/{leaf.split('_')[1]}", val)
                continue
            if leaf == "weight":
                path = f"{head}/scale"
        _set(params, path, val)
    return params, batch_stats


def import_reference(path: str, cfg=None, image_size: int = 256) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` -> the port's ``state_dict`` for
    ``CoPoNeRF(cfg, image_size)`` (default ``ModelConfig()``), ready for
    ``load_state_dict(strict=True)``.  Raises ``KeyError`` on a key that
    lands on no parameter or buffer of that module and on a parameter or
    buffer no key covers, ``ValueError`` on a shape that differs."""
    from coponerf_tpu_torch.config import ModelConfig
    from coponerf_tpu_torch.models import CoPoNeRF

    params, batch_stats = convert_state_dict(load_torch_checkpoint(path))
    sd = convert({"params": params, "batch_stats": batch_stats})
    with torch.device("meta"):
        want = CoPoNeRF(cfg or ModelConfig(), image_size=image_size).state_dict()
    extra = sorted(set(sd) - set(want))
    missing = sorted(set(want) - set(sd))
    if extra or missing:
        raise KeyError(f"{path}: keys outside the port's module {extra[:8]}, port keys not covered {missing[:8]} "
                       f"({len(extra)} and {len(missing)})")
    bad = [(k, tuple(v.shape), tuple(want[k].shape)) for k, v in sd.items() if v.shape != want[k].shape]
    if bad:
        raise ValueError(f"{path}: shapes differ from the port's module (key, file, module): {bad[:8]}")
    return sd

