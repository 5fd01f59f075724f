"""A test-side inverse of the JAX package's reference key map
(``coponerf_tpu/utils/torch_import.py``): flax variables, or a port
``state_dict``, -> a state dict keyed as the reference PyTorch
``CoPoNeRF``'s (torchvision ResNet-34 names, Conv1d heads, Sequential
indices), with one key of each kind the import skips.  The JAX package's
``convert_state_dict`` takes it back to the variables bit for bit
(``tests/test_torch_import_pth.py``)."""

import re

import numpy as np
import torch

from coponerf_tpu_torch.utils.convert import flax_path

# keys the import skips (SKIP_PATTERNS), one of each kind
_SKIPPED = {
    "corr_embed.weight": (4, 4),
    "latent_avg_1": (8,),
    "cross_attention.cross_attn.qkv.weight": (6, 2),
    "encoder.model.layer1.0.bn1.num_batches_tracked": (),
    "encoder.model.fc.weight": (10, 512),
    "encoder.model.fc.bias": (10,),
}

# (flax path regex, reference key template, layout) in the order tried
_RULES = [
    (r"encoder/stem/conv/kernel", "encoder.model.conv1.weight", "conv"),
    (r"encoder/stem/bn/(scale|bias|mean|var)", "encoder.model.bn1.{bn0}", "raw"),
    (r"encoder/layer(\d)_(\d+)/cb([12])/conv/kernel", "encoder.model.layer{0}.{1}.conv{2}.weight", "conv"),
    (r"encoder/layer(\d)_(\d+)/cb([12])/bn/(scale|bias|mean|var)", "encoder.model.layer{0}.{1}.bn{2}.{bn3}", "raw"),
    (r"encoder/layer(\d)_(\d+)/downsample/conv/kernel", "encoder.model.layer{0}.{1}.downsample.0.weight", "conv"),
    (r"encoder/layer(\d)_(\d+)/downsample/bn/(scale|bias|mean|var)",
     "encoder.model.layer{0}.{1}.downsample.1.{bn2}", "raw"),
    (r"conv_map/(kernel|bias)", "conv_map.{w0}", "conv"),
    (r"feature_cost_aggregation/proj_feat_(\d)/Dense_0/(kernel|bias)",
     "feature_cost_aggregation.proj_feat.{0}.0.{w1}", "linear"),
    (r"(.*)/conv4d_(\d+)/(query_conv|supp_conv)/(kernel|bias)", "{ufc0}.conv4d.{1}.0.{2}.{w3}", "conv"),
    (r"(.*)/gn_(\d+)/(scale|bias)", "{ufc0}.conv4d.{1}.1.{w2}", "raw"),
    (r"feature_cost_aggregation/layers_(\d+)_(\d+)/(mlp|mlp_cross)/fc1/Dense_0/(kernel|bias)",
     "feature_cost_aggregation.layers.{0}.{1}.{2}.0.{w3}", "linear"),
    (r"feature_cost_aggregation/layers_(\d+)_(\d+)/(mlp|mlp_cross)/fc2/Dense_0/(kernel|bias)",
     "feature_cost_aggregation.layers.{0}.{1}.{2}.3.{w3}", "linear"),
    (r"feature_cost_aggregation/layers_(\d+)_(\d+)/(mlp|mlp_cross)/dwconv/(kernel|bias)",
     "feature_cost_aggregation.layers.{0}.{1}.{2}.1.dwconv.{w3}", "conv"),
    (r"feature_cost_aggregation/layers_(\d+)_(\d+)/(\w+)/Dense_0/(kernel|bias)",
     "feature_cost_aggregation.layers.{0}.{1}.{2}.{w3}", "linear"),
    (r"feature_cost_aggregation/layers_(\d+)_(\d+)/(norm\w*)/(scale|bias)",
     "feature_cost_aggregation.layers.{0}.{1}.{2}.{w3}", "raw"),
    (r"feature_cost_aggregation/layers_(\d+)_(\d+)/pos_embed", "feature_cost_aggregation.layers.{0}.{1}.pos_embed",
     "raw"),
    (r"cross_attention/cross_attn/proj_fundamental/Dense_0/(kernel|bias)",
     "cross_attention.cross_attn.proj_fundamental.{w0}", "linear"),
    (r"cross_attention/mlp/(fc1|fc2)/Dense_0/(kernel|bias)", "cross_attention.mlp.{0}.{w1}", "linear"),
    (r"cross_attention/(norm1|norm2|norm)/(scale|bias)", "cross_attention.{0}.{w1}", "raw"),
    (r"pose_regressor/fc(\d)/Dense_0/(kernel|bias)", "pose_regressor.{seq0}.{w1}", "linear"),
    (r"(rotation|translation)_regressor/fc(\d)/Dense_0/(kernel|bias)", "{0}_regressor.{seqh1}.{w2}", "linear"),
    (r"phi/(lin_in|lin_out)/Dense_0/(kernel|bias)", "phi.{0}.{w1}", "linear"),
    (r"phi/lin_z_(\d)/Dense_0/(kernel|bias)", "phi.lin_z.{0}.{w1}", "linear"),
    (r"phi/block_(\d)/(fc_0|fc_1)/Dense_0/(kernel|bias)", "phi.blocks.{0}.{1}.{w2}", "linear"),
    (r"(\w+)/Dense_0/(kernel|bias)", "{0}.{w1}", "conv1d"),
]


def _reference_key(path: str):
    """Flax path (no collection) -> (reference key, layout)."""
    for pattern, template, kind in _RULES:
        m = re.fullmatch(pattern, path)
        if not m:
            continue
        g = m.groups()
        fields = {}
        for i, v in enumerate(g):
            fields[f"w{i}"] = "weight" if v in ("kernel", "scale") else v
            fields[f"bn{i}"] = {"scale": "weight", "mean": "running_mean", "var": "running_var"}.get(v, v)
            small = v.isdigit() and int(v) < 3
            fields[f"seq{i}"] = str([0, 2, 4][int(v)]) if small else v
            fields[f"seqh{i}"] = str([1, 3, 5][int(v)]) if small else v
            ufc = re.sub(r"layers_(\d+)_(\d+)", r"layers.\1.\2", v).replace("embedding_", "embedding.")
            fields[f"ufc{i}"] = ufc.replace("/", ".")
        key = template.format(*g, **fields)
        return key, (kind if path.endswith("kernel") else "raw")
    raise KeyError(path)


def _to_reference_layout(kind: str, a: np.ndarray) -> np.ndarray:
    if kind == "linear":
        return a.T
    if kind == "conv":
        return a.transpose(3, 2, 0, 1)
    if kind == "conv1d":
        return a.T[..., None]       # Conv1d (O, I, 1)
    return a


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def reference_state_dict(variables) -> dict:
    """{"params": ..., "batch_stats": ...} nested dicts of arrays -> a state
    dict keyed as the reference's module."""
    sd = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _leaves(variables[coll]):
            key, kind = _reference_key("/".join(path))
            assert key not in sd, key
            sd[key] = torch.from_numpy(np.ascontiguousarray(_to_reference_layout(kind, leaf)))
    rng = np.random.RandomState(5)
    for key, shape in _SKIPPED.items():
        sd[key] = torch.tensor(7) if not shape else torch.from_numpy(rng.randn(*shape).astype(np.float32))
    return sd




def port_to_reference(port_sd) -> dict:
    """A port ``state_dict`` -> the reference-keyed state dict of the same
    weights (through the flax tree that ``utils/convert.py`` maps from)."""
    tree = {"params": {}, "batch_stats": {}}
    for k, v in port_sd.items():
        path, _ = flax_path(k, tuple(v.shape))
        a = v.detach().float().numpy()
        if path[-1] == "kernel":
            a = a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return reference_state_dict(tree)
