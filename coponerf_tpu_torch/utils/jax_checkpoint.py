"""The JAX package's checkpoints (``.npz``), read into the port and written
from it, with numpy and torch alone.

Counterpart of ``coponerf_tpu/training/checkpoint.py:37-97`` (``save``,
``load``, ``restore_into``).  A file holds

    params/<flax path>, batch_stats/<flax path>   the model's variables
    __step__                                      train steps taken
    __opt__/%05d                                  every leaf of the optax state

The optax state of ``coponerf_tpu/training/trainer.py:39-124`` flattens to
``ApplyIfFiniteState(notfinite_count, last_finite, total_notfinite,
(EmptyState, (ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))))``:

    0 notfinite_count (int32)   1 last_finite (bool)   2 total_notfinite (int32)
    3 Adam's count (int32)      then mu's n leaves, nu's n leaves, the schedule's count (int32)

``mu`` and ``nu`` are trees like ``params``, so their leaves come in the
sorted order of the flax paths: 2n + 5 leaves for n parameters.  With
``flat_optimizer`` (``optax.flatten``) ``mu`` and ``nu`` are one f32 vector
each, the sorted leaves raveled in C order and concatenated: 7 leaves.
With ``ufc_scan`` the UFC's ``layers_{s}_{i}/X`` are ``layers_{s}/layer/X``
with a leading stacked axis (``coponerf_tpu/models/ufc.py:487-515``),
which changes the weights' keys and the moments' order alike.

The counters map onto ``training.trainer.TrainState``: ``__step__`` is
``step``; Adam's count (equal to the schedule's: both move only on an
applied update) is ``updates`` and torch Adam's per-parameter ``step``;
``notfinite_count`` and ``total_notfinite`` keep their names.
``last_finite`` is ``notfinite_count == 0`` in a state the JAX package
writes, and the update reads it nowhere, so the port keeps no copy of it.

``restore_into`` checks the whole file against the port's state before it
changes anything: a leaf count other than 2n + 5 or 7, a key or shape the
model at its configuration and image size lacks or has otherwise, a leaf
left over or missing, or Adam's count unequal to the schedule's raise
``ValueError`` and leave the state as it was (the JAX package's
``restore_into`` drops an optimizer state whose leaf count differs).  A
file without ``__opt__`` leaves restores the weights and ``step`` and
starts Adam fresh, as the JAX package does.  ``save`` writes the JAX
package's default layout (loop UFC, per-leaf optimizer state), which its
own ``restore_into`` takes.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from coponerf_tpu_torch.utils.convert import convert, to_flax

Path = Tuple[str, ...]

UFC = "feature_cost_aggregation"
OPT_PREFIX = "__opt__/"
N_FLAT_LEAVES = 7
_STACKED = re.compile(r"layers_\d+")


def _unflatten(flat: Mapping[Path, np.ndarray]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return tree


def _flatten(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    out: Dict[Path, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _is_stacked(key: str, node) -> bool:
    return bool(_STACKED.fullmatch(key)) and isinstance(node, Mapping) and "layer" in node


def unstack_ufc_params(ufc_params: Mapping) -> dict:
    """Scan-layout UFC subtree -> loop layout: ``layers_{s}/layer/X`` with
    a leading axis of n -> ``layers_{s}_{i}/X`` for i < n (other keys pass
    through).  The numpy copy of ``coponerf_tpu/models/ufc.py:506``, each
    stage's layer count read from its stacked extent."""
    out = {k: v for k, v in ufc_params.items() if not _is_stacked(k, v)}
    for key in (k for k in ufc_params if k not in out):
        stacked = _flatten(ufc_params[key]["layer"])
        for i in range(next(iter(stacked.values())).shape[0]):
            out[f"{key}_{i}"] = _unflatten({p: v[i] for p, v in stacked.items()})
    return out


def _loop_layout(tree: Mapping) -> dict:
    """A params-like tree (``params``, ``batch_stats``, or a moment tree
    of the same shape) in the loop layout."""
    if UFC in tree and any(_is_stacked(k, v) for k, v in tree[UFC].items()):
        return {**tree, UFC: unstack_ufc_params(tree[UFC])}
    return dict(tree)


def load(path: str, optimizer: bool = True):
    """(variables {(collection, *flax path): array}, the optimizer leaves
    in order or None, ``__step__``); the port's copy of the JAX ``load``.
    ``optimizer=False`` leaves the optimizer leaves unread."""
    with np.load(path) as data:
        files = data.files
        opt_keys = sorted(k for k in files if k.startswith(OPT_PREFIX))
        if opt_keys != [f"{OPT_PREFIX}{i:05d}" for i in range(len(opt_keys))]:
            raise ValueError(f"{path}: the optimizer leaves are not numbered 0..{len(opt_keys) - 1}")
        variables = {tuple(k.split("/")): data[k] for k in files
                     if k != "__step__" and not k.startswith(OPT_PREFIX)}
        opt = [data[k] for k in opt_keys] if (opt_keys and optimizer) else None
        step = int(data["__step__"]) if "__step__" in files else 0
    bad = sorted("/".join(p) for p in variables if p[0] not in ("params", "batch_stats"))
    if bad:
        raise ValueError(f"{path}: keys outside params/ and batch_stats/: {bad[:8]}")
    return variables, opt, step


def _check_keys(path: str, what: str, got: Mapping[str, torch.Tensor], want: Mapping[str, torch.Tensor]) -> None:
    extra = sorted(set(got) - set(want))
    missing = sorted(set(want) - set(got))
    if extra or missing:
        raise ValueError(f"{path}: {what}: {len(extra)} leaves left over {extra[:8]}, {len(missing)} of the "
                         f"port's model missing {missing[:8]}")
    bad = [(k, tuple(v.shape), tuple(want[k].shape)) for k, v in got.items() if v.shape != want[k].shape]
    if bad:
        raise ValueError(f"{path}: {what}: shapes differ from the port's model at its configuration and "
                         f"image size (key, file, model): {bad[:8]}")


def _weights(path: str, variables: Mapping[Path, np.ndarray], model) -> Dict[str, torch.Tensor]:
    """The file's variables as the model's ``state_dict``, checked against it."""
    tree = _unflatten(variables)
    sd = convert({c: _loop_layout(tree.get(c, {})) for c in ("params", "batch_stats")})
    _check_keys(path, "weights", sd, model.state_dict())
    return sd


def _moments(path: str, variables: Mapping[Path, np.ndarray], opt: List[np.ndarray], model):
    """(mu, nu as {parameter name: tensor in the port's layout}, Adam's
    count, notfinite_count, total_notfinite) from the optimizer leaves."""
    leaves = sorted(p[1:] for p in variables if p[0] == "params")     # tree_leaves order of params
    n = len(leaves)
    shapes = [variables[("params",) + p].shape for p in leaves]
    if len(opt) == 2 * n + 5:
        mu, nu = opt[4:4 + n], opt[4 + n:4 + 2 * n]
        bad = [("/".join(p), m.shape, s)
               for p, m, s in zip(leaves + leaves, mu + nu, shapes + shapes) if m.shape != s]
        if bad:
            raise ValueError(f"{path}: moments whose shape is not their parameter's (leaf, moment, parameter): "
                             f"{bad[:8]}")
    elif len(opt) == N_FLAT_LEAVES:
        size = sum(int(np.prod(s)) for s in shapes)
        if opt[4].shape != (size,) or opt[5].shape != (size,):
            raise ValueError(f"{path}: flat moments of shapes {opt[4].shape} and {opt[5].shape}; the "
                             f"parameters hold {size} values")
        cuts = np.cumsum([0] + [int(np.prod(s)) for s in shapes])
        mu, nu = ([v[a:b].reshape(s) for a, b, s in zip(cuts[:-1], cuts[1:], shapes)] for v in opt[4:6])
    else:
        raise ValueError(f"{path}: {len(opt)} optimizer leaves; the file's {n} parameter leaves need "
                         f"{2 * n + 5} (per-leaf Adam state) or {N_FLAT_LEAVES} (flat_optimizer)")
    counters = [opt[i] for i in (0, 2, 3, len(opt) - 1)]
    if any(np.shape(c) != () or not np.issubdtype(np.asarray(c).dtype, np.integer) for c in counters):
        raise ValueError(f"{path}: the counters (leaves 0, 2, 3, {len(opt) - 1}) are not integer scalars: "
                         f"{[(np.asarray(c).dtype, np.shape(c)) for c in counters]}")
    notfinite, total, count, sched = (int(c) for c in counters)
    if count != sched:
        raise ValueError(f"{path}: Adam's count {count} and the schedule's count {sched} disagree")
    want = dict(model.named_parameters())
    out = []
    for name, vals in (("mu", mu), ("nu", nu)):
        tree = _loop_layout(_unflatten(dict(zip(leaves, vals))))
        moments = convert({"params": tree})
        _check_keys(path, f"Adam's {name}", moments, want)
        out.append(moments)
    return out[0], out[1], count, notfinite, total


def _named_indices(state) -> Dict[str, int]:
    """{parameter name: its index in the optimizer's ``state_dict``}."""
    index = {}
    for group_sd, group in zip(state.optimizer.state_dict()["param_groups"], state.optimizer.param_groups):
        for i, p in zip(group_sd["params"], group["params"]):
            index[id(p)] = i
    return {k: index[id(p)] for k, p in state.model.named_parameters()}


def load_weights(model, path: str):
    """Load a JAX ``.npz``'s weights and BatchNorm statistics into ``model``
    (strict, checked before anything is loaded) and return it."""
    variables, _, _ = load(path, optimizer=False)
    model.load_state_dict(_weights(path, variables, model), strict=True)
    return model


def restore_into(state, path: str):
    """Restore a JAX ``.npz`` into a ``training.trainer.TrainState`` in
    place: weights, BatchNorm statistics, Adam's moments and step, and the
    counters.  Raises ``ValueError`` before changing anything where the
    file does not fit the state."""
    variables, opt, step = load(path)
    sd = _weights(path, variables, state.model)
    if opt is None:
        state.model.load_state_dict(sd, strict=True)
        state.optimizer.state.clear()
        state.step, state.updates, state.notfinite_count, state.total_notfinite = step, 0, 0, 0
        print(f"{path} holds no optimizer state: weights and step {step} restored, Adam starts fresh")
        return state
    mu, nu, count, notfinite, total = _moments(path, variables, opt, state.model)
    opt_sd = state.optimizer.state_dict()
    opt_sd["state"] = {i: {"step": torch.tensor(float(count)), "exp_avg": mu[k], "exp_avg_sq": nu[k]}
                       for k, i in _named_indices(state).items()}
    state.model.load_state_dict(sd, strict=True)
    state.optimizer.load_state_dict(opt_sd)
    state.step, state.updates, state.notfinite_count, state.total_notfinite = step, count, notfinite, total
    return state


def save(ckpt_dir: str, state, step: int, name: Optional[str] = None) -> str:
    """Write ``state`` to ``<ckpt_dir>/<name or model_step_XXXXXXXX>.npz``
    in the JAX package's default layout (loop UFC, per-leaf optimizer
    state; int32 counters, bool ``last_finite``).  ``step`` names the
    file; ``__step__`` is ``state.step``.  A parameter without Adam state
    (no update has reached it) writes zero moments; one whose Adam step is
    not ``state.updates`` raises, since the file keeps one count for all."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, (name or f"model_step_{step:08d}") + ".npz")
    flat: Dict[str, np.ndarray] = {}
    for key, t in state.model.state_dict().items():
        fpath, arr = to_flax(key, t.detach().cpu().numpy())
        flat["/".join(fpath)] = arr
    flat["__step__"] = np.asarray(state.step)
    moments = {}
    for key, p in state.model.named_parameters():
        st = state.optimizer.state.get(p, {})
        if st and int(st["step"]) != state.updates:
            raise ValueError(f"{key}: Adam step {int(st['step'])}, but {state.updates} updates applied")
        fpath, mu = to_flax(key, st["exp_avg"].cpu().numpy() if st else np.zeros(tuple(p.shape), np.float32))
        _, nu = to_flax(key, st["exp_avg_sq"].cpu().numpy() if st else np.zeros(tuple(p.shape), np.float32))
        moments[fpath] = (mu, nu)
    order = sorted(moments)                 # tree_leaves order of params
    count = np.asarray(state.updates, np.int32)
    leaves = [np.asarray(state.notfinite_count, np.int32), np.asarray(state.notfinite_count == 0),
              np.asarray(state.total_notfinite, np.int32), count,
              *(moments[p][0] for p in order), *(moments[p][1] for p in order), count]
    for i, leaf in enumerate(leaves):
        flat[f"{OPT_PREFIX}{i:05d}"] = leaf
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    return path
