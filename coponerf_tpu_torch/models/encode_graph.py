"""CUDA graphs of the inference encode.

An encode at 256^2 is about 2,900 small kernels.  Issued one by one from
Python they keep the card idle most of the encode, so an inference encode
(``train=False``, gradients off, CUDA inputs) replays CUDA graphs instead:
``EncodeGraphs`` captures ``CoPoNeRF.encode``'s three stages (backbone with
the input normalisation, UFC, pose with the cycle mask, the flow upsampling
and the render's tables) once per input shape, as three graphs that share
one memory pool, and replays each under its stage's span.  The kernels and
their inputs are those of the eager encode, so the outputs are its bits.

Each call copies the context rgb and intrinsics into the graphs' static
inputs and returns a ``SceneState`` of clones of the static outputs: a
state kept across later encodes (a camera path's, a caller's) stays as it
was.  The graphs read the parameters and buffers through the pointers
they had at capture: in-place updates (Adam's, BatchNorm's running
statistics) need nothing, and a call that finds any storage moved
(``model.to``, an assigning ``load_state_dict``) drops every graph and
captures anew.  A model with forward hooks runs eagerly, since a replay
would not call them.  The kernel wrappers' ``launches`` counters gain on a
replay what they gained in its capture.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, List, Tuple

import torch
from torch.nn.modules import module as nn_module

from coponerf_tpu_torch import trace

STAGES = ("encode.backbone", "encode.ufc", "encode.pose")
MAX_SHAPES = 4      # input shapes whose graphs are kept, the least recently used dropped first


def _observe(model: torch.nn.Module) -> Tuple[Tuple[int, ...], bool]:
    """(the data pointers of every parameter and buffer, whether a forward
    hook is set on the model, on any of its modules or globally)."""
    ptrs: List[int] = []
    hooked = bool(nn_module._global_forward_hooks or nn_module._global_forward_pre_hooks)
    stack = [model]      # a walk of its own: ``modules()`` takes several times as long
    while stack:
        m = stack.pop()
        if m is None:
            continue
        if m._forward_hooks or m._forward_pre_hooks:
            hooked = True
        if m._parameters:
            ptrs += [t.data_ptr() for t in m._parameters.values() if t is not None]
        if m._buffers:
            ptrs += [t.data_ptr() for t in m._buffers.values() if t is not None]
        if m._modules:
            stack += m._modules.values()
    return tuple(ptrs), hooked


def _launches() -> Tuple[int, ...]:
    return tuple(f.launches for f in trace._launch_fns())


class _Captured:
    """One input shape's graphs, their static inputs and outputs."""

    def __init__(self, model, rgb: torch.Tensor, intr: torch.Tensor):
        self.rgb, self.intr = rgb.clone(), intr.clone()
        dev, V = rgb.device, rgb.shape[1]
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            # one eager encode first: it fills the constants' caches and
            # settles cuDNN's and cuBLAS's choices and workspaces
            z_feats, z_conv = model._encode_backbone(self.rgb, False)
            ufc = model.feature_cost_aggregation(z_feats, V)
            model._encode_pose(*ufc, z_conv, self.intr, self.rgb.shape, False)
            del z_feats, z_conv, ufc
        torch.cuda.synchronize(dev)
        pool = torch.cuda.graph_pool_handle()
        self.graphs = [torch.cuda.CUDAGraph() for _ in STAGES]
        self.launch_deltas = []

        def capture(graph, fn):
            # a capture launches nothing: its wrapper calls count on each replay instead.
            # Not ``torch.cuda.graph``: it empties the allocator's cache before each
            # capture, which the render after it then fills again
            before = _launches()
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    out = fn()
                finally:
                    graph.capture_end()
            deltas = tuple(b - a for a, b in zip(before, _launches()))
            for f, n in zip(trace._launch_fns(), deltas):
                f.launches -= n
            self.launch_deltas.append(deltas)
            return out

        # the stages' outputs stay referenced: the next stage's graph reads them
        self.backbone = capture(self.graphs[0], lambda: model._encode_backbone(self.rgb, False))
        self.ufc = capture(self.graphs[1], lambda: model.feature_cost_aggregation(self.backbone[0], V))
        self.state = capture(self.graphs[2], lambda: model._encode_pose(
            *self.ufc, self.backbone[1], self.intr, self.rgb.shape, False))
        torch.cuda.current_stream(dev).wait_stream(stream)

    def replay(self, rgb: torch.Tensor, intr: torch.Tensor):
        self.rgb.copy_(rgb)
        self.intr.copy_(intr)
        fns = trace._launch_fns()
        for name, graph, deltas in zip(STAGES, self.graphs, self.launch_deltas):
            with trace.span(name):
                graph.replay()
            for f, n in zip(fns, deltas):
                f.launches += n
        trace.count("encode_graph_replays")
        return self.state.map(torch.Tensor.clone)


class EncodeGraphs:
    """A model's captured encodes, by input shape, dtype and device.  A copy
    of the model (``copy.deepcopy``, pickling) starts with none."""

    def __init__(self):
        self._captured: "OrderedDict[Any, _Captured]" = OrderedDict()
        self._storage: Tuple[int, ...] = ()

    def __reduce__(self):
        return EncodeGraphs, ()

    def __call__(self, model, rgb: torch.Tensor, intr: torch.Tensor):
        storage, hooked = _observe(model)
        if storage != self._storage:
            self._captured.clear()
            self._storage = storage
        if hooked:
            return model._encode_eager(rgb, intr)
        key = (tuple(rgb.shape), rgb.dtype, rgb.device, tuple(intr.shape), intr.dtype, intr.device,
               torch.is_inference_mode_enabled())
        cap = self._captured.get(key)
        if cap is None:
            if len(self._captured) >= MAX_SHAPES:
                self._captured.popitem(last=False)
            cap = self._captured[key] = _Captured(model, rgb, intr)
        else:
            self._captured.move_to_end(key)
        return cap.replay(rgb, intr)
