"""CoPoNeRF top module: ``encode`` once per stereo pair, ``render`` per ray
chunk, in inference (``train=False``) and training (``train=True``).

Counterpart of ``coponerf_tpu/models/coponerf.py``.  The same algebra and
the same token orders: ray-major tokens in the exact config and in
training, sample-major tokens (t = s*N + n) under ``fast_sampling`` in
inference; the W2/key/value folding, the split query embeds, coarse-to-fine
sampling with a joint softmax (inference only), the white overwrite and the
cycle/depth outputs.  Feature maps are NHWC and render tensors
(B*V, tokens, C).  Inference callers run under ``torch.no_grad()``.

Fast inference: K8a (``ops.bilinear_sample.multilevel_sample``) samples
all four latent levels of a sample set in one launch (each level bit for
bit what K1 gives), K2 (``ops.split_matmul``) runs W1 with the folded key
head, K3 (``ops.weighted_sum``) takes the attention-weighted sample sums.  Fast
training: K1 forward and K4 backward (``grid_sample_onehot``) on the
<=64^2 levels, the 256^2 conv level through ``convmap_sample_pair``, K2
forward with a plain-product backward.  The exact config samples with the
f32 gather (``grid_sample_tablegrad``, K4 backward) and runs W1 through K2.
With ``fused_argmax`` the UFC extracts both flows through K5
(``ops.soft_argmax``: its statistics kernel forward, its backward kernel in
training).

A fusion (fast bf16 inference only; default None) fuses more of the render:
``"attn_embed"`` computes each stage's round-1 and round-2 logits with K7
(``ops.attn_embed``) from K2's keys and the 16-wide local coordinates;
``"render_core"`` (single stage, repeat attention) hands both sample sets to
K6 (``ops.render_core``), which replaces K2, the keys, both attention rounds
and K3.  It is the model's: ``CoPoNeRF(cfg, image_size, fusion=...)`` picks
the attention core of every inference render of that model (training
renders run unfused); there is no per-call form.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from coponerf_tpu_torch import flow as flow_ops
from coponerf_tpu_torch import geometry as G
from coponerf_tpu_torch import trace
from coponerf_tpu_torch.config import ModelConfig
from coponerf_tpu_torch.models.cross_block import CrossBlock
from coponerf_tpu_torch.models.encode_graph import EncodeGraphs
from coponerf_tpu_torch.models.layers import ConvNHWC, Dense, MLPSeq
from coponerf_tpu_torch.models.lightfield import ResnetFC
from coponerf_tpu_torch.models.resnet import ResNet34Encoder
from coponerf_tpu_torch.models.ufc import UFC
from coponerf_tpu_torch.ops.attn_embed import round1_logits, round2_logits
from coponerf_tpu_torch.ops.bilinear_sample import grid_sample_onehot, grid_sample_tablegrad, multilevel_sample
from coponerf_tpu_torch.ops.convmap_sample import convmap_sample_pair
from coponerf_tpu_torch.ops.render_core import render_core
from coponerf_tpu_torch.ops.resize import resize_nchw
from coponerf_tpu_torch.ops.split_matmul import split_dense_relu
from coponerf_tpu_torch.ops.weighted_sum import weighted_sum_smaj

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

@dataclasses.dataclass
class SceneState:
    """Per-pair encoding, reused across ray chunks."""

    z: Tuple[torch.Tensor, ...]          # 4 NHWC latents (B*V, h, w, c)
    rel_pose: torch.Tensor               # (B, 4, 4) estimated ctx1 -> ctx2
    flows: Tuple[torch.Tensor, ...]      # (flow, flow_flip, mapping_fwd, mapping_bwd)
    mask_bwd: torch.Tensor               # (B, up, up) cyclic-consistency mask (bwd), f32
    kps_flow_bwd: torch.Tensor           # (B, 2, up, up) upsampled bwd flow for flow2kps
    # fast path: the bf16 cast of the full-resolution table, built once per
    # pair (None otherwise)
    z0_bf16: Optional[torch.Tensor] = None

    def map(self, fn) -> "SceneState":
        """The state with ``fn`` applied to each of its tensors."""
        def mv(x):
            return None if x is None else fn(x)

        return SceneState(
            z=tuple(mv(t) for t in self.z), rel_pose=mv(self.rel_pose),
            flows=tuple(mv(t) for t in self.flows), mask_bwd=mv(self.mask_bwd),
            kps_flow_bwd=mv(self.kps_flow_bwd), z0_bf16=mv(self.z0_bf16),
        )

    def to(self, device) -> "SceneState":
        return self.map(lambda t: t.to(device))


def is_full_resolution(z: torch.Tensor) -> bool:
    """Whether the NHWC table ``z`` is the full-resolution (``conv_map``)
    level, the one above 64^2: the fast render samples its encode-time bf16
    cast, training samples it by the gather and never one-hot."""
    return z.shape[1] * z.shape[2] > 4096


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ImageNet's mean and std and the pose's bottom row, on ``device`` in
    ``dtype``: copied once a key (each copy blocks the host, and a CUDA
    graph could not capture it), read and never written.  Outside
    inference mode, so that autograd may save them."""
    with torch.inference_mode(False):
        consts = tuple(torch.tensor(v, dtype=dtype, device=device)
                       for v in (IMAGENET_MEAN, IMAGENET_STD, [[0.0, 0.0, 0.0, 1.0]]))
    trace.count("host_syncs", 3)     # three blocking host-to-device copies
    return consts


def _normalize_rgb(rgb: torch.Tensor) -> torch.Tensor:
    mean, std, _ = _constants(rgb.device, rgb.dtype)
    return ((rgb + 1.0) / 2.0 - mean) / std


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _scrub(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def check_fusion(cfg: ModelConfig, fusion: Optional[str]) -> None:
    """Raise ``ValueError`` where an inference render of ``cfg`` cannot run
    ``fusion``."""
    if fusion is None:
        return
    if fusion not in _CORES:
        raise ValueError(f"unknown fusion {fusion!r}")
    if not cfg.fast_sampling or cfg.compute_dtype != "bfloat16":
        raise ValueError(f"fusion={fusion!r} runs in the fast bf16 inference render only "
                         "(fast_sampling, compute_dtype='bfloat16', train=False)")
    if fusion == "render_core" and ((cfg.coarse_samples > 0 and cfg.fine_samples > 0) or not cfg.repeat_attention):
        raise ValueError("fusion='render_core' needs one sampling stage and repeat_attention")


class _Chunk:
    """What the stages of one chunk's render read, made once a chunk: its
    geometry, tables, folded weights and split query embeds.  Tokens are
    sample-major (t = s*N + n) when ``smaj``, ray-major otherwise."""

    def __init__(self, m: "CoPoNeRF", batch, state: SceneState, val: bool, train: bool, core):
        cfg, ctx = m.cfg, batch["context"]
        self.B, self.V = B, V = ctx["rgb"].shape[:2]
        self.H, self.W = ctx["rgb"].shape[2:4]
        self.n_rays = batch["query"]["uv"].shape[2]
        self.smaj = cfg.fast_sampling and not train      # training is ray-major and single-stage
        self.cd = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        ctx_c2w, ctx_intr, rel_pose = ctx["cam2world"], ctx["intrinsics"], state.rel_pose
        self.query_cam2world, qc2w_flat, self.lf_coords, proj, inv_ctx = m._query_cams(batch, rel_pose, val)
        self.ray_dir = self.lf_coords[..., :3]
        self.ctx_flat_c2w = _eye(4, ctx_c2w).expand(B, V, 4, 4).reshape(B * V, 4, 4)
        self.valid_mask = proj["overlaps_image"].float()
        self.start = _scrub((proj["xy_min"] - 0.5) * 2.0)
        self.end = _scrub((proj["xy_max"] - 0.5) * 2.0)

        if self.smaj:
            # K8a samples every level of a sample set in one launch, bf16
            # tables and outputs (the consumers are the bf16 W1 parts); the
            # full-resolution table comes from the encode-time cast
            tables = [
                state.z0_bf16 if (state.z0_bf16 is not None and is_full_resolution(z))
                else z.to(torch.bfloat16)
                for z in state.z
            ]
        else:
            tables = list(state.z)
        # training: the 256^2 conv_map level is sampled through
        # convmap_sample_pair, whose backward goes straight to the conv kernel
        self.conv_rgb = None
        if train and cfg.convmap_direct_grad:
            tables = tables[:-1]
            self.conv_rgb = _normalize_rgb(ctx["rgb"].reshape(B * V, self.H, self.W, 3))
        self.tables = tables
        self.tables_s = tables if core.flip_secondary else [self.swap_views(z) for z in tables]

        self.ctx_flat_intr = ctx_intr.reshape(B * V, 4, 4)
        if val:
            ident = _eye(4, rel_pose).expand(B, 1, 4, 4)
            crel_v1 = torch.cat([ident, rel_pose[:, None]], dim=1)
            crel_v2 = torch.cat([G.pose_inverse_4x4(rel_pose)[:, None], ident], dim=1)
        else:
            crel_v1 = inv_ctx[:, 0:1] @ ctx_c2w
            crel_v2 = inv_ctx[:, 1:2] @ ctx_c2w
        intr_v1, intr_v2 = ctx_intr[:, 0], ctx_intr[:, 1]
        self.crel_diag = torch.cat([crel_v1[:, 0:1], crel_v2[:, 1:2]], dim=1)
        self.crel_other = torch.cat([crel_v2[:, 0:1], crel_v1[:, 1:2]], dim=1)
        self.intr_other = torch.stack([intr_v2, intr_v1], dim=1).reshape(B * V, 4, 4)

        self._fold(m)
        self.query_ray_orig = G.get_ray_origin(qc2w_flat)[:, None, None, :]
        if cfg.fast_sampling:
            self._split_embeds(m)

    def _fold(self, m: "CoPoNeRF") -> None:
        """W1 and the linear maps folded after it (see the JAX module for
        the algebra): per-sample work after W1 is one 832 -> 128 product,
        fused into K2."""
        self.w1_k, self.w1_b = m.query_encode_latent.kernel, m.query_encode_latent.bias
        half = m.cfg.latent_dim // 2
        w2_k, w2_b = m.query_encode_latent_2.kernel, m.query_encode_latent_2.bias
        km_k, km_b = m.key_map.kernel, m.key_map.bias
        lv_k, lv_b = m.latent_value.kernel, m.latent_value.bias
        self.fk_a = w2_k @ km_k[:half]
        self.fk_b = w2_k @ km_k[half:]
        self.fk_bias = w2_b @ (km_k[:half] + km_k[half:]) + km_b
        self.flv_a = w2_k @ lv_k[:half]
        self.flv_b = w2_k @ lv_k[half:]
        self.flv_bias = w2_b @ (lv_k[:half] + lv_k[half:]) + lv_b

    def _split_embeds(self, m: "CoPoNeRF") -> None:
        """The query embeds' rows that multiply per-sample inputs, and the
        per-ray rest of each product."""
        cd, ray_dir = self.cd, self.ray_dir
        ps_rows = torch.tensor([0, 1, 2, 9, 10, 11, 12], device=ray_dir.device)
        trace.count("host_syncs")    # a blocking host-to-device copy
        qe_k, qe_b = m.query_embed.kernel, m.query_embed.bias
        self.qe_ps, qe_rd, qe_qo = qe_k[ps_rows].to(cd), qe_k[6:9], qe_k[13:16]
        qro_row = self.query_ray_orig[:, :, 0, :]
        self.pre1_ray = (ray_dir @ qe_rd + qro_row @ qe_qo + qe_b).to(cd)
        if m.cfg.repeat_attention:
            qre_k, qre_b = m.query_repeat_embed.kernel, m.query_repeat_embed.bias
            ze_dim = qre_k.shape[0] - 16
            self.qre_z = qre_k[:ze_dim]
            self.qre_ps = qre_k[ze_dim + ps_rows].to(cd)
            qre_rd, qre_qo = qre_k[ze_dim + 6: ze_dim + 9], qre_k[ze_dim + 13:]
            self.pre2_ray = ray_dir @ qre_rd + qro_row @ qre_qo + qre_b

    def tg(self, S_: int) -> Tuple[int, int, int, int]:
        """A stage's token grid in token order."""
        return (self.B, self.V, S_, self.n_rays) if self.smaj else (self.B, self.V, self.n_rays, S_)

    def tokf(self, t: torch.Tensor, S_: int) -> torch.Tensor:
        """(B*V, N, S_, C) -> (B*V, T, C) in the active token order."""
        if self.smaj:
            t = t.transpose(1, 2)
        return t.reshape(t.shape[0], self.n_rays * S_, -1)

    def swap_views(self, z: torch.Tensor) -> torch.Tensor:
        return z.reshape(self.B, self.V, *z.shape[1:]).flip(1).reshape(z.shape)

    def add_perray(self, tok: torch.Tensor, per_ray: torch.Tensor, S_: int) -> torch.Tensor:
        """tok (B*V, T, C) + per-ray (B*V, N, C) broadcast in token order."""
        R = tok.shape[0]
        if self.smaj:
            t4, pr4 = tok.reshape(R, S_, self.n_rays, -1), per_ray[:, None]
        else:
            t4, pr4 = tok.reshape(R, self.n_rays, S_, -1), per_ray[:, :, None]
        return (t4 + pr4).reshape(tok.shape)

    def ray_major(self, dot: torch.Tensor) -> torch.Tensor:
        """(*tg) logits -> (B, V, N, S_)."""
        return dot.transpose(2, 3) if self.smaj else dot

    def norm_px(self, p: torch.Tensor) -> torch.Tensor:
        x = (p[..., 0] / (self.W - 1)) * 2 - 1
        y = (p[..., 1] / (self.H - 1)) * 2 - 1
        return torch.stack([x, y], dim=-1)

    def sample_coords(self, pixel_val: torch.Tensor, pt: torch.Tensor):
        """Per-sample camera ray directions and depth encoding."""
        cam_rays = G.get_ray_directions_cam(pixel_val, self.ctx_flat_intr, self.H, self.W)
        depth = torch.linalg.vector_norm(pt - self.query_ray_orig, dim=-1)[..., None]
        depth = torch.nan_to_num(depth, nan=1e6, posinf=1e6, neginf=1e6).detach()
        depth_encode = torch.cat(
            [torch.tanh(depth), torch.tanh(depth / 10.0), torch.tanh(depth / 100.0), torch.tanh(depth / 1000.0)],
            dim=-1,
        )
        return cam_rays, depth_encode

    def local_coords(self, cam_rays: torch.Tensor, depth_encode: torch.Tensor, S_: int) -> torch.Tensor:
        """The 16-wide local coordinates per token, in token order."""
        ray_dir_s = self.ray_dir[:, :, None, :].expand(cam_rays.shape)
        query_ray_orig_ex = self.query_ray_orig.expand(cam_rays.shape)
        lc = torch.cat(
            [cam_rays, torch.zeros_like(query_ray_orig_ex), ray_dir_s, depth_encode, query_ray_orig_ex],
            dim=-1,
        )
        return self.tokf(lc.reshape(self.B * self.V, self.n_rays, S_, -1), S_)

    def fine_tvals(self, dot1: torch.Tensor, S1: int, S2: int) -> torch.Tensor:
        """Stage B's sample positions: S2 steps around each ray's argmax."""
        s_star = torch.argmax(self.ray_major(dot1), dim=-1).float()
        t_lo = torch.clamp((s_star - 1.0) / (S1 - 1), 0.0, 1.0)
        t_hi = torch.clamp((s_star + 1.0) / (S1 - 1), 0.0, 1.0)
        offs = (torch.arange(S2, dtype=torch.float32, device=self.start.device) + 0.5) / S2
        tv2 = t_lo[..., None] + (t_hi - t_lo)[..., None] * offs
        return tv2.reshape(self.B * self.V, self.n_rays, S2)

    def pre_act(self, samples, pts: torch.Tensor, fk: torch.Tensor):
        """K2: W1 over a sample set, with the folded key head ``fk``."""
        t = torch.tanh(pts / 5.0).to(self.cd)
        parts = tuple(s.to(self.cd).contiguous() for s in samples) + (t.contiguous(),)
        return split_dense_relu(parts, self.w1_k, self.w1_b, fk)


# The attention cores.  ``stage`` takes one stage's samples to what the
# softmax (with ``dot1``, which stage B's argmax reads) or K6 needs;
# ``attend`` takes the stages to (z_sum (B, N, C), at_wt (B*V, N, SE)).

class _Unfused:
    """K2 with the key head, ``key_map_2`` and the query embeds, the joint
    softmax, K3 on sample-major tokens or torch sums on ray-major ones, then
    round 2 in its fast (``fast_sampling``) or exact form."""

    flip_secondary = False               # see _RenderCore

    def stage(self, m: "CoPoNeRF", g: _Chunk, st, samples_p, samples_s, pt_p, pt_s):
        S_, tg = st["S"], g.tg(st["S"])
        pre_p, ka = g.pre_act(samples_p, pt_p, g.fk_a)
        pre_s, kb = g.pre_act(samples_s, pt_s, g.fk_b)
        kpre = ka.reshape(*tg, -1) + kb.reshape(*tg, -1) + g.fk_bias.to(g.cd)
        kv_bv = m.key_map_2(torch.relu(kpre))

        cam_rays, depth_encode = g.sample_coords(st["pixel_val"], st["pt"])
        if m.cfg.fast_sampling:
            ps_tok = g.tokf(
                torch.cat([cam_rays, depth_encode], dim=-1).reshape(g.B * g.V, g.n_rays, S_, -1), S_
            ).to(g.cd)
            lc_tok = ps_tok
            pre1 = g.add_perray(ps_tok @ g.qe_ps, g.pre1_ray, S_)
            coords_embed = m.query_embed_2(torch.relu(pre1))
        else:
            lc_tok = g.local_coords(cam_rays, depth_encode, S_)
            coords_embed = m.query_embed_2(torch.relu(m.query_embed(lc_tok)))
        ce = coords_embed.reshape(*tg, -1)
        dot1 = torch.sum(kv_bv * ce, dim=-1, dtype=torch.float32) / 11.31
        st.update(pre_p=pre_p, pre_s=pre_s, ce=ce, lc_tok=lc_tok, dot1=dot1)
        return st

    def attend(self, m: "CoPoNeRF", g: _Chunk, stages):
        w1_list, at_wt_bv = self.joint_softmax(g, stages, [st["dot1"] for st in stages])
        at_wt = at_wt_bv.reshape(g.B * g.V, g.n_rays, -1)
        z_sum = self.weighted_latent(g, stages, w1_list)
        if m.cfg.repeat_attention:
            z_embed = m.encode_latent(z_sum)
            w2_list, _ = self.joint_softmax(g, stages, self.round2(m, g, z_embed, stages))
            z_sum = self.weighted_latent(g, stages, w2_list) + g.V * z_sum
        return z_sum, at_wt

    def round2(self, m: "CoPoNeRF", g: _Chunk, z_embed: torch.Tensor, stages) -> List[torch.Tensor]:
        B, V, N = g.B, g.V, g.n_rays
        if m.cfg.fast_sampling:
            ze_part = z_embed.float() @ g.qre_z
            ze_rows = ze_part[:, None].expand(B, V, *ze_part.shape[1:]).reshape(B * V, N, -1)
            pre2_ray_full = (g.pre2_ray + ze_rows).to(g.cd)
        dots2 = []
        for st in stages:
            S_, tg = st["S"], g.tg(st["S"])
            if m.cfg.fast_sampling:
                pre2 = g.add_perray(st["lc_tok"] @ g.qre_ps, pre2_ray_full, S_)
                emb2 = m.query_repeat_embed_2(torch.relu(pre2)).reshape(*tg, -1)
            else:                        # the exact config: ray-major
                ze = z_embed[:, :, None, :].expand(B, N, S_, z_embed.shape[-1])
                ze_bv = ze[:, None].expand(B, V, *ze.shape[1:])
                pre2 = m.query_repeat_embed(torch.cat([ze_bv, st["lc_tok"].reshape(*tg, -1)], dim=-1))
                emb2 = m.query_repeat_embed_2(torch.relu(pre2))
            dots2.append(torch.sum(emb2 * st["ce"], dim=-1, dtype=torch.float32) / 11.31)
        return dots2

    @staticmethod
    def joint_softmax(g: _Chunk, stages, dots_list):
        d_all = torch.cat([g.ray_major(d) for d in dots_list], dim=-1)   # (B, V, N, SE)
        B, V, N, SE = d_all.shape
        w = torch.softmax(d_all.permute(0, 2, 1, 3).reshape(B, N, V * SE), dim=-1)
        w = w.reshape(B, N, V, SE).permute(0, 2, 1, 3)
        pieces, o = [], 0
        for st in stages:
            pieces.append(w[..., o: o + st["S"]])
            o += st["S"]
        return pieces, w

    @staticmethod
    def weighted_latent(g: _Chunk, stages, w_list) -> torch.Tensor:
        B, V, N = g.B, g.V, g.n_rays

        def wsum(w_bv, pre, S_):
            """sum_s w * pre over one stage's tokens -> (B, N, C) view-sum."""
            if g.smaj:
                w = w_bv.reshape(B * V, N, S_).contiguous()
                return weighted_sum_smaj(pre, w, S_, vsum=V)
            w = w_bv.reshape(B * V, N, S_, 1).to(pre.dtype)
            per_view = torch.sum(pre.reshape(B * V, N, S_, -1) * w, dim=2, dtype=torch.float32)
            return torch.sum(per_view.reshape(B, V, N, -1), dim=1)

        ua = ub = None
        for st, w_bv in zip(stages, w_list):
            a = wsum(w_bv, st["pre_p"], st["S"])
            b2 = wsum(w_bv, st["pre_s"], st["S"])
            ua = a if ua is None else ua + a
            ub = b2 if ub is None else ub + b2
        return ua @ g.flv_a + ub @ g.flv_b + g.flv_bias


class _AttnEmbed(_Unfused):
    """K2, then K7's round 1, the joint softmax and K3, then K7's round 2."""

    def stage(self, m, g, st, samples_p, samples_s, pt_p, pt_s):
        st["lc16"] = g.local_coords(*g.sample_coords(st["pixel_val"], st["pt"]), st["S"]).to(torch.bfloat16)
        pre_p, ka = g.pre_act(samples_p, pt_p, g.fk_a)
        pre_s, kb = g.pre_act(samples_s, pt_s, g.fk_b)
        km2, qe, qe2 = m.key_map_2, m.query_embed, m.query_embed_2
        dot1 = round1_logits(ka, kb, st["lc16"], g.fk_bias, km2.kernel, km2.bias, qe.kernel, qe.bias,
                             qe2.kernel, qe2.bias)
        st.update(pre_p=pre_p, pre_s=pre_s, dot1=dot1.reshape(g.tg(st["S"])))
        return st

    def round2(self, m, g, z_embed, stages):
        qe, qe2, qre, qre2 = m.query_embed, m.query_embed_2, m.query_repeat_embed, m.query_repeat_embed_2
        ze_rows = qre.kernel.shape[0] - 16
        return [
            round2_logits(z_embed, st["lc16"], qe.kernel, qe.bias, qe2.kernel, qe2.bias,
                          qre.kernel[:ze_rows], qre.kernel[ze_rows:], qre.bias,
                          qre2.kernel, qre2.bias, st["S"], g.V).reshape(g.tg(st["S"]))
            for st in stages
        ]


class _RenderCore:
    """K6 in place of K2, the keys, both attention rounds and K3 (one stage)."""

    # K6 takes the secondary samples with their view rows flipped, which it
    # gets by sampling the unswapped tables at flipped coordinates
    flip_secondary = True

    def stage(self, m, g, st, samples_p, samples_s, pt_p, pt_s):
        st["lc16"] = g.local_coords(*g.sample_coords(st["pixel_val"], st["pt"]), st["S"]).to(torch.bfloat16)
        st.update(samples_p=samples_p, samples_s=samples_s, pt_p=pt_p, pt_s=g.swap_views(pt_s))
        return st

    def attend(self, m, g, stages):
        (st,) = stages
        S, V, N = st["S"], g.V, g.n_rays
        km2, qe, qe2, enc = m.key_map_2, m.query_embed, m.query_embed_2, m.encode_latent
        qre, qre2 = m.query_repeat_embed, m.query_repeat_embed_2
        ze_rows = qre.kernel.shape[0] - 16
        with trace.span("render.core"):
            z_sum, at = render_core(
                st["samples_p"], st["pt_p"], st["samples_s"], st["pt_s"], st["lc16"],
                g.w1_k, g.w1_b, g.fk_a, g.fk_b, g.fk_bias, km2.kernel, km2.bias, qe.kernel, qe.bias, qe2.kernel,
                qe2.bias, qre.kernel[:ze_rows], qre.kernel[ze_rows:], qre.bias, qre2.kernel,
                qre2.bias, enc.kernel, enc.bias, g.flv_a, g.flv_b, g.flv_bias, S, V, N,
            )
        return z_sum, at.reshape(g.B, N, V, S).permute(0, 2, 1, 3).reshape(g.B * V, N, S)


# a model's ``fusion`` -> the core of its inference renders
_CORES = {None: _Unfused(), "attn_embed": _AttnEmbed(), "render_core": _RenderCore()}


class CoPoNeRF(nn.Module):
    """``image_size`` fixes the UFC grid sizes (image/16, /8, /4) and with
    them the ``pos_embed`` shapes, which flax infers from the first batch.
    ``fusion`` (None, ``"attn_embed"`` or ``"render_core"``) picks the core
    of every inference render; training renders run unfused.  A
    configuration that cannot run it raises here."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), image_size: int = 256, fusion: Optional[str] = None):
        super().__init__()
        check_fusion(cfg, fusion)
        self.cfg = c = cfg
        self.image_size = image_size
        self.fusion = fusion
        self._core = _CORES[fusion]
        bf16 = c.compute_dtype == "bfloat16"
        ufc_dt = torch.bfloat16 if bf16 else None
        cd = torch.bfloat16 if bf16 else None
        self.encoder = ResNet34Encoder()
        stage_hw = [image_size // 16, image_size // 8, image_size // 4]
        self.feature_cost_aggregation = UFC(
            stage_hw, nhead=c.corr_heads, layer_nums=tuple(c.ufc_layer_nums), dtype=ufc_dt,
            remat=c.remat_ufc, fused_argmax=bool(c.fused_argmax), remat_policy=c.remat_policy,
            conv4d_impl=c.conv4d_impl,
        )
        self.cross_attention = CrossBlock()
        self.pose_regressor = MLPSeq(2 * (256 + 6) * 256, (512, 256, 256), act_last=True)
        self.rotation_regressor = MLPSeq(128, (64, 32, 6), act_first=True)
        self.translation_regressor = MLPSeq(128, (64, 32, 3), act_first=True)
        self.conv_map = ConvNHWC(3, 64, 7, padding=3, dtype=ufc_dt)
        latent, hid = c.latent_dim, c.hidden_dim
        half = latent // 2
        self.query_encode_latent = Dense(latent + 3, latent)
        self.query_encode_latent_2 = Dense(latent, half)
        self.latent_value = Dense(latent, half)
        self.key_map = Dense(latent, hid)
        self.key_map_2 = Dense(hid, hid, cd)
        self.query_embed = Dense(16, hid)
        self.query_embed_2 = Dense(hid, hid, cd)
        self.query_repeat_embed = Dense(hid + 16, hid)
        self.query_repeat_embed_2 = Dense(hid, hid, cd)
        self.encode_latent = Dense(half, hid)
        self.phi = ResnetFC(d_in=c.n_view * 9, d_out=3, n_blocks=3, d_latent=half * c.n_view,
                            d_hidden=c.num_hidden_units_phi)
        self._encode_graphs = EncodeGraphs()

    def with_fusion(self, fusion: Optional[str]) -> "CoPoNeRF":
        """This model built with ``fusion`` instead: it holds this model's
        parameters and buffers themselves (nothing is copied) and is in its
        training mode."""
        with torch.device("meta"):
            twin = CoPoNeRF(self.cfg, self.image_size, fusion)
        twin.load_state_dict(self.state_dict(), assign=True)
        return twin.train(self.training)

    # ------------------------------------------------------------------ #
    # encode: features, correspondence, relative pose
    # ------------------------------------------------------------------ #

    @trace.spanned("encode")
    def encode(self, batch: Dict[str, Any], train: bool = False) -> SceneState:
        """``train`` normalises the encoder's BatchNorms with the batch
        statistics and updates their running statistics.  An inference
        encode of CUDA inputs with gradients off replays CUDA graphs of
        its three stages (``models/encode_graph.py``); the others run
        eagerly."""
        ctx = batch["context"]
        rgb, intr = ctx["rgb"], ctx["intrinsics"]
        if rgb.is_cuda and not train and not torch.is_grad_enabled():
            return self._encode_graphs(self, rgb, intr)
        return self._encode_eager(rgb, intr, train)

    def _encode_eager(self, rgb: torch.Tensor, intr: torch.Tensor, train: bool = False) -> SceneState:
        with trace.span("encode.backbone"):
            z_feats, z_conv = self._encode_backbone(rgb, train)
        with trace.span("encode.ufc"):
            feat_list, flows, c = self.feature_cost_aggregation(z_feats, rgb.shape[1])
        with trace.span("encode.pose"):
            return self._encode_pose(feat_list, flows, c, z_conv, intr, rgb.shape, train)

    def _encode_backbone(self, rgb: torch.Tensor, train: bool):
        """Context rgb (B, V, H, W, 3) in [-1, 1] -> (the ResNet's pyramid,
        ``conv_map``'s full-resolution map)."""
        B, V, H, W, _ = rgb.shape
        rgb = _normalize_rgb(rgb.reshape(B * V, H, W, 3))
        cd = torch.bfloat16 if self.cfg.compute_dtype == "bfloat16" else torch.float32
        # the encoder computes in f32 on the (bf16-rounded, under bf16)
        # input; the UFC casts the latents to its own compute dtype
        return self.encoder(rgb.to(cd), train=train), self.conv_map(rgb)

    def _encode_pose(self, feat_list, flows, c, z_conv, intr: torch.Tensor, rgb_shape,
                     train: bool) -> SceneState:
        """The relative pose, the cycle mask, the upsampled flow and the
        render's tables."""
        B, V, H, W, _ = rgb_shape
        fx = intr[:, 0, 0, 0][:, None] / H
        fy = intr[:, 0, 1, 1][:, None] / H
        cx = intr[:, 0, 0, 2][:, None] / H
        cy = intr[:, 0, 1, 2][:, None] / H
        tokens = feat_list[-1].reshape(B * V, -1, feat_list[-1].shape[-1]).float()
        pose_feat = self.cross_attention(tokens, c, (fx, fy, cx, cy)).reshape(B, -1)
        pose_latent = self.pose_regressor(pose_feat)[:, :128]
        rot = self.rotation_regressor(pose_latent)
        tran = self.translation_regressor(pose_latent)
        R = G.r6d2mat(rot)[:, :3, :3]
        top = torch.cat([R, tran[..., None]], dim=-1)
        _, _, bottom = _constants(top.device, top.dtype)
        rel_pose = torch.cat([top, bottom.expand(B, 1, 4)], dim=1)

        # K1 and K8a read each table as contiguous NHWC rows
        z = tuple(t.contiguous() for t in (*feat_list, z_conv))
        up = self.cfg.mask_upsample
        _, _, _, mask_bwd = flow_ops.cyclic_consistency_masks(flows[0], flows[1], out_size=up, scale=up / W)
        kps_flow_bwd = resize_nchw(flows[1], (up, up), align_corners=False) * (up / flows[1].shape[-2])
        z0_bf16 = None
        if self.cfg.fast_sampling and not train:
            for zl in z:
                if is_full_resolution(zl):
                    z0_bf16 = zl.to(torch.bfloat16)
        return SceneState(
            z=z, rel_pose=rel_pose, flows=tuple(flows), mask_bwd=mask_bwd.float(),
            kps_flow_bwd=kps_flow_bwd, z0_bf16=z0_bf16,
        )

    # ------------------------------------------------------------------ #
    # render: epipolar attention + light-field decoding
    # ------------------------------------------------------------------ #

    def _query_cams(self, batch, rel_pose, val: bool):
        ctx, query = batch["context"], batch["query"]
        B, V = ctx["rgb"].shape[:2]
        n_rays = query["uv"].shape[2]
        inv_ctx = G.pose_inverse_4x4(ctx["cam2world"])
        if val:
            q1 = inv_ctx[:, 0:1] @ query["cam2world"]
            q2 = G.pose_inverse_4x4(rel_pose)[:, None] @ q1
            query_cam2world = torch.cat([q1, q2], dim=1)
        else:
            query_cam2world = inv_ctx @ query["cam2world"]
        n_hyp = query_cam2world.shape[1]
        uv = query["uv"].expand(B, n_hyp, n_rays, 2).reshape(B * n_hyp, n_rays, 2)
        q_intr = query["intrinsics"].expand(B, n_hyp, 4, 4).reshape(B * n_hyp, 4, 4)
        qc2w_flat = query_cam2world.reshape(B * n_hyp, 4, 4)
        lf_coords = G.plucker_embedding(qc2w_flat, uv, q_intr)
        H = ctx["rgb"].shape[2]
        ctx_intr = ctx["intrinsics"]
        intr_norm = ctx_intr.clone()
        intr_norm[:, :, :2, :] = ctx_intr[:, :, :2, :] / H
        cam_origin = G.get_ray_origin(qc2w_flat)[:, None, :].expand(B * n_hyp, n_rays, 3)
        eye = _eye(4, qc2w_flat).expand(B * n_hyp, 4, 4)
        proj = G.project_rays(cam_origin, lf_coords[..., :3], eye, intr_norm.reshape(B * V, 4, 4))
        return query_cam2world, qc2w_flat, lf_coords, proj, inv_ctx

    @torch.no_grad()
    def valid_ray_mask(self, batch: Dict[str, Any], state: SceneState, val: bool = False) -> torch.Tensor:
        """Per-ray epipolar validity, any over views/hypotheses: (B, n_rays)
        bool.  The geometry prefix of render(), in lockstep with it."""
        B = batch["context"]["rgb"].shape[0]
        n_rays = batch["query"]["uv"].shape[2]
        _, _, _, proj, _ = self._query_cams(batch, state.rel_pose, val)
        return proj["overlaps_image"].reshape(B, -1, n_rays).any(dim=1)

    @trace.spanned("render")
    def render(self, batch: Dict[str, Any], state: SceneState, val: bool = False,
               train: bool = False) -> Dict[str, Any]:
        """One ray chunk through the model's attention core, or in training
        (``train``) through the unfused one."""
        cfg = self.cfg
        core = _CORES[None] if train else self._core
        g = _Chunk(self, batch, state, val, train, core)
        two_stage = g.smaj and cfg.coarse_samples > 0 and cfg.fine_samples > 0
        S1 = cfg.coarse_samples if two_stage else cfg.npoints
        lin = torch.linspace(0.0, 1.0, S1, dtype=g.start.dtype, device=g.start.device)
        with trace.span("render.stage_a"):
            stages = [self._stage(core, g, lin, S1)]
        if two_stage:
            with trace.span("render.stage_b"):
                tv2 = g.fine_tvals(stages[0]["dot1"], S1, cfg.fine_samples)
                stages.append(self._stage(core, g, tv2, cfg.fine_samples))
        with trace.span("render.attention"):
            z_sum, at_wt = core.attend(self, g, stages)
        with trace.span("render.decode"):
            rgb, vm_any, coords9 = self._decode(g, z_sum)
        out = {"flow": state.flows, "valid_mask": vm_any[..., None],
               "rgb": rgb.reshape(g.B, batch["query"]["uv"].shape[1], g.n_rays, 3)}
        out.update(self._aux_outputs(batch, state, g, stages, at_wt, coords9))
        return out

    def _sample_levels(self, g: _Chunk, zs, p: torch.Tensor, mode: str):
        if g.smaj:
            return multilevel_sample(zs, p.contiguous(), mode)
        return [self._sample_level(z, p, mode) for z in zs]

    def _sample_level(self, z: torch.Tensor, p: torch.Tensor, mode: str) -> torch.Tensor:
        cfg = self.cfg
        if not cfg.fast_sampling:
            return grid_sample_tablegrad(z, p, mode)
        if not is_full_resolution(z) and cfg.train_onehot_small:
            return grid_sample_onehot(z, p, mode)
        return grid_sample_tablegrad(z.to(torch.bfloat16), p, mode)

    def _stage(self, core, g: _Chunk, tvals: torch.Tensor, S_: int) -> Dict[str, Any]:
        """The samples at ``tvals`` along the epipolar segments, through ``core``."""
        pixel_val = g.start[:, :, None, :] + (g.end - g.start)[:, :, None, :] * tvals[..., None]
        pv_flat = g.tokf(pixel_val, S_)
        samples_p = self._sample_levels(g, g.tables, pv_flat, "border")

        pt, _, _, _ = G.get_3d_point_epipolar(g.lf_coords, pixel_val, g.ctx_flat_c2w, g.H, g.W, g.ctx_flat_intr)
        pt_own = G.encode_relative_point(pt, g.crel_diag)
        pt_cross = G.encode_relative_point(pt, g.crel_other)
        px_cross = g.norm_px(
            G.project(pt_cross[..., 0], pt_cross[..., 1], pt_cross[..., 2], g.intr_other)[..., :2]
        )
        px_flat = g.tokf(px_cross, S_)
        px_s = g.swap_views(px_flat) if core.flip_secondary else px_flat
        samples_s = self._sample_levels(g, g.tables_s, px_s, "zeros")
        if g.conv_rgb is not None:
            sp_conv, ss_conv = convmap_sample_pair(
                g.conv_rgb, self.conv_map.weight, self.conv_map.bias, pv_flat, px_flat,
                g.cd == torch.bfloat16, self.cfg.fast_sampling,
            )
            samples_p.append(sp_conv)
            samples_s.append(ss_conv)

        pt_p = g.tokf(_scrub(pt_own).detach(), S_)
        pt_s = g.tokf(_scrub(pt_cross), S_)
        st = {"S": S_, "pixel_val": pixel_val, "pt": pt}
        return core.stage(self, g, st, samples_p, samples_s, pt_p, pt_s)

    def _decode(self, g: _Chunk, z_sum: torch.Tensor):
        """-> (rgb (B, N, 3), white where no view sees the ray; that mask;
        the rays' coordinates (B*V, N, 9))."""
        B, V, N = g.B, g.V, g.n_rays
        z_flat = torch.cat([z_sum] * V, dim=-1)
        qro_n = g.query_ray_orig[:, :, 0, :].expand(B * V, N, 3)
        coords9 = torch.cat([g.lf_coords, qro_n], dim=-1)
        coords18 = coords9.reshape(B, V, N, 9).permute(0, 2, 1, 3).reshape(B, N, -1)
        rgb = self.phi(torch.cat([z_flat, coords18], dim=-1))

        vm_any = (g.valid_mask.reshape(B, V, N) > 0).any(dim=1).to(rgb.dtype)
        rgb = rgb * vm_any[..., None] + (1.0 - vm_any[..., None])
        return rgb, vm_any, coords9

    def _aux_outputs(self, batch, state: SceneState, g: _Chunk, stages, at_wt, coords9) -> Dict[str, Any]:
        """Depth, the cycle masks and flows, the weights and the poses."""
        query, ctx_c2w, ctx_intr = batch["query"], batch["context"]["cam2world"], batch["context"]["intrinsics"]
        B, V, N = g.B, g.V, g.n_rays
        pt_all = torch.cat([st["pt"] for st in stages], dim=-2)
        pt_clamp = torch.clamp(pt_all, -100.0, 100.0)
        world_pt = torch.sum(at_wt[..., None] * pt_clamp, dim=-2)
        world_pt = world_pt.reshape(B, V, N, 3).sum(dim=1)
        world_pt_cam = G.project_cam2world(world_pt, query["cam2world"][:, 0])
        depth_ray = world_pt_cam[:, :, 2]

        T_to_C1, T_to_C2 = (
            G.batch_project_to_other_img(query["uv"][:, 0], depth_ray, query["intrinsics"][:, 0, :3, :3],
                                         ctx_intr[:, v, :3, :3], g.query_cam2world[:, v])
            for v in (0, 1)
        )
        up_hw = (self.cfg.mask_upsample, self.cfg.mask_upsample)
        cycle_mask = flow_ops.mask_from_confidence(T_to_C2, state.mask_bwd, N, upsample_size=up_hw)
        C2_to_C1, mask_c2 = flow_ops.flow2kps_from_upsampled(T_to_C2, state.kps_flow_bwd, N)
        return {
            "matchability_cycle_mask": cycle_mask,
            "T_to_C1_pts": T_to_C1,
            "T_to_C2_pts": T_to_C2,
            "C2_pts_to_C1": C2_to_C1.transpose(1, 2),
            "mask_c2": mask_c2,
            "at_wt": at_wt,
            "at_wt_max": torch.argmax(at_wt, dim=-1),
            "depth_ray": torch.clamp(depth_ray, 0.0, 10.0)[..., None],
            "pixel_val": torch.cat([st["pixel_val"] for st in stages], dim=-2),
            "coords": coords9,
            "uv": query["uv"],
            "z": state.z,
            "rel_pose": state.rel_pose,
            "rel_pose_flip": G.pose_inverse_4x4(state.rel_pose),
            "gt_rel_pose": G.pose_inverse_4x4(ctx_c2w[:, 0]) @ ctx_c2w[:, 1],
        }

    def forward(self, batch: Dict[str, Any], val: bool = False, train: bool = False):
        state = self.encode(batch, train=train)
        return self.render(batch, state, val=val, train=train)


def batch_to_torch(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """numpy batch (``data/synthetic.py:make_batch`` schema) -> f32 tensors."""
    return {
        k: (batch_to_torch(v, device) if isinstance(v, dict)
            else torch.as_tensor(v, dtype=torch.float32, device=device))
        for k, v in batch.items()
    }
