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

``render(fusion=...)`` (fast bf16 inference only; default None) fuses more
of the render: ``"attn_embed"`` computes each stage's round-1 and round-2
logits with K7 (``ops.attn_embed``) from K2's keys and the 16-wide local
coordinates; ``"render_core"`` (single stage, repeat attention) hands both
sample sets to K6 (``ops.render_core``), which replaces K2, the keys, both
attention rounds and K3.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

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


class CoPoNeRF(nn.Module):
    """``image_size`` fixes the UFC grid sizes (image/16, /8, /4) and with
    them the ``pos_embed`` shapes, which flax infers from the first batch."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), image_size: int = 256):
        super().__init__()
        self.cfg = c = cfg
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
                if zl.shape[1] * zl.shape[2] > 4096:  # the full-resolution table
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
               train: bool = False, fusion: Optional[str] = None) -> Dict[str, Any]:
        """``fusion``: None, ``"attn_embed"`` (K7) or ``"render_core"`` (K6);
        see the module docstring."""
        cfg = self.cfg
        ctx, query = batch["context"], batch["query"]
        B, V = ctx["rgb"].shape[:2]
        H, W = ctx["rgb"].shape[2:4]
        n_qry, n_rays = query["uv"].shape[1:3]
        S = cfg.npoints
        rel_pose = state.rel_pose
        out: Dict[str, Any] = {"flow": state.flows}
        mask_bwd = state.mask_bwd

        ctx_c2w = ctx["cam2world"]
        query_cam2world, qc2w_flat, lf_coords, proj, inv_ctx = self._query_cams(batch, rel_pose, val)
        context_cam2world = _eye(4, ctx_c2w).expand(B, V, 4, 4)
        valid_mask = proj["overlaps_image"].float()

        def scrub(x):
            return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)

        start = scrub((proj["xy_min"] - 0.5) * 2.0)
        end = scrub((proj["xy_max"] - 0.5) * 2.0)
        ray_dir = lf_coords[..., :3]

        # training is ray-major and single-stage
        smaj = cfg.fast_sampling and not train
        two_stage = smaj and cfg.coarse_samples > 0 and cfg.fine_samples > 0
        S1 = cfg.coarse_samples if two_stage else S
        if fusion is not None:
            if fusion not in ("attn_embed", "render_core"):
                raise ValueError(f"unknown fusion {fusion!r}")
            if not smaj or cfg.compute_dtype != "bfloat16":
                raise ValueError(f"fusion={fusion!r} runs in the fast bf16 inference render only "
                                 "(fast_sampling, compute_dtype='bfloat16', train=False)")
            if fusion == "render_core" and (two_stage or not cfg.repeat_attention):
                raise ValueError("fusion='render_core' needs one sampling stage and repeat_attention")

        def tokf(t, S_):
            """(B*V, N, S_, C) -> (B*V, T, C) in the active token order."""
            if smaj:
                t = t.transpose(1, 2)
            return t.reshape(t.shape[0], n_rays * S_, -1)

        def swap_views(z):
            return z.reshape(B, V, *z.shape[1:]).flip(1).reshape(z.shape)

        if smaj:
            # K8a samples every level of a sample set in one launch, bf16
            # tables and outputs (the consumers are the bf16 W1 parts); the
            # full-resolution table comes from the encode-time cast
            tables = [
                state.z0_bf16 if (state.z0_bf16 is not None and z.shape[1] * z.shape[2] > 4096)
                else z.to(torch.bfloat16)
                for z in state.z
            ]

            def sample_levels(zs, p, mode):
                return multilevel_sample(zs, p.contiguous(), mode)
        else:
            tables = list(state.z)

            def sample(z, p, mode):
                if not cfg.fast_sampling:
                    return grid_sample_tablegrad(z, p, mode)
                if z.shape[1] * z.shape[2] <= 4096 and cfg.train_onehot_small:
                    return grid_sample_onehot(z, p, mode)
                return grid_sample_tablegrad(z.to(torch.bfloat16), p, mode)

            def sample_levels(zs, p, mode):
                return [sample(z, p, mode) for z in zs]

        # training: the 256^2 conv_map level is sampled through
        # convmap_sample_pair, whose backward goes straight to the conv kernel
        fuse_conv = train and cfg.convmap_direct_grad
        if fuse_conv:
            tables = tables[:-1]
            rgb_n = _normalize_rgb(ctx["rgb"].reshape(B * V, H, W, 3))
        # K6 takes the secondary samples with their view rows flipped, which
        # it gets by sampling the unswapped tables at flipped coordinates
        tables_sw = [swap_views(z) for z in tables] if fusion != "render_core" else None

        ctx_flat_c2w = context_cam2world.reshape(B * V, 4, 4)
        ctx_intr = ctx["intrinsics"]
        ctx_flat_intr = ctx_intr.reshape(B * V, 4, 4)
        if val:
            ident = _eye(4, rel_pose).expand(B, 1, 4, 4)
            crel_v1 = torch.cat([ident, rel_pose[:, None]], dim=1)
            crel_v2 = torch.cat([G.pose_inverse_4x4(rel_pose)[:, None], ident], dim=1)
        else:
            crel_v1 = inv_ctx[:, 0:1] @ ctx_c2w
            crel_v2 = inv_ctx[:, 1:2] @ ctx_c2w
        intr_v1, intr_v2 = ctx_intr[:, 0], ctx_intr[:, 1]
        crel_diag = torch.cat([crel_v1[:, 0:1], crel_v2[:, 1:2]], dim=1)
        crel_other = torch.cat([crel_v2[:, 0:1], crel_v1[:, 1:2]], dim=1)
        intr_other = torch.stack([intr_v2, intr_v1], dim=1).reshape(B * V, 4, 4)

        def norm_px(p):
            x = (p[..., 0] / (W - 1)) * 2 - 1
            y = (p[..., 1] / (H - 1)) * 2 - 1
            return torch.stack([x, y], dim=-1)

        bf16 = cfg.compute_dtype == "bfloat16"
        cd = torch.bfloat16 if bf16 else torch.float32

        # folded linear maps after W1 (see the JAX module for the algebra):
        # per-sample work after W1 is one 832 -> 128 product, fused into K2
        w1_k = self.query_encode_latent.kernel
        w1_b = self.query_encode_latent.bias
        half = cfg.latent_dim // 2
        w2_k, w2_b = self.query_encode_latent_2.kernel, self.query_encode_latent_2.bias
        km_k, km_b = self.key_map.kernel, self.key_map.bias
        lv_k, lv_b = self.latent_value.kernel, self.latent_value.bias
        fk_a = w2_k @ km_k[:half]
        fk_b = w2_k @ km_k[half:]
        fk_bias = w2_b @ (km_k[:half] + km_k[half:]) + km_b
        flv_a = w2_k @ lv_k[:half]
        flv_b = w2_k @ lv_k[half:]
        flv_bias = w2_b @ (lv_k[:half] + lv_k[half:]) + lv_b

        def pre_act(samples, pts, fk):
            t = torch.tanh(pts / 5.0).to(cd)
            parts = tuple(s.to(cd).contiguous() for s in samples) + (t.contiguous(),)
            return split_dense_relu(parts, w1_k, w1_b, fk)

        query_ray_orig = G.get_ray_origin(qc2w_flat)[:, None, None, :]

        fast_embed = cfg.fast_sampling
        if fast_embed:
            ps_rows = torch.tensor([0, 1, 2, 9, 10, 11, 12], device=ray_dir.device)
            trace.count("host_syncs")    # a blocking host-to-device copy
            qe_k, qe_b = self.query_embed.kernel, self.query_embed.bias
            qe_ps, qe_rd, qe_qo = qe_k[ps_rows].to(cd), qe_k[6:9], qe_k[13:16]
            qro_row = query_ray_orig[:, :, 0, :]
            pre1_ray = (ray_dir @ qe_rd + qro_row @ qe_qo + qe_b).to(cd)
            if cfg.repeat_attention:
                qre_k, qre_b = self.query_repeat_embed.kernel, self.query_repeat_embed.bias
                ze_dim = qre_k.shape[0] - 16
                qre_z = qre_k[:ze_dim]
                qre_ps = qre_k[ze_dim + ps_rows].to(cd)
                qre_rd, qre_qo = qre_k[ze_dim + 6: ze_dim + 9], qre_k[ze_dim + 13:]
                pre2_ray = ray_dir @ qre_rd + qro_row @ qre_qo + qre_b

        def add_perray(tok, per_ray, S_):
            """tok (B*V, T, C) + per-ray (B*V, N, C) broadcast in token order."""
            R = tok.shape[0]
            if smaj:
                t4, pr4 = tok.reshape(R, S_, n_rays, -1), per_ray[:, None]
            else:
                t4, pr4 = tok.reshape(R, n_rays, S_, -1), per_ray[:, :, None]
            return (t4 + pr4).reshape(tok.shape)

        def sample_coords(pixel_val, pt):
            """Per-sample camera ray directions and depth encoding."""
            cam_rays = G.get_ray_directions_cam(pixel_val, ctx_flat_intr, H, W)
            depth = torch.linalg.vector_norm(pt - query_ray_orig, dim=-1)[..., None]
            depth = torch.nan_to_num(depth, nan=1e6, posinf=1e6, neginf=1e6).detach()
            depth_encode = torch.cat(
                [torch.tanh(depth), torch.tanh(depth / 10.0), torch.tanh(depth / 100.0), torch.tanh(depth / 1000.0)],
                dim=-1,
            )
            return cam_rays, depth_encode

        def local_coords(cam_rays, depth_encode, S_):
            """The 16-wide local coordinates per token, in token order."""
            ray_dir_s = ray_dir[:, :, None, :].expand(cam_rays.shape)
            query_ray_orig_ex = query_ray_orig.expand(cam_rays.shape)
            lc = torch.cat(
                [cam_rays, torch.zeros_like(query_ray_orig_ex), ray_dir_s, depth_encode, query_ray_orig_ex],
                dim=-1,
            )
            return tokf(lc.reshape(B * V, n_rays, S_, -1), S_)

        def fused_stage(pixel_val, pt, samples_p, samples_s, pt_primary, pt_secondary, S_):
            """One stage under ``fusion``: K7's round-1 logits from K2's keys,
            or, for K6, the stage's inputs as K6 takes them."""
            st = {"S": S_, "tg": (B, V, S_, n_rays), "pixel_val": pixel_val, "pt": pt,
                  "lc16": local_coords(*sample_coords(pixel_val, pt), S_).to(torch.bfloat16)}
            if fusion == "render_core":
                st.update(samples_p=samples_p, samples_s=samples_s, pt_p=pt_primary,
                          pt_s=swap_views(pt_secondary))
                return st
            pre_p, ka = pre_act(samples_p, pt_primary, fk_a)
            pre_s, kb = pre_act(samples_s, pt_secondary, fk_b)
            km2, qe, qe2 = self.key_map_2, self.query_embed, self.query_embed_2
            dot1 = round1_logits(ka, kb, st["lc16"], fk_bias, km2.kernel, km2.bias, qe.kernel, qe.bias,
                                 qe2.kernel, qe2.bias)
            st.update(pre_p=pre_p, pre_s=pre_s, dot1=dot1.reshape(st["tg"]))
            return st

        def run_stage(tvals, S_):
            pixel_val = start[:, :, None, :] + (end - start)[:, :, None, :] * tvals[..., None]
            pv_flat = tokf(pixel_val, S_)
            samples_p = sample_levels(tables, pv_flat, "border")

            pt, _, _, _ = G.get_3d_point_epipolar(lf_coords, pixel_val, ctx_flat_c2w, H, W, ctx_flat_intr)
            pt_own = G.encode_relative_point(pt, crel_diag)
            pt_cross = G.encode_relative_point(pt, crel_other)
            px_cross = norm_px(
                G.project(pt_cross[..., 0], pt_cross[..., 1], pt_cross[..., 2], intr_other)[..., :2]
            )
            px_flat = tokf(px_cross, S_)
            if fusion == "render_core":
                samples_s = sample_levels(tables, swap_views(px_flat), "zeros")
            else:
                samples_s = sample_levels(tables_sw, px_flat, "zeros")
            if fuse_conv:
                sp_conv, ss_conv = convmap_sample_pair(
                    rgb_n, self.conv_map.weight, self.conv_map.bias, pv_flat, px_flat,
                    bf16, cfg.fast_sampling,
                )
                samples_p.append(sp_conv)
                samples_s.append(ss_conv)

            pt_primary = tokf(scrub(pt_own).detach(), S_)
            pt_secondary = tokf(scrub(pt_cross), S_)
            if fusion is not None:
                return fused_stage(pixel_val, pt, samples_p, samples_s, pt_primary, pt_secondary, S_)
            pre_p, ka = pre_act(samples_p, pt_primary, fk_a)
            pre_s, kb = pre_act(samples_s, pt_secondary, fk_b)
            tg_ = (B, V, S_, n_rays) if smaj else (B, V, n_rays, S_)
            kpre = ka.reshape(*tg_, -1) + kb.reshape(*tg_, -1) + fk_bias.to(cd)
            kv_bv = self.key_map_2(torch.relu(kpre))

            cam_rays, depth_encode = sample_coords(pixel_val, pt)
            if fast_embed:
                ps_tok = tokf(
                    torch.cat([cam_rays, depth_encode], dim=-1).reshape(B * V, n_rays, S_, -1), S_
                ).to(cd)
                lc_tok = ps_tok
                pre1 = add_perray(ps_tok @ qe_ps, pre1_ray, S_)
                coords_embed = self.query_embed_2(torch.relu(pre1))
            else:
                lc_tok = local_coords(cam_rays, depth_encode, S_)
                coords_embed = self.query_embed_2(torch.relu(self.query_embed(lc_tok)))
            ce = coords_embed.reshape(*tg_, -1)
            dot1 = torch.sum(kv_bv * ce, dim=-1, dtype=torch.float32) / 11.31
            return {
                "S": S_, "tg": tg_, "pixel_val": pixel_val, "pt": pt,
                "pre_p": pre_p, "pre_s": pre_s, "ce": ce, "lc_tok": lc_tok, "dot1": dot1,
            }

        def ray_major(dot):
            """(*tg_) logits -> (B, V, N, S_)."""
            return dot.transpose(2, 3) if smaj else dot

        lin = torch.linspace(0.0, 1.0, S1, dtype=start.dtype, device=start.device)
        with trace.span("render.stage_a"):
            stages = [run_stage(lin, S1)]
        if two_stage:
            with trace.span("render.stage_b"):
                S2 = cfg.fine_samples
                d1 = ray_major(stages[0]["dot1"])
                s_star = torch.argmax(d1, dim=-1).float()
                t_lo = torch.clamp((s_star - 1.0) / (S1 - 1), 0.0, 1.0)
                t_hi = torch.clamp((s_star + 1.0) / (S1 - 1), 0.0, 1.0)
                offs = (torch.arange(S2, dtype=torch.float32, device=start.device) + 0.5) / S2
                tv2 = t_lo[..., None] + (t_hi - t_lo)[..., None] * offs
                stages.append(run_stage(tv2.reshape(B * V, n_rays, S2), S2))

        def joint_softmax(dots_list):
            d_all = torch.cat([ray_major(d) for d in dots_list], dim=-1)   # (B, V, N, SE)
            SE = d_all.shape[-1]
            w = torch.softmax(d_all.permute(0, 2, 1, 3).reshape(B, n_rays, V * SE), dim=-1)
            w = w.reshape(B, n_rays, V, SE).permute(0, 2, 1, 3)
            pieces, o = [], 0
            for st in stages:
                pieces.append(w[..., o: o + st["S"]])
                o += st["S"]
            return pieces, w

        def wsum(w_bv, pre, S_):
            """sum_s w * pre over one stage's tokens -> (B, N, C) view-sum."""
            if smaj:
                w = w_bv.reshape(B * V, n_rays, S_).contiguous()
                return weighted_sum_smaj(pre, w, S_, vsum=V)
            w = w_bv.reshape(B * V, n_rays, S_, 1).to(pre.dtype)
            per_view = torch.sum(pre.reshape(B * V, n_rays, S_, -1) * w, dim=2, dtype=torch.float32)
            return torch.sum(per_view.reshape(B, V, n_rays, -1), dim=1)

        def weighted_latent(w_list):
            ua = ub = None
            for st, w_bv in zip(stages, w_list):
                a = wsum(w_bv, st["pre_p"], st["S"])
                b2 = wsum(w_bv, st["pre_s"], st["S"])
                ua = a if ua is None else ua + a
                ub = b2 if ub is None else ub + b2
            return ua @ flv_a + ub @ flv_b + flv_bias

        with trace.span("render.attention"):
            qre_mod, qre2_mod = self.query_repeat_embed, self.query_repeat_embed_2
            ze_rows = qre_mod.kernel.shape[0] - 16
            if fusion == "render_core":
                st = stages[0]
                km2, qe, qe2, enc = self.key_map_2, self.query_embed, self.query_embed_2, self.encode_latent
                z_sum, at = render_core(
                    st["samples_p"], st["pt_p"], st["samples_s"], st["pt_s"], st["lc16"],
                    w1_k, w1_b, fk_a, fk_b, fk_bias, km2.kernel, km2.bias, qe.kernel, qe.bias, qe2.kernel, qe2.bias,
                    qre_mod.kernel[:ze_rows], qre_mod.kernel[ze_rows:], qre_mod.bias, qre2_mod.kernel, qre2_mod.bias,
                    enc.kernel, enc.bias, flv_a, flv_b, flv_bias, S, V, n_rays,
                )
                at_wt = at.reshape(B, n_rays, V, S).permute(0, 2, 1, 3).reshape(B * V, n_rays, S)
            else:
                w1_list, at_wt_bv = joint_softmax([st["dot1"] for st in stages])
                at_wt = at_wt_bv.reshape(B * V, n_rays, -1)
                z_sum = weighted_latent(w1_list)

            if cfg.repeat_attention and fusion == "attn_embed":
                z_embed = self.encode_latent(z_sum)
                qe, qe2 = self.query_embed, self.query_embed_2
                dots2 = [
                    round2_logits(z_embed, st["lc16"], qe.kernel, qe.bias, qe2.kernel, qe2.bias,
                                  qre_mod.kernel[:ze_rows], qre_mod.kernel[ze_rows:], qre_mod.bias,
                                  qre2_mod.kernel, qre2_mod.bias, st["S"], V).reshape(st["tg"])
                    for st in stages
                ]
                w2_list, _ = joint_softmax(dots2)
                z_sum = weighted_latent(w2_list) + V * z_sum
            elif cfg.repeat_attention and fusion is None:
                z_embed = self.encode_latent(z_sum)
                C_ze = z_embed.shape[-1]
                dots2 = []
                if fast_embed:
                    ze_part = z_embed.float() @ qre_z
                    ze_rows = ze_part[:, None].expand(B, V, *ze_part.shape[1:]).reshape(B * V, n_rays, -1)
                    pre2_ray_full = (pre2_ray + ze_rows).to(cd)
                for st in stages:
                    S_, tg_ = st["S"], st["tg"]
                    if fast_embed:
                        pre2 = add_perray(st["lc_tok"] @ qre_ps, pre2_ray_full, S_)
                        emb2 = self.query_repeat_embed_2(torch.relu(pre2))
                        dots2.append(torch.sum(emb2.reshape(*tg_, -1) * st["ce"], dim=-1, dtype=torch.float32) / 11.31)
                        continue
                    if smaj:
                        ze = z_embed[:, None, :, :].expand(B, S_, n_rays, C_ze)
                    else:
                        ze = z_embed[:, :, None, :].expand(B, n_rays, S_, C_ze)
                    lc = st["lc_tok"].reshape(*tg_, -1)
                    ze_bv = ze[:, None].expand(B, V, *ze.shape[1:])
                    pre2 = self.query_repeat_embed(torch.cat([ze_bv, lc], dim=-1))
                    emb2 = self.query_repeat_embed_2(torch.relu(pre2))
                    dots2.append(torch.sum(emb2 * st["ce"], dim=-1, dtype=torch.float32) / 11.31)
                w2_list, _ = joint_softmax(dots2)
                z_sum = weighted_latent(w2_list) + V * z_sum

        with trace.span("render.decode"):
            z_flat = torch.cat([z_sum] * V, dim=-1)
            qro_n = query_ray_orig[:, :, 0, :].expand(B * V, n_rays, 3)
            coords9 = torch.cat([lf_coords, qro_n], dim=-1)
            coords18 = coords9.reshape(B, V, n_rays, 9).permute(0, 2, 1, 3).reshape(B, n_rays, -1)
            rgb = self.phi(torch.cat([z_flat, coords18], dim=-1))

            vm_any = (valid_mask.reshape(B, V, n_rays) > 0).any(dim=1).to(rgb.dtype)
            rgb = rgb * vm_any[..., None] + (1.0 - vm_any[..., None])
            out["valid_mask"] = vm_any[..., None]
            out["rgb"] = rgb.reshape(B, n_qry, n_rays, 3)

        pt_all = torch.cat([st["pt"] for st in stages], dim=-2)
        pt_clamp = torch.clamp(pt_all, -100.0, 100.0)
        world_pt = torch.sum(at_wt[..., None] * pt_clamp, dim=-2)
        world_pt = world_pt.reshape(B, V, n_rays, 3).sum(dim=1)
        world_pt_cam = G.project_cam2world(world_pt, query["cam2world"][:, 0])
        depth_ray = world_pt_cam[:, :, 2]

        T_to_C1 = G.batch_project_to_other_img(
            query["uv"][:, 0], depth_ray, query["intrinsics"][:, 0, :3, :3],
            ctx_intr[:, 0, :3, :3], query_cam2world[:, 0],
        )
        T_to_C2 = G.batch_project_to_other_img(
            query["uv"][:, 0], depth_ray, query["intrinsics"][:, 0, :3, :3],
            ctx_intr[:, 1, :3, :3], query_cam2world[:, 1],
        )
        up_hw = (cfg.mask_upsample, cfg.mask_upsample)
        out["matchability_cycle_mask"] = flow_ops.mask_from_confidence(T_to_C2, mask_bwd, n_rays, upsample_size=up_hw)
        C2_to_C1, mask_c2 = flow_ops.flow2kps_from_upsampled(T_to_C2, state.kps_flow_bwd, n_rays)

        out["T_to_C1_pts"] = T_to_C1
        out["T_to_C2_pts"] = T_to_C2
        out["C2_pts_to_C1"] = C2_to_C1.transpose(1, 2)
        out["mask_c2"] = mask_c2
        out["at_wt"] = at_wt
        out["at_wt_max"] = torch.argmax(at_wt, dim=-1)
        out["depth_ray"] = torch.clamp(depth_ray, 0.0, 10.0)[..., None]
        out["pixel_val"] = torch.cat([st["pixel_val"] for st in stages], dim=-2)
        out["coords"] = coords9
        out["uv"] = query["uv"]
        out["z"] = state.z
        out["rel_pose"] = rel_pose
        out["rel_pose_flip"] = G.pose_inverse_4x4(rel_pose)
        out["gt_rel_pose"] = G.pose_inverse_4x4(ctx_c2w[:, 0]) @ ctx_c2w[:, 1]
        out["gt_rel_pose_flip"] = torch.linalg.inv(G.pose_inverse_4x4(ctx_c2w[:, -1]) @ ctx_c2w[:, 0])
        trace.count("host_syncs")        # linalg.inv checks its result on the host
        return out

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
