"""Render a novel-view camera path from one unposed stereo pair: one encode,
then one whole image a pose (``eval/trajectory.py``).

    # a checkpoint (the port's .pt, the JAX package's .npz or the reference's .pth) on a real scene
    python -m coponerf_tpu_torch.render_path --checkpoint model.pth \
        --data_root .../test --pose_root .../test.mat --scene_idx 0 --n_frames 30 --out DIR

    # random weights from a seed on a synthetic scene (a smoke run)
    python -m coponerf_tpu_torch.render_path --seed 0 --image_size 64 --out DIR [--device cpu]

The port's counterpart of ``examples/render_path.py``; ``--seed`` takes the
place of ``--fast_init``.  The run goes on the CUDA device unless
``--device cpu`` is given; without a CUDA device and without that flag it
exits 2.  The fast config (bf16, coarse-to-fine ``--cf``) renders through
the K8a, K2 and K3 kernels; ``--exact`` is the f32 single-stage config.
``--fusion render_core`` (with ``--cf 0,0``) runs K6 in place of K2, the
attention and K3, ``--fusion attn_embed`` K7 for the attention logits.
Writes ``frame_%03d.png`` (a zlib writer: no PIL or imageio needed) and
``path.mp4`` when ``imageio`` imports.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from coponerf_tpu_torch.config import ModelConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="the port's .pt, the JAX package's .npz or the reference's .pth")
    p.add_argument("--seed", type=int, default=None, help="random weights from this seed instead of a checkpoint")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--pose_root", type=str, default=None)
    p.add_argument("--scene_idx", type=int, default=0)
    p.add_argument("--n_frames", type=int, default=30)
    p.add_argument("--image_size", type=int, default=256, help="synthetic scene size (a dataset's is 256)")
    p.add_argument("--chunk", type=int, default=32768)
    p.add_argument("--cf", type=str, default="16,4",
                   help="coarse,fine epipolar samples of the fast config; '0,0' = one uniform stage of 64")
    p.add_argument("--exact", action="store_true", help="the exact f32 config (no bf16, no fast sampling)")
    p.add_argument("--fusion", type=str, default="none", choices=["none", "render_core", "attn_embed"],
                   help="the model's render fusion in the fast config: render_core = K6 (needs --cf 0,0), "
                        "attn_embed = K7 for the attention logits")
    p.add_argument("--circle_radius", type=float, default=None,
                   help="a circular perturbation of the path (test.py:102)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", type=str, required=True)
    return p


def main(argv=None) -> int:
    p = build_parser()
    opt = p.parse_args(argv)
    if (opt.checkpoint is None) == (opt.seed is None):
        p.error("pass exactly one of --checkpoint and --seed")
    from coponerf_tpu_torch.models.coponerf import check_fusion

    cf = tuple(int(x) for x in opt.cf.split(","))
    if opt.exact:
        cfg = ModelConfig()
    else:
        cfg = ModelConfig(fast_sampling=True, compute_dtype="bfloat16", coarse_samples=cf[0], fine_samples=cf[1])
    fusion = None if opt.fusion == "none" else opt.fusion
    try:
        check_fusion(cfg, fusion)
    except ValueError as e:
        p.error(f"--fusion {opt.fusion}: {e}")
    import torch

    if opt.device == "cuda" and not torch.cuda.is_available():
        print("render_path: no CUDA device; pass --device cpu to render on the CPU", file=sys.stderr)
        return 2
    from coponerf_tpu_torch.eval.trajectory import render_trajectory
    from coponerf_tpu_torch.models import CoPoNeRF
    from coponerf_tpu_torch.training.checkpoint import load_weights
    from coponerf_tpu_torch.utils.init import init_weights
    from coponerf_tpu_torch.utils.png import write_png

    if opt.data_root:
        from coponerf_tpu_torch.data.realestate import RealEstate10kVis

        ds = RealEstate10kVis(opt.data_root, opt.pose_root)
        item, _, _ = ds[opt.scene_idx]
        batch = {k: {kk: vv[None] for kk, vv in v.items()} for k, v in item.items()}
        image_size = ds.cfg.image_size
    else:
        from coponerf_tpu_torch.data.synthetic import make_batch

        image_size = opt.image_size
        batch, _ = make_batch(batch_size=1, image_size=image_size, n_rays=16, seed=0)
    model = CoPoNeRF(cfg, image_size=image_size, fusion=fusion).eval()
    if opt.checkpoint:
        load_weights(model, opt.checkpoint, image_size)
        print(f"loaded {opt.checkpoint}")
    else:
        init_weights(model, seed=opt.seed)
        print(f"random weights from seed {opt.seed} (a smoke run)")
    model = model.to(opt.device)

    t0 = time.perf_counter()
    frames = render_trajectory(model, batch, n_frames=opt.n_frames, image_size=image_size,
                               chunk=min(opt.chunk, image_size * image_size), circle_radius=opt.circle_radius)
    dt = time.perf_counter() - t0
    os.makedirs(opt.out, exist_ok=True)
    u8 = np.clip((frames * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    for i, f in enumerate(u8):
        write_png(os.path.join(opt.out, f"frame_{i:03d}.png"), f)
    note = "no mp4: imageio does not import"
    try:
        import imageio
    except ImportError:
        imageio = None
    if imageio is not None:
        try:
            imageio.mimwrite(os.path.join(opt.out, "path.mp4"), u8, fps=10)
            note = "and path.mp4"
        except Exception as e:      # imageio without an mp4 backend
            note = f"no mp4: {type(e).__name__}: {e}"
    print(f"wrote {len(u8)} frames to {opt.out} ({note}); encode + render {dt:.2f} s, "
          f"{dt / len(u8) * 1e3:.1f} ms a frame")
    return 0


if __name__ == "__main__":
    sys.exit(main())
