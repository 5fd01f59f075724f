"""Evaluation entry point of the port.

    python -m coponerf_tpu_torch.test --checkpoint_path X.pt|X.npz|X.pth --data_root ... --pose_root ... \
        [--overlap assets/overlap/realestate.npy] [--n_skip 50] [--fast [--fusion render_core]] [--device cpu]

The flags are those of the JAX package's ``test.py`` plus ``--device``: the
run goes on the CUDA device unless ``--device cpu`` is given, and without a
CUDA device and without that flag it exits 2.  It runs the chunked
dual-hypothesis eval protocol (``eval/harness.py``) and prints PSNR, SSIM,
LPIPS (with ``--lpips_weights``, an ``.npz`` of ``eval/lpips.py``'s layout)
and the pose errors binned by overlap {small<0.5, 0.5<=medium<=0.75,
large>0.75}.  ``--fusion`` builds the model with a render fusion
(``models/coponerf.py``): ``render_core`` runs K6 for everything between the
fast config's 64 samples a ray and the decoder, ``attn_embed`` K7 for the
attention logits; both need ``--fast``.  The checkpoint is one written by
the port (``training/checkpoint.py``, ``.pt``), one of the JAX package (``.npz``,
``utils/jax_checkpoint.py``) or the reference's released weights (``.pth``,
imported by ``utils/torch_import.py``).  Image panels and pose
scalars go to ``<logging_root>/<experiment_name>/summaries``
(``metrics.jsonl``, and TensorBoard where it imports).
"""

from __future__ import annotations

import argparse
import os
import sys

from coponerf_tpu_torch.config import ModelConfig
from coponerf_tpu_torch.utils.cli import parse_with_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--logging_root", type=str, default="logs")
    p.add_argument("--experiment_name", type=str, default="eval")
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--pose_root", type=str, required=True)
    p.add_argument("--overlap", type=str, default=None)
    p.add_argument("--dataset", type=str, default="realestate10k", choices=["realestate10k", "acid"])
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--views", type=int, default=2)
    p.add_argument("--n_skip", type=int, default=50)
    p.add_argument("--checkpoint_path", default=None,
                   help="a checkpoint of the port (.pt), of the JAX package (.npz) or the reference's weights "
                        "(.pth)")
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--chunk", type=int, default=4096)
    p.add_argument("--lpips_weights", type=str, default=None)
    p.add_argument("--allow_missing_lpips", action="store_true", default=False,
                   help="run without LPIPS (NOT the full reference protocol)")
    p.add_argument("--fast", action="store_true", default=False,
                   help="throughput config: bf16, every latent level sampled by the K8a kernel")
    p.add_argument("--fusion", type=str, default="none", choices=["none", "render_core", "attn_embed"],
                   help="the model's render fusion (needs --fast): render_core = K6 between sampling and the "
                        "decoder, attn_embed = K7 for the attention logits")
    p.add_argument("--prune_invalid", action="store_true", default=False,
                   help="skip ray chunks outside the epipolar valid mask (the reference renders them and "
                        "overwrites white); rgb is identical, aux outputs zero-fill pruned rays")
    p.add_argument("--num_workers", type=int, default=0,
                   help="scene-decode worker processes (0 = in-thread, the reference's num_workers=0 at "
                        "eval, test.py:130; >0 overlaps decode with the render, same results)")
    p.add_argument("--include_tail", action="store_true", default=False,
                   help="evaluate the n %% batch_size tail scenes too (deviation: the reference "
                        "DataLoader drops them, drop_last=True, test.py:130)")
    return p


def main(argv=None) -> int:
    p = build_parser()
    opt = parse_with_config(p, argv)
    from coponerf_tpu_torch.models.coponerf import check_fusion

    cfg = ModelConfig(
        n_view=opt.views,
        fast_sampling=opt.fast,
        compute_dtype="bfloat16" if opt.fast else "float32",
    )
    fusion = None if opt.fusion == "none" else opt.fusion
    try:
        check_fusion(cfg, fusion)
    except ValueError as e:
        p.error(f"--fusion {opt.fusion}: {e}")
    if opt.lpips_weights is None and not opt.allow_missing_lpips:
        # the reference protocol always reports LPIPS (test.py:258-263):
        # refuse rather than print a partial table
        raise SystemExit("--lpips_weights is required for the full reference eval protocol. Pass "
                         "--allow_missing_lpips to run without the LPIPS column.")
    if not opt.checkpoint_path:
        raise SystemExit("--checkpoint_path is required for evaluation")
    import torch

    if opt.device == "cuda" and not torch.cuda.is_available():
        print("test: no CUDA device; pass --device cpu to evaluate on the CPU", file=sys.stderr)
        return 2
    from coponerf_tpu_torch.eval.harness import evaluate
    from coponerf_tpu_torch.models import CoPoNeRF
    from coponerf_tpu_torch.training.checkpoint import load_weights
    from coponerf_tpu_torch.training.trainer import MetricLogger

    if opt.dataset == "acid":
        from coponerf_tpu_torch.data.acid import ACIDVis as Vis
    else:
        from coponerf_tpu_torch.data.realestate import RealEstate10kVis as Vis

    dataset = Vis(opt.data_root, opt.pose_root, overlap=opt.overlap, n_skip=opt.n_skip,
                  num_ctxt_views=opt.views)
    image_size = dataset.cfg.image_size
    model = CoPoNeRF(cfg, image_size=image_size, fusion=fusion).eval().to(opt.device)
    load_weights(model, opt.checkpoint_path, image_size)
    logger = MetricLogger(os.path.join(opt.logging_root, opt.experiment_name, "summaries"))
    try:
        acc = evaluate(
            model, dataset, batch_size=opt.batch_size, chunk=opt.chunk, max_batches=opt.max_batches,
            lpips_weights=opt.lpips_weights, image_size=image_size, prune_invalid=opt.prune_invalid,
            drop_last=not opt.include_tail, num_workers=opt.num_workers, logger=logger,
        )
    finally:
        logger.close()
    print(acc.format())
    return 0


if __name__ == "__main__":
    sys.exit(main())
