"""ACID (aerial coastline) dataset wrappers with reference defaults
(data/acid_dataio.py: nframe_view=92 at :277, query strictly between contexts
[min+16, max-16] at :298-300, unconditional resize to 455x256); the port's
copy of ``coponerf_tpu/data/acid.py``."""

from __future__ import annotations

from typing import Optional

from coponerf_tpu_torch.data.scene_dataset import SceneDataset, SceneDatasetConfig, VisSceneDataset


def ACID(
    img_root: str,
    pose_root: str,
    num_ctxt_views: int = 2,
    num_query_views: int = 1,
    query_sparsity: Optional[int] = None,
    max_num_scenes: Optional[int] = None,
    augment: bool = True,
    seed: Optional[int] = None,
) -> SceneDataset:
    return SceneDataset(
        SceneDatasetConfig(
            img_root=img_root,
            pose_root=pose_root,
            num_ctxt_views=num_ctxt_views,
            num_query_views=num_query_views,
            query_sparsity=query_sparsity,
            max_num_scenes=max_num_scenes,
            augment=augment,
            nframe_view=92,
            query_mode="inside",
            query_margin=16,
            force_resize=True,
            seed=seed,
        )
    )


def ACIDVis(
    img_root: str,
    pose_root: str,
    overlap: Optional[str] = None,
    n_skip: int = 50,
    num_ctxt_views: int = 2,
    max_num_scenes: Optional[int] = None,
    augment: bool = True,
) -> VisSceneDataset:
    return VisSceneDataset(
        SceneDatasetConfig(
            img_root=img_root,
            pose_root=pose_root,
            num_ctxt_views=num_ctxt_views,
            max_num_scenes=max_num_scenes,
            augment=augment,
            force_resize=True,
            min_frames=20,
        ),
        n_skip=n_skip,
        overlap=overlap,
    )
