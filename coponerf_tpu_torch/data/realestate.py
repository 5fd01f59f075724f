"""RealEstate10K dataset wrappers with reference defaults
(data/realestate10k_dataio.py: nframe_view=50 at :283, query window
[min-32, max+32] at :303-311, 360p resize at :341-342); the port's copy of
``coponerf_tpu/data/realestate.py``."""

from __future__ import annotations

from typing import Optional

from coponerf_tpu_torch.data.scene_dataset import SceneDataset, SceneDatasetConfig, VisSceneDataset


def RealEstate10k(
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
            nframe_view=50,
            query_mode="outside",
            query_margin=32,
            force_resize=False,
            seed=seed,
        )
    )


def RealEstate10kVis(
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
            min_frames=20,
        ),
        n_skip=n_skip,
        overlap=overlap,
    )
