from coponerf_tpu_torch.models.coponerf import CoPoNeRF, SceneState, batch_to_torch
