from portbench.reference.models.coponerf import CoPoNeRF, SceneState, batch_to_torch
