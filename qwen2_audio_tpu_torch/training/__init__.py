from qwen2_audio_tpu_torch.training.step import (  # noqa: F401
    TrainState,
    make_train_step,
    init_train_state,
)
