from qwen2_audio_tpu_torch.models.encoder import (  # noqa: F401
    encoder_forward,
    encoder_params_from_ggml,
    random_encoder_params,
)
