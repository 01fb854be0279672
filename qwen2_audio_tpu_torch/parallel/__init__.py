from qwen2_audio_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    shard_params,
    decoder_param_spec,
    encoder_param_spec,
    kv_cache_spec,
)
from qwen2_audio_tpu_torch.parallel import distributed  # noqa: F401
