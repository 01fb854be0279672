from qwen2_audio_tpu_torch.runtime.context import (  # noqa: F401
    ContextParams,
    FullParams,
    WhisperContext,
    WhisperState,
    context_default_params,
    full_default_params,
)
from qwen2_audio_tpu_torch.runtime.rpc import (  # noqa: F401
    RemoteWhisperContext,
    RpcServer,
)
