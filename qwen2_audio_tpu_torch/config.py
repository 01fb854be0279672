"""Model hyper-parameters and ggml type enums.

Mirrors the reference's hparams block (reference: src/qwen2-whisper.cpp:567-580,
loader :1374-1439) and the ggml type/ftype enums (reference: ggml/include/ggml.h:357-437)
— only the formats the framework actually supports are carried over.
"""

from __future__ import annotations

import dataclasses
import enum

WHISPER_SAMPLE_RATE = 16000
WHISPER_N_FFT = 400
WHISPER_HOP_LENGTH = 160
WHISPER_CHUNK_SIZE = 30  # seconds

GGML_FILE_MAGIC = 0x67676D6C  # "ggml"
GGML_QNT_VERSION = 2
GGML_QNT_VERSION_FACTOR = 1000


class GGMLType(enum.IntEnum):
    """Per-tensor storage types (subset of ggml_type, ggml/include/ggml.h:357-393)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    BF16 = 30


class GGMLFType(enum.IntEnum):
    """File-level ftype (subset of ggml_ftype, ggml/include/ggml.h:418-437)."""

    ALL_F32 = 0
    MOSTLY_F16 = 1
    MOSTLY_Q4_0 = 2
    MOSTLY_Q4_1 = 3
    MOSTLY_Q8_0 = 7
    MOSTLY_Q5_0 = 8
    MOSTLY_Q5_1 = 9
    MOSTLY_Q2_K = 10
    MOSTLY_Q3_K = 11
    MOSTLY_Q4_K = 12
    MOSTLY_Q5_K = 13
    MOSTLY_Q6_K = 14
    MOSTLY_BF16 = 24


FTYPE_TO_TYPE = {
    GGMLFType.ALL_F32: GGMLType.F32,
    GGMLFType.MOSTLY_F16: GGMLType.F16,
    GGMLFType.MOSTLY_Q4_0: GGMLType.Q4_0,
    GGMLFType.MOSTLY_Q4_1: GGMLType.Q4_1,
    GGMLFType.MOSTLY_Q8_0: GGMLType.Q8_0,
    GGMLFType.MOSTLY_Q5_0: GGMLType.Q5_0,
    GGMLFType.MOSTLY_Q5_1: GGMLType.Q5_1,
    GGMLFType.MOSTLY_Q2_K: GGMLType.Q2_K,
    GGMLFType.MOSTLY_Q3_K: GGMLType.Q3_K,
    GGMLFType.MOSTLY_Q4_K: GGMLType.Q4_K,
    GGMLFType.MOSTLY_Q5_K: GGMLType.Q5_K,
    GGMLFType.MOSTLY_Q6_K: GGMLType.Q6_K,
    GGMLFType.MOSTLY_BF16: GGMLType.BF16,
}


@dataclasses.dataclass(frozen=True)
class WhisperHParams:
    """The 11 integers of the ggml-model.bin header (src/qwen2-whisper.cpp:567-580).

    Defaults are Whisper tiny; Qwen2-Audio's tower is the large-v3 geometry
    (n_audio_state=1280, n_audio_head=20, n_audio_layer=32, n_mels=128).
    """

    n_vocab: int = 51864
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    n_mels: int = 80
    ftype: int = 1
    eps: float = 1e-5

    @property
    def d_head(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def model_type(self) -> str:
        # reference: src/qwen2-whisper.cpp:1389-1411
        by_layers = {4: "tiny", 6: "base", 12: "small", 24: "medium", 32: "large"}
        name = by_layers.get(self.n_audio_layer, "unknown")
        if name == "large" and self.n_vocab == 51866:
            name = "large v3"
        return name

    @property
    def is_multilingual(self) -> bool:
        # reference: whisper_vocab::is_multilingual — n_vocab >= 51865
        return self.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        return self.n_vocab - 51765 - (1 if self.is_multilingual else 0)


# Canonical encoder geometries by family name.
WHISPER_PRESETS = {
    "tiny": WhisperHParams(),
    "base": WhisperHParams(n_audio_state=512, n_audio_head=8, n_audio_layer=6,
                           n_text_state=512, n_text_head=8, n_text_layer=6),
    "small": WhisperHParams(n_audio_state=768, n_audio_head=12, n_audio_layer=12,
                            n_text_state=768, n_text_head=12, n_text_layer=12),
    "medium": WhisperHParams(n_audio_state=1024, n_audio_head=16, n_audio_layer=24,
                             n_text_state=1024, n_text_head=16, n_text_layer=24),
    "large": WhisperHParams(n_vocab=51866, n_audio_state=1280, n_audio_head=20,
                            n_audio_layer=32, n_text_state=1280, n_text_head=20,
                            n_text_layer=32, n_mels=128),
    # Qwen2-Audio audio tower: large-v3 geometry, output avg-pooled 1500 -> 750.
    "qwen2-audio": WhisperHParams(n_vocab=51866, n_audio_state=1280, n_audio_head=20,
                                  n_audio_layer=32, n_text_state=1280, n_text_head=20,
                                  n_text_layer=32, n_mels=128),
}


@dataclasses.dataclass(frozen=True)
class Qwen2DecoderConfig:
    """Qwen2 LM decoder config. Defaults are Qwen2-Audio-7B's text tower;
    tests use tiny overrides."""

    vocab_size: int = 156032
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    head_dim: int = 128
    max_position_embeddings: int = 8192
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    # id of the token whose embeddings get replaced by audio encoder output
    audio_token_id: int = 151646

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads


@dataclasses.dataclass(frozen=True)
class Qwen2AudioConfig:
    """Full multimodal model: encoder tower + projector + Qwen2 LM."""

    audio: WhisperHParams = dataclasses.field(
        default_factory=lambda: WHISPER_PRESETS["qwen2-audio"])
    text: Qwen2DecoderConfig = dataclasses.field(default_factory=Qwen2DecoderConfig)
