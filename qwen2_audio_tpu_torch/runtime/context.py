"""Public runtime API mirroring the reference's C surface
(include/qwen2-whisper.h:141-527), in PyTorch.

Semantics carried over:
- context (weights) / state (per-run buffers) split with the *_no_state /
  init_state lifecycle (header :147-177)
- whisper_full = pcm -> mel -> offset/duration windowing -> <1 s guard ->
  encode (src/qwen2-whisper.cpp:2341-2383), then, with a Qwen2 decoder
  attached (``ctx.decoder = bundle``), project -> prefill -> greedy decode
  (runtime/decoding.py::run)
- encode works on a 2*n_ctx mel window starting at mel_offset, zero-padded
  past the mel end (:2261-2285)
- accessors, special tokens, segment and token accessors, logits,
  per-phase timings + print/reset (:3435-3551)

Device: ``ContextParams.use_gpu`` (default) runs on ``cuda:{gpu_device}``
and raises if there is no CUDA device; ``use_gpu=False`` runs on the CPU.
On the card the mel frames, the encoder attention, the decoder prefill
attention, the decode-step cache attention and every product with a
quantized weight go through the CUDA kernels (ops/); on the CPU the same
wrappers run their plain versions. Each phase
ends in a device synchronisation so its timing is the device's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from qwen2_audio_tpu_torch.audio.mel import LogMelSpectrogram, mel_input_window
from qwen2_audio_tpu_torch.config import WhisperHParams
from qwen2_audio_tpu_torch.io.ggml_format import GGMLModelFile, read_ggml_file
from qwen2_audio_tpu_torch.models.encoder import (
    Encoder,
    encoder_params_from_ggml,
    fingerprint,
    fuse_encoder_qkv,
)
from qwen2_audio_tpu_torch.ops.mel_kernel import log_mel_spectrogram_fused, mel_tables
from qwen2_audio_tpu_torch.runtime import decoding
from qwen2_audio_tpu_torch.runtime.decoding import DecoderBundle
from qwen2_audio_tpu_torch.runtime.generate import clear_graphs
from qwen2_audio_tpu_torch.tokenizer import WhisperVocab
from qwen2_audio_tpu_torch.utils.logging import log_error, log_warn
from qwen2_audio_tpu_torch.utils.timings import Timings, time_us


@dataclasses.dataclass
class ContextParams:
    """≙ whisper_context_params (header :114-139).

    use_gpu: run on ``cuda:{gpu_device}`` (raises without a CUDA device);
    False runs on the CPU.

    flash_attn: kept for the C API's sake and selects nothing. In the JAX
    package False chose the einsum attention; here encoder attention always
    goes through ops.flash_attention, whose wrapper picks by the tensor's
    device: the CUDA kernel on the card, its plain version on the CPU.

    gelu_approximate: None = the tanh form, which is what the ggml runtime
    computes (ggml_vec_gelu_f32); set True/False to pin either flavour.

    keep_quantized: layer weights stored in a ggml block format stay in
    block form on the device and multiply through the dequantizing kernels
    (ops/quant_matmul.py); False expands them to dense weights at load.
    """

    use_gpu: bool = True
    flash_attn: bool = False
    gpu_device: int = 0
    dtw_token_timestamps: bool = False
    dtw_n_top: int = -1
    compute_dtype: torch.dtype = torch.float32
    gelu_approximate: bool | None = None
    keep_quantized: bool = True


@dataclasses.dataclass
class FullParams:
    """≙ whisper_full_params (header :359-437), defaults from
    whisper_full_default_params (src/qwen2-whisper.cpp:4231-4294). The
    decoding fields are read when a decoder is attached
    (runtime/decoding.py::run); detect_language and translate are refused
    there, as the Qwen2 vocabulary has no whisper language or task tokens."""

    n_threads: int = 4
    n_max_text_ctx: int = 16384
    offset_ms: int = 0
    duration_ms: int = 0

    translate: bool = False
    no_context: bool = True
    no_timestamps: bool = False
    single_segment: bool = False
    print_special: bool = False
    print_progress: bool = True
    print_realtime: bool = False
    print_timestamps: bool = True

    token_timestamps: bool = False
    thold_pt: float = 0.01
    thold_ptsum: float = 0.01
    max_len: int = 0
    split_on_word: bool = False
    max_tokens: int = 0

    debug_mode: bool = False
    audio_ctx: int = 0

    tdrz_enable: bool = False
    suppress_regex: str | None = None
    initial_prompt: str | None = None
    prompt_tokens: list[int] | None = None

    language: str | None = "en"
    detect_language: bool = False

    suppress_blank: bool = True
    suppress_non_speech_tokens: bool = False

    temperature: float = 0.0
    max_initial_ts: float = 1.0
    length_penalty: float = -1.0

    temperature_inc: float = 0.2
    entropy_thold: float = 2.4
    # zlib compression ratio of the decoded text above which the decode is
    # degenerate and the temperature fallback fires (OpenAI whisper's
    # compression_ratio_threshold)
    compression_ratio_thold: float = 2.4
    logprob_thold: float = -1.0
    no_speech_thold: float = 0.6

    strategy: str = "greedy"     # "greedy" | "beam"
    beam_size: int = 5
    best_of: int = 5
    max_new_tokens: int = 128
    repetition_penalty: float = 1.0
    # n-gram speculative decoding: K drafts verified a forward (exact greedy
    # output); in whisper_full (B = 1) -1 (auto) and 0 are plain greedy, as
    # the port takes no hardware markers to turn it on; in the serving slot
    # pool (runtime/serving.py) auto is 7 and adaptive on the CPU, 0 on the
    # card
    speculative_k: int = -1

    new_segment_callback: Callable | None = None
    progress_callback: Callable | None = None
    encoder_begin_callback: Callable | None = None
    abort_callback: Callable | None = None


def context_default_params() -> ContextParams:
    return ContextParams()


def full_default_params(strategy: str = "greedy") -> FullParams:
    return FullParams(strategy=strategy)


def context_device(cparams: ContextParams) -> torch.device:
    """The device a context runs on; raises when the card is asked for and
    there is none."""
    if not cparams.use_gpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("use_gpu=True but no CUDA device is available; "
                           "pass ContextParams(use_gpu=False) to run on the CPU")
    if cparams.gpu_device >= torch.cuda.device_count():
        raise RuntimeError(f"gpu_device {cparams.gpu_device} out of range "
                           f"({torch.cuda.device_count()} CUDA devices)")
    return torch.device("cuda", cparams.gpu_device)


class WhisperState:
    """≙ whisper_state (src/qwen2-whisper.cpp:795-881): per-run mel, encoder
    output, logits, segments, timings."""

    def __init__(self) -> None:
        self.mel: LogMelSpectrogram | None = None
        self.embd_enc: torch.Tensor | None = None   # (n_ctx//2, n_state) on the device
        self.logits: np.ndarray | None = None       # (B, V) of the last decoded position
        self.timings = Timings()
        self.exp_n_audio_ctx = 0
        self.lang_id = 0
        self.no_speech_prob = 0.0
        self.segments: list[dict] = []
        self.result_tokens: list[int] = []
        # single-position decoder forwards run by the decode loops, summed
        self.n_decode_forwards = 0


class WhisperContext:
    """≙ whisper_context + the C init/accessor API (encode path)."""

    def __init__(self, model_file: GGMLModelFile, cparams: ContextParams,
                 with_state: bool = True) -> None:
        t0 = time_us()
        if cparams.gelu_approximate is None:
            cparams = dataclasses.replace(cparams, gelu_approximate=True)
        self.params = cparams
        self.device = context_device(cparams)
        self.hparams: WhisperHParams = model_file.hparams
        self.filters = model_file.filters
        self.vocab = WhisperVocab.from_token_list(
            model_file.vocab, model_file.hparams.n_vocab)
        params = encoder_params_from_ggml(
            model_file, dtype=cparams.compute_dtype, device=self.device,
            keep_quantized=cparams.keep_quantized)
        # fused QKV is a runtime layout: one (d, 3d) matmul, and the
        # attention kernel reads its heads from that output by stride
        self.encoder = Encoder(
            fuse_encoder_qkv(params), self.hparams,
            gelu_approximate=cparams.gelu_approximate,
            compute_dtype=cparams.compute_dtype)
        self.mel_tables = mel_tables(self.filters, self.device)
        self._decoder: DecoderBundle | None = None
        self.state: WhisperState | None = None
        self._sync()
        self.t_load_us = time_us() - t0
        if with_state:
            self.state = self.init_state()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- lifecycle (header :141-177) ----

    @classmethod
    def init_from_file_with_params(cls, path: str,
                                   cparams: ContextParams | None = None
                                   ) -> "WhisperContext":
        return cls(read_ggml_file(path), cparams or ContextParams())

    @classmethod
    def init_from_buffer_with_params(cls, buf: bytes,
                                     cparams: ContextParams | None = None
                                     ) -> "WhisperContext":
        return cls(read_ggml_file(buf), cparams or ContextParams())

    @classmethod
    def init_from_file_with_params_no_state(cls, path: str,
                                            cparams: ContextParams | None = None
                                            ) -> "WhisperContext":
        return cls(read_ggml_file(path), cparams or ContextParams(),
                   with_state=False)

    @classmethod
    def init_from_buffer_with_params_no_state(
            cls, buf: bytes, cparams: ContextParams | None = None
    ) -> "WhisperContext":
        return cls(read_ggml_file(buf), cparams or ContextParams(),
                   with_state=False)

    @classmethod
    def init_with_params(cls, loader, cparams: ContextParams | None = None,
                         with_state: bool = True) -> "WhisperContext":
        """whisper_model_loader vtable form (header :128-136): an object
        with read(n)->bytes / eof()->bool / close() callbacks, drained once
        and parsed from memory."""
        chunks = []
        while not loader.eof():
            chunk = loader.read(1 << 20)
            if not chunk:
                break
            chunks.append(chunk)
        loader.close()
        return cls(read_ggml_file(b"".join(chunks)),
                   cparams or ContextParams(), with_state=with_state)

    def init_state(self) -> WhisperState:
        st = WhisperState()
        st.timings.t_start_us = time_us()
        st.timings.t_load_us = self.t_load_us
        if self.state is None:
            self.state = st
        return st

    @property
    def decoder(self) -> DecoderBundle | None:
        """The attached Qwen2 decoder (runtime/decoding.py::DecoderBundle);
        with one, ``full`` goes on from encode to text."""
        return self._decoder

    @decoder.setter
    def decoder(self, bundle: DecoderBundle | None) -> None:
        """Attach (or, with None, detach) a decoder; its weights move to the
        context's device."""
        if bundle is not None and not isinstance(bundle, DecoderBundle):
            raise TypeError(f"decoder must be a DecoderBundle, got {type(bundle).__name__}")
        clear_graphs()   # the decode steps captured over the weights it replaces
        self._decoder = None if bundle is None else bundle.to(self.device)

    def free(self) -> None:
        clear_graphs()
        self.encoder = None
        self._decoder = None
        self.state = None

    # ---- mel (header :208-240) ----

    def pcm_to_mel_with_state(self, state: WhisperState, samples: np.ndarray,
                              n_threads: int = 4) -> int:
        """≙ whisper_pcm_to_mel_with_state. n_threads has no role here: the
        frames are computed on the context's device in one launch."""
        t0 = time_us()
        state.mel = log_mel_spectrogram_fused(samples, self.filters,
                                              tables=self.mel_tables)
        self._sync()
        state.timings.t_mel_us += time_us() - t0
        return 0

    def pcm_to_mel(self, samples: np.ndarray, n_threads: int = 4) -> int:
        return self.pcm_to_mel_with_state(self.state, samples, n_threads)

    def set_mel_with_state(self, state: WhisperState, data) -> int:
        """≙ whisper_set_mel_with_state (:3287-3309): n_mel must match."""
        data = torch.as_tensor(np.asarray(data, dtype=np.float32))
        if data.dim() != 2 or data.shape[0] != self.hparams.n_mels:
            log_error("set_mel: invalid number of mel bands: %d (expected %d)\n",
                      data.shape[0] if data.dim() == 2 else -1,
                      self.hparams.n_mels)
            return -1
        state.mel = LogMelSpectrogram(data=data.to(self.device),
                                      n_len_org=data.shape[1])
        return 0

    def set_mel(self, data) -> int:
        return self.set_mel_with_state(self.state, data)

    # ---- encode (header :242-258) ----

    def encode_with_state(self, state: WhisperState, offset: int,
                          audio_ctx: int = 0,
                          abort_callback: Callable | None = None) -> int:
        """Run the encoder on the mel window starting at ``offset`` frames
        (≙ whisper_encode_with_state / whisper_encode_qwen2_internal)."""
        if state.mel is None:
            log_error("encode: no mel spectrogram (call pcm_to_mel first)\n")
            return -1
        n_ctx = audio_ctx or self.hparams.n_audio_ctx
        if n_ctx > self.hparams.n_audio_ctx:
            log_error("encode: audio_ctx %d > model n_audio_ctx %d\n",
                      n_ctx, self.hparams.n_audio_ctx)
            return -2
        t0 = time_us()
        win = mel_input_window(state.mel, offset, n_ctx).to(self.device)
        state.embd_enc = self.encoder(win[None])[0]
        self._sync()
        state.timings.t_encode_us += time_us() - t0
        state.timings.n_encode += 1
        if abort_callback is not None and abort_callback():
            return -3
        return 0

    def encode(self, offset: int, audio_ctx: int = 0) -> int:
        return self.encode_with_state(self.state, offset, audio_ctx)

    # ---- full (header :448-471) ----

    def full_with_state(self, state: WhisperState, params: FullParams,
                        samples: np.ndarray | None) -> int:
        """≙ whisper_full_with_state -> whisper_encoder_output_with_state
        (src/qwen2-whisper.cpp:2341-2383): mel, seek window, <1 s guard,
        encode; then decode when a Qwen2 decoder is attached."""
        if samples is not None and len(samples) > 0:
            if self.pcm_to_mel_with_state(state, samples,
                                          params.n_threads) != 0:
                log_error("full: failed to compute log mel spectrogram\n")
                return -2

        seek_start = params.offset_ms // 10
        n_len = state.mel.n_len_org if state.mel is not None else 0
        seek_end = (n_len if params.duration_ms == 0
                    else seek_start + params.duration_ms // 10)

        if seek_end < seek_start + 100:
            log_warn("full: input is too short - %d ms < 1000 ms. "
                     "consider padding the input audio with silence\n",
                     (seek_end - seek_start) * 10)
            return 0

        if (params.encoder_begin_callback is not None
                and not params.encoder_begin_callback(self, state)):
            return -4

        rc = self.encode_with_state(state, seek_start, params.audio_ctx,
                                    params.abort_callback)
        if rc != 0:
            log_error("full: failed to encode\n")
            return -1

        if self._decoder is not None:
            return decoding.run(self, state, params)
        return 0

    def full(self, params: FullParams, samples: np.ndarray | None) -> int:
        return self.full_with_state(self.state, params, samples)

    def full_parallel(self, params: FullParams, samples: np.ndarray,
                      n_processors: int) -> int:
        """≙ whisper_full_parallel (header :464-469): the batch axis does
        the work of the n processors. Without a decoder the audio is split
        into ``n_processors`` chunks, whose first windows go through one
        captured encode at B = n_processors, and state.embd_enc holds the
        chunks' embeddings one after the other. With a decoder the audio's
        30 s windows are encoded and decoded in batches of n_processors
        (runtime/serving.py::transcribe_long_form), one segment each."""
        if n_processors <= 1:
            return self.full(params, samples)
        if self._decoder is None:
            wins = []
            for chunk in np.array_split(np.asarray(samples, np.float32), n_processors):
                st = WhisperState()
                if self.pcm_to_mel_with_state(st, chunk) != 0:
                    return -2
                wins.append(mel_input_window(st.mel, 0, self.hparams.n_audio_ctx))
            t0 = time_us()
            out = self.encoder(torch.stack(wins).to(self.device))
            self.state.embd_enc = out.reshape(-1, out.shape[-1])
            self._sync()
            self.state.timings.t_encode_us += time_us() - t0
            self.state.timings.n_encode += n_processors
            return 0
        from qwen2_audio_tpu_torch.runtime.serving import transcribe_long_form
        state = self.state
        try:
            for _ in transcribe_long_form(self, samples, params, batch_size=n_processors):
                pass   # the generator writes the segments and runs the callbacks
        except RuntimeError as e:
            log_error("full_parallel: %s\n", str(e))
            return -2
        state.result_tokens = [t for seg in state.segments for t in seg["tokens"]]
        return 0

    # ---- accessors (header :296-357) ----

    def n_len(self) -> int:
        return self.state.mel.n_len_org if self.state and self.state.mel else 0

    def n_vocab(self) -> int:
        return self.hparams.n_vocab

    def n_text_ctx(self) -> int:
        return self.hparams.n_text_ctx

    def n_audio_ctx(self) -> int:
        return self.hparams.n_audio_ctx

    def is_multilingual(self) -> bool:
        return self.vocab.is_multilingual

    def model_n_mels(self) -> int:
        return self.hparams.n_mels

    def model_ftype(self) -> int:
        return self.hparams.ftype

    def model_type_readable(self) -> str:
        return self.hparams.model_type

    def get_logits(self) -> np.ndarray | None:
        return self.state.logits if self.state else None

    def token_to_str(self, token_id: int) -> str:
        return self.vocab.token_to_str(token_id)

    def tokenize(self, text: str) -> list[int]:
        return self.vocab.tokenize(text)

    def token_count(self, text: str) -> int:
        return len(self.tokenize(text))

    # special tokens (header :325-341)
    def token_eot(self) -> int: return self.vocab.token_eot
    def token_sot(self) -> int: return self.vocab.token_sot
    def token_solm(self) -> int: return self.vocab.token_solm
    def token_prev(self) -> int: return self.vocab.token_prev
    def token_nosp(self) -> int: return self.vocab.token_nosp
    def token_not(self) -> int: return self.vocab.token_not
    def token_beg(self) -> int: return self.vocab.token_beg
    def token_lang(self, lang_id_: int) -> int: return self.vocab.token_lang(lang_id_)
    def token_translate(self) -> int: return self.vocab.token_translate
    def token_transcribe(self) -> int: return self.vocab.token_transcribe

    # ---- timings / debug (header :343-349, :522-527) ----

    def print_timings(self) -> None:
        if self.state:
            self.state.timings.print()

    def reset_timings(self) -> None:
        if self.state:
            self.state.timings.reset()

    def print_emb_enc(self) -> str:
        """≙ whisper_print_emb_enc (src/qwen2-whisper.cpp:4191-4203)."""
        fp = fingerprint(self.state.embd_enc)
        print(fp, flush=True)
        return fp

    # ---- segment accessors (header :472-515); populated by decoding ----

    def full_n_segments(self) -> int:
        return len(self.state.segments)

    def full_lang_id(self) -> int:
        return self.state.lang_id

    def full_get_segment_text(self, i: int) -> str:
        return self.state.segments[i]["text"]

    def full_get_segment_t0(self, i: int) -> int:
        return self.state.segments[i]["t0"]

    def full_get_segment_t1(self, i: int) -> int:
        return self.state.segments[i]["t1"]

    def full_n_tokens(self, i: int) -> int:
        return len(self.state.segments[i]["tokens"])

    def full_get_token_id(self, i: int, j: int) -> int:
        return self.state.segments[i]["tokens"][j]

    def full_get_token_text(self, i: int, j: int) -> str:
        return self.token_to_str(self.state.segments[i]["tokens"][j])

    def full_get_token_p(self, i: int, j: int) -> float:
        return self.state.segments[i]["probs"][j]


def print_system_info() -> str:
    """≙ whisper_print_system_info (:3573-3596): torch and its CUDA version,
    the device the contexts default to (the card's name, or ``cpu`` without
    one) and the directory the CUDA kernels build into."""
    from qwen2_audio_tpu_torch.ops._build import build_dir
    dev = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    return (f"torch {torch.__version__} | CUDA {torch.version.cuda or 'none'} | "
            f"device {dev} | kernels built in {build_dir()}")
