"""In-process text generation on the card behind the BaseLLM port (port of
``intool_rag_tpu/providers/tpu_llm.py``): a
:class:`~..models.decoder.DecoderLM` (HF-Llama compatible), prefill and
decode by :func:`~..models.decoder.generate` per bucketed prompt.

Weights:

- ``config`` (and ``params``, a state dict) given: that model; without
  ``params``, random weights from seed 0;
- else ``LLM_MODEL_PATH``: an HF Llama checkpoint in that local directory
  (``config.json``, safetensors or ``pytorch_model*.bin``, and its
  tokenizer; ``transformers`` is imported then, and only then);
- else a small random-weight model with a byte tokenizer, which serves the
  whole path but answers noise.

The JAX provider's continuous batching (``LLM_CONTINUOUS_SLOTS``) and
prompt-lookup speculation (``LLM_SPECULATIVE_GAMMA``) are not ported:
either set above 0 raises ``NotImplementedError``. Sampling draws from a
``torch.Generator`` seeded by a digest of the prompt (the JAX provider
seeds from ``hash(prompt)``, which differs between processes), so sampled
text differs from the JAX provider's; greedy text (temperature 0) does not.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from ..config import get_config
from ..device import resolve_device
from ..llm.base import BaseLLM
from ..models.decoder import (
    DecoderConfig, DecoderLM, cast_params_for_inference, generate, init_decoder_params, load_hf_llama,
)
from .cuda_embed import _bucket

logger = logging.getLogger(__name__)
RANDOM_INIT_SEED = 0  # the generator of the weights used when none are given


class ByteTokenizer:
    """Invertible UTF-8 byte tokenizer: id = byte + 3 (0 = pad, 1 = bos, 2 = eos)."""

    pad_id = 0
    bos_id = 1
    eos_id = 2
    vocab_size = 256 + 3

    def encode(self, text: str) -> list[int]:
        return [self.bos_id] + [b + 3 for b in text.encode("utf-8")]

    def decode(self, ids) -> str:
        # ids above 258 (a model vocabulary larger than the tokenizer's) are dropped
        data = bytes(int(i) - 3 for i in ids if 3 <= int(i) <= 258)
        return data.decode("utf-8", errors="replace")


_BUCKETS = (64, 128, 256, 512, 1024, 2048)  # prompt lengths, each its own prefill shape


def prompt_seed(prompt: str) -> int:
    """The sampling seed of a prompt: stable across processes."""
    return int.from_bytes(hashlib.sha256(prompt.encode("utf-8")).digest()[:4], "little") % 2**31


class CudaLLM(BaseLLM):
    def __init__(
        self,
        config: DecoderConfig | None = None,
        params: dict[str, torch.Tensor] | None = None,
        tokenizer=None,
        *,
        max_new_tokens: int | None = None,
        temperature: float | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        app_cfg = get_config()
        if app_cfg.LLM_CONTINUOUS_SLOTS > 0 or app_cfg.LLM_SPECULATIVE_GAMMA > 0:
            raise NotImplementedError(
                f"LLM_CONTINUOUS_SLOTS={app_cfg.LLM_CONTINUOUS_SLOTS} / LLM_SPECULATIVE_GAMMA="
                f"{app_cfg.LLM_SPECULATIVE_GAMMA}: continuous batching and prompt-lookup speculation "
                "are not ported yet (ROADMAP.md Queue A); set both to 0")
        self.device = resolve_device(device)
        self.temperature = app_cfg.LLM_TEMPERATURE if temperature is None else temperature
        self.max_new_tokens = max_new_tokens or min(app_cfg.LLM_MAX_TOKENS, 256)
        gen = torch.Generator(device=self.device).manual_seed(RANDOM_INIT_SEED)
        if config is not None:
            self.config = config
            state = params if params is not None else init_decoder_params(config, gen, config.torch_dtype)
            self.tokenizer = tokenizer or ByteTokenizer()
        elif app_cfg.LLM_MODEL_PATH:
            self.config, state, self.tokenizer = self._load_hf(app_cfg.LLM_MODEL_PATH)
        else:
            logger.warning("CudaLLM without LLM_MODEL_PATH: a small random-weight model "
                           "(the serving path runs; the answers are noise)")
            self.config = DecoderConfig(
                vocab_size=ByteTokenizer.vocab_size + 1, hidden_size=256, num_layers=4, num_heads=8,
                num_kv_heads=4, intermediate_size=512, max_position=1024, dtype="float32",
            )
            state = init_decoder_params(self.config, gen)
            self.tokenizer = ByteTokenizer()
        # serving reads every weight once a step: one copy in the compute dtype
        self.model = DecoderLM(self.config, device=self.device).eval()
        self.model.load_state_dict(cast_params_for_inference(self.config, state))
        # one generation at a time: the decode loop is paced by the host's
        # launches, and threads launching at once only contend for the GIL
        # (chip_smoke.py phase 8, TinyLlama width on an H100: 8 concurrent
        # generations took 67 s each, one alone 1.6 s)
        self._lock = threading.Lock()

    @staticmethod
    def _load_hf(path: str):
        """An HF Llama checkpoint from a local directory (no network)."""
        p = Path(path)
        hf = json.loads((p / "config.json").read_text())
        config = DecoderConfig(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            intermediate_size=hf["intermediate_size"],
            max_position=min(hf.get("max_position_embeddings", 2048), 4096),
            rope_theta=hf.get("rope_theta", 10_000.0),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        )
        state: dict = {}
        for f in sorted(p.glob("*.safetensors")):
            from safetensors.torch import load_file

            state.update(load_file(f))
        if not state:
            for f in sorted(p.glob("pytorch_model*.bin")):
                state.update(torch.load(f, map_location="cpu", weights_only=True))
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(str(p), local_files_only=True)
        return config, load_hf_llama(config, state), tok

    def _eos_id(self) -> int | None:
        return getattr(self.tokenizer, "eos_id", None) or getattr(self.tokenizer, "eos_token_id", None)

    def _encode_prompt(self, prompt: str) -> tuple[np.ndarray, np.ndarray]:
        """``(ids [1, bucket], mask [1, bucket])`` int32, left-padded; a long
        prompt keeps its tail (a RAG prompt ends with the question)."""
        if hasattr(self.tokenizer, "encode") and not hasattr(self.tokenizer, "eos_token_id"):
            ids = self.tokenizer.encode(prompt)
        else:  # HF tokenizer
            ids = self.tokenizer(prompt)["input_ids"]
        # at most min(position budget, largest bucket) tokens: _bucket caps at
        # its last entry, and a longer prompt would not fit it
        limit = min(self.config.max_position - self.max_new_tokens, _BUCKETS[-1])
        ids = ids[-max(8, limit):]
        bucket = _bucket(len(ids), _BUCKETS)
        pad = bucket - len(ids)
        arr = np.full((1, bucket), getattr(self.tokenizer, "pad_id", 0), np.int32)
        mask = np.zeros((1, bucket), np.int32)
        arr[0, pad:] = ids
        mask[0, pad:] = 1
        return arr, mask

    def generate(self, prompt: str, **kwargs) -> str:
        ids, mask = self._encode_prompt(prompt)
        generator = None
        if self.temperature > 0.0:
            generator = torch.Generator(device=self.device).manual_seed(prompt_seed(prompt))
        with self._lock:
            toks = self._generate_ids(ids, mask, generator)
        eos = self._eos_id()
        out = []
        for t in toks:
            if eos is not None and t == int(eos):
                break
            out.append(t)
        return self.tokenizer.decode(out)

    def _generate_ids(self, ids: np.ndarray, mask: np.ndarray, generator) -> list[int]:
        app_cfg = get_config()
        return generate(
            self.model,
            torch.as_tensor(ids, dtype=torch.long, device=self.device),
            torch.as_tensor(mask, device=self.device),
            # the cache holds max_position slots: the bucket and the new tokens share them
            max_new_tokens=min(self.max_new_tokens, max(1, self.config.max_position - ids.shape[1])),
            temperature=self.temperature,
            eos_id=self._eos_id(),
            pad_id=getattr(self.tokenizer, "pad_id", 0),
            top_k=app_cfg.LLM_TOP_K,
            top_p=app_cfg.LLM_TOP_P,
            generator=generator,
        )[0].tolist()

    def generate_stream(self, prompt: str, **kwargs) -> Iterator[str]:
        text = self.generate(prompt, **kwargs)
        step = 32
        for i in range(0, len(text), step):
            yield text[i : i + step]

    def is_ready(self) -> bool:
        return True

    def get_info(self) -> dict:
        return {
            "provider": "CudaLLM",
            "device": str(self.device),
            "layers": self.config.num_layers,
            "hidden": self.config.hidden_size,
            "max_position": self.config.max_position,
        }
