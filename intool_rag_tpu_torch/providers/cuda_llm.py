"""In-process text generation on the card behind the BaseLLM port (port of
``intool_rag_tpu/providers/tpu_llm.py``): a
:class:`~..models.decoder.DecoderLM` (HF-Llama compatible), prefill and
decode by :func:`~..models.decoder.generate` per bucketed prompt.

Weights:

- ``config`` (and ``params``, a state dict) given: that model; without
  ``params``, random weights from ``seed`` (default 0);
- else ``LLM_MODEL_PATH``: an HF checkpoint in that local directory
  (``config.json``, safetensors or ``pytorch_model*.bin``, and its
  tokenizer; ``transformers`` is imported then, and only then), chosen by
  its ``model_type``: ``llama`` (the Llama decoder) or ``deepseek_v2``
  (``models/deepseek_v2.py``: latent attention, experts, YaRN; its
  configuration's default cache positions and its ``prompt_buckets``); any
  other type is refused by name;
- else a small random-weight model with a byte tokenizer, which serves the
  whole path but answers noise.

Three ways to generate, as in the JAX provider:

- ``LLM_CONTINUOUS_SLOTS`` > 0: a wave server (:class:`_WaveServer`) over
  ``models/scheduler.py``'s :class:`ContinuousGenerator`; concurrent calls
  share one decode stream of that many slots, and with
  ``LLM_SPECULATIVE_GAMMA`` > 1 and temperature 0 each step is a batched
  prompt-lookup wave;
- else ``LLM_SPECULATIVE_GAMMA`` > 0 at temperature 0: one stream through
  :func:`~..models.decoder.generate_lookup_speculative`;
- else :func:`~..models.decoder.generate`, one call at a time.

Sampling draws from a ``torch.Generator`` seeded by a digest of the prompt
(the JAX provider seeds from ``hash(prompt)``, which differs between
processes; the wave server seeds each wave with 0, as the JAX one does), so
sampled text differs from the JAX provider's; greedy text (temperature 0)
does not.
"""

from __future__ import annotations

import hashlib
import json
import queue
import threading
import time
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from ..logging import get_logger
from ..config import get_config
from ..device import resolve_device
from ..llm.base import BaseLLM
from ..models.decoder import (
    DecoderConfig, DecoderLM, cast_params_for_inference, generate, generate_lookup_speculative, init_decoder_params,
    load_hf_llama,
)
from ..models.deepseek_v2 import DeepseekV2Config, DeepseekV2LM, load_hf_deepseek_v2
from ..observability import device_work, get_metrics
from .cuda_embed import _bucket

logger = get_logger(__name__)
RANDOM_INIT_SEED = 0  # the generator of the weights used when none are given
WAVE_GATHER_S = 0.010  # how long a wave waits for requests to join it
_STOP = object()


class _WaveServer:
    """Serves concurrent ``generate`` calls in waves through one
    :class:`~..models.scheduler.ContinuousGenerator`.

    Handler threads only enqueue (token ids, budget) and wait; one worker
    thread owns every launch on the card (threads launching at once contend
    for the host). The worker gathers a wave for ``WAVE_GATHER_S`` and runs
    ``generate_many`` over it; within a wave the scheduler refills freed
    slots, and requests that come mid-wave start with the next one. A
    wave's failure goes to every waiter in it; a waiter wakes every 5 s to
    fail fast if the worker died. Counters and latencies go to the
    process-global metrics (``GET /metrics`` under ``process``)."""

    def __init__(self, gen) -> None:
        self.gen = gen
        self.q: queue.Queue = queue.Queue()
        self._dead: BaseException | None = None
        self._worker = threading.Thread(target=self._loop, name="llm-wave-server", daemon=True)
        self._worker.start()

    def submit(self, ids: list[int], max_new: int) -> list[int]:
        if self._dead is not None:
            raise RuntimeError("LLM wave server is dead") from self._dead
        done = threading.Event()
        box: dict = {}
        self.q.put((ids, max_new, done, box))
        # a liveness watchdog, not a latency bound: a bare wait would hang
        # this thread forever if the worker died
        while not done.wait(timeout=5.0):
            if self._dead is not None:
                raise RuntimeError("LLM wave server died") from self._dead
        if "error" in box:
            raise box["error"]
        return box["toks"]

    def close(self) -> None:
        """Stop the worker after the wave it runs (its model can then be freed)."""
        self.q.put(_STOP)
        self._worker.join()

    def _loop(self) -> None:
        try:
            while True:
                item = self.q.get()
                if item is _STOP:
                    return
                wave = [item]
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < WAVE_GATHER_S:
                    try:
                        item = self.q.get_nowait()
                    except queue.Empty:
                        time.sleep(0.002)
                        continue
                    if item is _STOP:  # serve what was gathered, then stop
                        self.q.put(_STOP)
                        break
                    wave.append(item)
                m = get_metrics()
                m.inc("llm_waves")
                m.inc("llm_wave_requests", len(wave))
                t_wave = time.perf_counter()
                try:
                    # its waiters hold the device gate: enter even while a trace waits for it
                    with device_work(urgent=True):
                        results, stats = self.gen.generate_many([w[0] for w in wave], [w[1] for w in wave])
                except Exception as exc:  # to every waiter of the wave
                    m.inc("llm_wave_errors")
                    for _, _, done, box in wave:
                        box["error"] = exc
                        done.set()
                    continue
                m.observe("llm.wave", time.perf_counter() - t_wave)
                m.inc("llm_wave_tokens", int(stats.get("total_tokens", 0)))
                m.inc("llm_compactions", int(stats.get("compactions", 0)))
                if "tokens_per_wave" in stats:
                    # mean tokens a speculative wave emitted (1.0 = every draft rejected)
                    m.observe("llm.accepted_per_wave", stats["tokens_per_wave"])
                for (_, _, done, box), toks in zip(wave, results):
                    box["toks"] = toks
                    done.set()
        except BaseException as exc:  # the worker died: every later submit fails fast
            self._dead = exc
            raise


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


_BUCKETS = (64, 128, 256, 512, 1024, 2048)  # prompt lengths, each its own prefill shape; a config's prompt_buckets


def prompt_seed(prompt: str) -> int:
    """The sampling seed of a prompt: stable across processes."""
    return int.from_bytes(hashlib.sha256(prompt.encode("utf-8")).digest()[:4], "little") % 2**31


def _build_model(config, state: dict | None, device, seed: int) -> torch.nn.Module:
    """The decoder of ``config`` with ``state``, or seeded random weights
    where it is None. Serving reads every weight once a step: one copy in
    the compute dtype (a DeepSeek-V2 model draws its weights in place)."""
    if isinstance(config, DeepseekV2Config):
        model = DeepseekV2LM(config, device=device).eval()
        if state is None:
            return model.init_random(seed)
        model.load_state_dict(state)
        return model
    if state is None:
        state = init_decoder_params(config, torch.Generator(device=device).manual_seed(seed), config.torch_dtype)
    model = DecoderLM(config, device=device).eval()
    model.load_state_dict(cast_params_for_inference(config, state))
    return model


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
        seed: int = RANDOM_INIT_SEED,
    ) -> None:
        app_cfg = get_config()
        self.device = resolve_device(device)
        self.temperature = app_cfg.LLM_TEMPERATURE if temperature is None else temperature
        self.max_new_tokens = max_new_tokens or min(app_cfg.LLM_MAX_TOKENS, 256)
        if config is not None:
            self.config, state = config, params  # no params: seeded random weights (_build_model)
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
            state = init_decoder_params(self.config, torch.Generator(device=self.device).manual_seed(seed))
            self.tokenizer = ByteTokenizer()
        self.model = _build_model(self.config, state, self.device, seed)
        self._buckets = getattr(self.config, "prompt_buckets", _BUCKETS)
        # one generation at a time: the decode loop is paced by the host's
        # launches, and threads launching at once only contend for the GIL
        # (chip_smoke.py phase 8, TinyLlama width on an H100: 8 concurrent
        # generations took 67 s each, one alone 1.6 s)
        self._lock = threading.Lock()
        self._waves: _WaveServer | None = None
        if app_cfg.LLM_CONTINUOUS_SLOTS > 0:
            from ..models.scheduler import ContinuousGenerator

            # speculation composes with the slots at temperature 0 only
            gamma = app_cfg.LLM_SPECULATIVE_GAMMA
            self._waves = _WaveServer(ContinuousGenerator(
                self.model, n_slots=app_cfg.LLM_CONTINUOUS_SLOTS, temperature=self.temperature,
                eos_id=self._eos_id(), pad_id=getattr(self.tokenizer, "pad_id", 0), top_k=app_cfg.LLM_TOP_K,
                top_p=app_cfg.LLM_TOP_P, speculative_gamma=gamma if (gamma > 1 and self.temperature <= 0) else 0,
            ))

    def close(self) -> None:
        """Stop the wave server's worker, if there is one."""
        if self._waves is not None:
            self._waves.close()
            self._waves = None

    @staticmethod
    def _load_hf(path: str):
        """An HF checkpoint from a local directory (no network), its
        architecture chosen by ``model_type``."""
        p = Path(path)
        hf = json.loads((p / "config.json").read_text())
        kind = hf.get("model_type")
        if kind not in ("llama", "deepseek_v2"):
            raise ValueError(f"LLM_MODEL_PATH {path}: model_type {kind!r} is not served (llama, deepseek_v2)")
        config = DeepseekV2Config.from_hf(hf) if kind == "deepseek_v2" else DecoderConfig(
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
        load = load_hf_deepseek_v2 if kind == "deepseek_v2" else load_hf_llama
        return config, load(config, state), tok

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
        limit = min(self.config.max_position - self.max_new_tokens, self._buckets[-1])
        ids = ids[-max(8, limit):]
        bucket = _bucket(len(ids), self._buckets)
        pad = bucket - len(ids)
        arr = np.full((1, bucket), getattr(self.tokenizer, "pad_id", 0), np.int32)
        mask = np.zeros((1, bucket), np.int32)
        arr[0, pad:] = ids
        mask[0, pad:] = 1
        return arr, mask

    def generate(self, prompt: str, **kwargs) -> str:
        ids, mask = self._encode_prompt(prompt)
        if self._waves is not None:
            # the wave server strips EOS and holds each budget on the device.
            # Compaction prefills prompt and tokens again into a power-of-two
            # bucket, so bucket(prompt + new) + one segment must fit
            # max_position: the prompt is capped (its tail kept) and the
            # budget cut to the largest such bucket
            raw = [int(t) for t, m in zip(ids[0], mask[0]) if m]
            budget = self.config.max_position - self._waves.gen.segment_advance
            p2f = 1 << (max(budget, 8).bit_length() - 1)
            new_eff = max(1, min(self.max_new_tokens, p2f - 8))
            cap = 8
            while 2 * cap + new_eff <= p2f:
                cap *= 2
            return self.tokenizer.decode(self._waves.submit(raw[-cap:], new_eff))
        gamma = get_config().LLM_SPECULATIVE_GAMMA
        with self._lock:
            if gamma > 0 and self.temperature <= 0.0:
                toks = self._speculative_ids(ids, mask, gamma)
            else:
                generator = None
                if self.temperature > 0.0:
                    generator = torch.Generator(device=self.device).manual_seed(prompt_seed(prompt))
                toks = self._generate_ids(ids, mask, generator)
        eos = self._eos_id()
        out = []
        for t in toks:
            if eos is not None and t == int(eos):
                break
            out.append(t)
        return self.tokenizer.decode(out)

    def _speculative_ids(self, ids: np.ndarray, mask: np.ndarray, gamma: int) -> list[int]:
        # the JAX budget: the bucket, the new tokens and one draft's overhang within max_position
        budget = self.config.max_position - ids.shape[1] - gamma
        return generate_lookup_speculative(
            self.model,
            torch.as_tensor(ids, dtype=torch.long, device=self.device),
            torch.as_tensor(mask, device=self.device),
            max_new_tokens=max(1, min(self.max_new_tokens, budget)),
            gamma=gamma,
            eos_id=self._eos_id(),
            pad_id=getattr(self.tokenizer, "pad_id", 0),
        ).tolist()

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
