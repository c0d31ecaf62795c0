"""Reranker factory: builds the cross-encoder when it is enabled and its
weights are available locally (port of
``intool_rag_tpu/llm/reranker_factory.py``). Without local weights it
returns ``None`` with a warning: random weights would only hurt ranking, so
they are never served."""

from __future__ import annotations

import threading

import torch

from ..logging import get_logger
from ..config import get_config

logger = get_logger(__name__)

_reranker = None
_built = False
_lock = threading.Lock()


def reranker_from_hf(hf_config, state_dict: dict, device: str | torch.device | None = None):
    """A serving :class:`..models.reranker.Reranker` from an HF
    ``XLMRobertaForSequenceClassification`` config and state dict."""
    from ..models.encoder import EncoderConfig
    from ..models.reranker import Reranker, load_reranker_torch_state_dict

    enc_config = EncoderConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        max_position=hf_config.max_position_embeddings,
        pad_token_id=hf_config.pad_token_id or 1,
    )
    params = load_reranker_torch_state_dict(enc_config, state_dict)
    return Reranker.create(enc_config, params=params, device=device)


def _build(device: str | torch.device | None):
    cfg = get_config()
    if not cfg.RERANKER_ENABLED:
        return None
    try:
        from transformers import AutoConfig, AutoModelForSequenceClassification

        hf_config = AutoConfig.from_pretrained(cfg.RERANKER_MODEL, local_files_only=True)
        model = AutoModelForSequenceClassification.from_pretrained(cfg.RERANKER_MODEL, local_files_only=True)
        reranker = reranker_from_hf(hf_config, model.state_dict(), device)
        logger.info("reranker loaded from %s", cfg.RERANKER_MODEL)
        return reranker
    except Exception as exc:  # no package, no local files, or a checkpoint of another shape
        logger.warning(
            "RERANKER_ENABLED but no local weights for %s (%s): reranking disabled "
            "(random weights would hurt ranking quality)",
            cfg.RERANKER_MODEL, exc,
        )
        return None


def get_reranker(device: str | torch.device | None = None):
    """The process reranker, or None (disabled, or no weights). ``device``
    counts on the first call, which builds it."""
    global _reranker, _built
    if not _built:
        with _lock:
            if not _built:
                _reranker = _build(device)
                _built = True
    return _reranker


def reset_reranker() -> None:
    global _reranker, _built
    _reranker = None
    _built = False
