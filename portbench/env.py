"""The environment of a benchmark process, set before torch is imported."""

from __future__ import annotations

import os
from pathlib import Path

CACHE = Path(__file__).resolve().parent / "_cache"


def prepare() -> None:
    """transformers (the port's tokenizer looks for it) must not pull in flax
    or TensorFlow; kernel caches sit at fixed paths inside the checkout (the
    port's own builds stay in ``intool_rag_tpu_torch/kernels/_build`` and
    ``native/_build``)."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    os.environ["USE_TORCH"] = "1"
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
