"""Training: contrastive (InfoNCE) fine-tuning of the text encoder, on one
device or with DP+TP sharding over a ``(data, model)`` mesh, and pointwise
training of the cross-encoder reranker (port of ``intool_rag_tpu/train/``)."""

from .contrastive import TrainState, make_train_step, shard_params  # noqa: F401
