"""Training: contrastive (InfoNCE) fine-tuning of the text encoder and
pointwise training of the cross-encoder reranker, on one device (port of
``intool_rag_tpu/train/``; the DP+TP sharded step is not ported)."""

from .contrastive import TrainState, make_train_step, shard_params  # noqa: F401
