"""Multi-device execution (port of ``intool_rag_tpu/parallel/``): corpus
sharding, the tensor-parallel decoder (:mod:`.tp_decoder`) and the
sequence-parallel encoder (:mod:`.sequence`); the DP+TP train step lives in
``train/contrastive.py``. One process drives every shard of a
:class:`.mesh.Mesh`; the per-shard work runs the single-device code and
kernels, and :mod:`.collectives` joins the shards."""

from .mesh import Mesh, ShardedTensor, corpus_mesh, local_devices, train_mesh  # noqa: F401
