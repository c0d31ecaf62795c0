"""Multi-device execution (port of ``intool_rag_tpu/parallel/``): corpus
sharding. One process drives every shard of a :class:`.mesh.Mesh`; the
per-shard work runs the single-device kernels and a small merge
(:mod:`.collectives`) joins the shards."""

from .mesh import Mesh, ShardedTensor, corpus_mesh, local_devices, train_mesh  # noqa: F401
