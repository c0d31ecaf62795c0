"""intool_rag_tpu_torch: the PyTorch/CUDA port of ``intool_rag_tpu``.

The same page-aware hybrid retrieval service, written in PyTorch for an
NVIDIA H100. The dense stage of ``/search`` and ``/query`` runs in
hand-written CUDA kernels (``kernels/flat_partial_topk.cu``), and
``/query`` answers with an LLM, among them the in-process Llama-family
decoder (``models/decoder.py``). Module paths mirror the JAX
package so each module's counterpart is easy to find; nothing of the JAX
package is imported. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
