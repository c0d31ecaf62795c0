"""OCR engine (port of ``intool_rag_tpu/ocr/``): det (DBNet-style
segmentation) → cls (0°/180°) → rec (CTC), the model forwards as
``torch.nn`` modules on the card, the geometry (connected components,
min-area rects, crops), the CTC beam with its bigram LM and the lexicon
repair as the JAX package's NumPy/SciPy host code. ``ocr/train.py``
trains the three models."""

from .pipeline import OCREngine, OCRResult  # noqa: F401
