"""The reference's assembly of a ``/query`` prompt in token ids, written
apart from the client's (``portbench/systems/query.py``) so that the check
``prompt_exact`` compares two implementations of one rule:

- the instruction template: ``template_tokens`` ids of host stream 10 of the
  seed, Zipf ``zipf_s`` folded onto the vocabulary;
- then each fused row's chunk, in rank order, that still fits the
  ``context_tokens`` budget (one that does not is skipped); a row's chunk
  is uniform ``chunk_min_chars``-``chunk_max_chars`` characters at
  ``chars_per_token`` characters a token, its ids Zipf ``zipf_s``, all from
  host stream 9 of the seed and the row;
- then the question's words, as the hashing tokenizer's ids over the
  vocabulary (at most ``question_tokens_max``).
"""

from __future__ import annotations

import numpy as np

from .text import token_ids


def _zipf(rng: np.random.Generator, n: int, s: float, vocab: int) -> list[int]:
    return [int(t) for t in (rng.zipf(s, size=n) - 1) % vocab]


def chunk(seed: int, row: int, spec: dict, vocab: int) -> list[int]:
    rng = np.random.default_rng([int(seed) % (1 << 64), 9, int(row)])
    chars = int(rng.integers(spec["chunk_min_chars"], spec["chunk_max_chars"] + 1))
    return _zipf(rng, max(1, chars // spec["chars_per_token"]), spec["zipf_s"], vocab)


def assemble(seed: int, question: str, rows, spec: dict, vocab: int) -> list[int]:
    template = _zipf(np.random.default_rng([int(seed) % (1 << 64), 10]), spec["template_tokens"], spec["zipf_s"],
                     vocab)
    context: list[int] = []
    for row in rows:
        if row < 0:
            continue
        ids = chunk(seed, row, spec, vocab)
        if len(context) + len(ids) <= spec["context_tokens"]:
            context.extend(ids)
    words = token_ids(question, vocab, spec["question_tokens_max"] + 2)[1:-1]
    return template + context + words
