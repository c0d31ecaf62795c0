"""Synthetic relevance benchmark for reranker quality.

Construction (designed so lexical retrieval is partially blind): each
document carries a *context* word (lexically shared with the query — this
is what hybrid retrieval can see) and a *topic* expressed with a
document-side word ``dtopN`` while queries use the disjoint query-side
word ``qtopN``. True relevance = same context AND same topic. BM25 and
hash embeddings match only the context (the topic words never co-occur),
so hybrid ranks a query's context cohort in arbitrary order; a
cross-encoder trained on judged pairs learns the qtop↔dtop association
and sorts the cohort correctly: the measurable gap is hybrid < rerank on
recall/MRR/NDCG. The port's own copy of ``intool_rag_tpu/eval/synthetic.py``
(numpy only): the same rng gives the same task in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .harness import EvalExample

_FILLER = (
    "report annual figure section page table note value entry item "
    "record detail summary total list part data file form line"
).split()

# disjoint filler lexicon for the OOD eval family (no overlap with
# _FILLER, so surface statistics differ from the training corpus)
_FILLER_OOD = (
    "ledger quarterly metric chapter sheet grid remark amount field unit "
    "log aspect digest balance index region batch folder slip row"
).split()


@dataclasses.dataclass
class RelevanceTask:
    texts: list[str]  # corpus documents
    doc_topic: np.ndarray  # [N] topic id per doc
    doc_ctx: np.ndarray  # [N] context id per doc
    examples: list[EvalExample]  # held-out eval queries
    train_queries: list[str]
    train_passages: list[str]
    train_labels: np.ndarray


def make_relevance_task(
    rng: np.random.Generator,
    *,
    n_topics: int = 40,
    n_ctx: int = 20,
    docs_per_ctx: int = 16,
    n_eval: int = 48,
    n_train_queries: int = 300,
    negatives_per_query: int = 6,
) -> RelevanceTask:
    texts, doc_topic, doc_ctx = [], [], []
    for c in range(n_ctx):
        for _ in range(docs_per_ctx):
            t = int(rng.integers(n_topics))
            filler = " ".join(rng.choice(_FILLER, size=rng.integers(3, 8)))
            texts.append(f"dtop{t} ctx{c} {filler}")
            doc_topic.append(t)
            doc_ctx.append(c)
    doc_topic = np.asarray(doc_topic)
    doc_ctx = np.asarray(doc_ctx)

    def query_for(c: int, t: int) -> str:
        # no filler on the query side: query terms are the topic word
        # (invisible to lexical retrieval) and the context word (the
        # retrievable signal) — filler in queries just adds BM25 noise
        # that drowns the context cohort
        return f"qtop{t} ctx{c}"

    def sample_query():
        """(ctx, topic) with ≥1 relevant doc in the cohort."""
        while True:
            c = int(rng.integers(n_ctx))
            cohort = np.flatnonzero(doc_ctx == c)
            t = int(doc_topic[cohort[rng.integers(len(cohort))]])
            rel = set(cohort[doc_topic[cohort] == t].tolist())
            if rel:
                return c, t, rel

    examples = []
    for _ in range(n_eval):
        c, t, rel = sample_query()
        examples.append(EvalExample(query=query_for(c, t), relevant_rows=rel))

    tq, tp, tl = [], [], []
    for _ in range(n_train_queries):
        c, t, rel = sample_query()
        q = query_for(c, t)
        rel_list = list(rel)
        cohort = np.flatnonzero(doc_ctx == c)
        neg_pool = [i for i in cohort if doc_topic[i] != t]
        # positives ×3: balances labels against the negative pool (BCE on
        # an ~85%-negative pool converged to majority-class behavior)
        for r in rel_list[:2]:
            for _ in range(3):
                tq.append(q)
                tp.append(texts[r])
                tl.append(1.0)
        # hard negatives: same context, wrong topic (what rerank must
        # actually separate — the hybrid cohort)
        for i in rng.choice(
            neg_pool, size=min(negatives_per_query, len(neg_pool)),
            replace=False,
        ):
            tq.append(q)
            tp.append(texts[int(i)])
            tl.append(0.0)
    return RelevanceTask(
        texts=texts,
        doc_topic=doc_topic,
        doc_ctx=doc_ctx,
        examples=examples,
        train_queries=tq,
        train_passages=tp,
        train_labels=np.asarray(tl, np.float32),
    )


_FILLER_BIG = _FILLER + _FILLER_OOD + (
    "survey outline abstract margin footer header agenda docket roster "
    "tally audit excerpt appendix clause annex segment bracket quota "
    "figurehead manifest registry bulletin gazette minutes notice "
    "statement voucher receipt docketed tabulation schedule annexure"
).split()


def make_relevance_task_graded(
    rng: np.random.Generator,
    *,
    n_topics: int = 80,
    n_ctx: int = 32,
    docs_per_ctx: int = 24,
    n_eval: int = 64,
    n_train_queries: int = 400,
    negatives_per_query: int = 6,
    decoy_prob: float = 0.4,
) -> RelevanceTask:
    """Harder GRADED-relevance family (the 40-topic task saturates:
    trained-encoder and rerank rows reach recall 1.000, so it cannot rank
    further improvements).

    Hardness levers over :func:`make_relevance_task`:

    - **2× the topic vocabulary** (80) with the same training budget —
      fewer judged pairs per association to learn from;
    - **sibling topics**: topics pair as (2i, 2i+1); a same-context doc
      on the SIBLING topic is graded gain 1 (near-miss) vs gain 3 for
      the exact topic — NDCG now measures whether the model separates
      an association from its nearest neighbor, not just from noise;
    - **single-mention evidence** buried in 10–18 filler words from a
      3× larger lexicon, shuffled order, wrong-topic decoys in 40% of
      docs (no positional template to latch onto);
    - **noisy queries**: two filler words ride along, so BM25's context
      signal competes with filler collisions.

    Grading (linear gains, TREC-style): gain 3 = same topic AND
    context; gain 1 = sibling topic, same context; else 0.
    ``relevant_rows`` (recall/MRR) is the gain-3 set only.
    """
    texts, doc_topic, doc_ctx = [], [], []
    for c in range(n_ctx):
        for _ in range(docs_per_ctx):
            t = int(rng.integers(n_topics))
            words = list(
                rng.choice(_FILLER_BIG, size=int(rng.integers(10, 19)))
            )
            words += [f"dtop{t}", f"ctx{c}"]
            if rng.random() < decoy_prob:
                wrong = int((t + 2 + rng.integers(n_topics - 3)) % n_topics)
                words.append(f"dtop{wrong}")
            rng.shuffle(words)
            texts.append(" ".join(words))
            doc_topic.append(t)
            doc_ctx.append(c)
    doc_topic = np.asarray(doc_topic)
    doc_ctx = np.asarray(doc_ctx)

    def query_for(c: int, t: int) -> str:
        noise = " ".join(rng.choice(_FILLER_BIG, size=2))
        return f"qtop{t} ctx{c} {noise}"

    def sample_query():
        while True:
            c = int(rng.integers(n_ctx))
            cohort = np.flatnonzero(doc_ctx == c)
            t = int(doc_topic[cohort[rng.integers(len(cohort))]])
            rel = set(cohort[doc_topic[cohort] == t].tolist())
            if rel:
                return c, t, rel

    examples = []
    for _ in range(n_eval):
        c, t, rel = sample_query()
        sib = t ^ 1
        cohort = np.flatnonzero(doc_ctx == c)
        gains = {int(r): 3.0 for r in rel}
        for r in cohort[doc_topic[cohort] == sib]:
            gains[int(r)] = 1.0
        examples.append(
            EvalExample(query=query_for(c, t), relevant_rows=rel,
                        gains=gains)
        )

    tq, tp, tl = [], [], []
    for _ in range(n_train_queries):
        c, t, rel = sample_query()
        q = query_for(c, t)
        cohort = np.flatnonzero(doc_ctx == c)
        neg_pool = [i for i in cohort if doc_topic[i] != t]
        for r in list(rel)[:2]:
            for _ in range(3):
                tq.append(q)
                tp.append(texts[r])
                tl.append(1.0)
        for i in rng.choice(
            neg_pool, size=min(negatives_per_query, len(neg_pool)),
            replace=False,
        ):
            tq.append(q)
            tp.append(texts[int(i)])
            tl.append(0.0)
    return RelevanceTask(
        texts=texts,
        doc_topic=doc_topic,
        doc_ctx=doc_ctx,
        examples=examples,
        train_queries=tq,
        train_passages=tp,
        train_labels=np.asarray(tl, np.float32),
    )


def make_relevance_task_ood(
    rng: np.random.Generator,
    *,
    n_topics: int = 40,
    n_ctx: int = 20,
    docs_per_ctx: int = 16,
    n_eval: int = 48,
    decoy_prob: float = 0.3,
) -> RelevanceTask:
    """Out-of-distribution EVAL family (the in-distribution
    family trains and evaluates within one generator).

    Shares the qtop↔dtop association vocabulary with
    :func:`make_relevance_task` — that mapping IS the knowledge the
    cross-encoder is trained to hold — but every surface property
    differs from the training corpus:

    - disjoint filler lexicon (``_FILLER_OOD``),
    - randomized word order (training docs are templated
      ``dtopT ctxC <filler>``; here topic/context words land at random
      positions),
    - longer, variable-length documents (6–14 filler words vs 3–8),
    - distractor topic mentions: with ``decoy_prob`` a document also
      contains a single wrong-topic ``dtop`` word, while the true topic
      word appears twice — a bag-of-evidence robustness probe that the
      positional template could never create.

    A reranker that learned the association (not template artifacts)
    keeps its NDCG/MRR lift here; one that memorized surface structure
    does not. Returns a task with eval examples only (train fields are
    empty — training stays on the original family by design).
    """
    texts, doc_topic, doc_ctx = [], [], []
    for c in range(n_ctx):
        for _ in range(docs_per_ctx):
            t = int(rng.integers(n_topics))
            words = list(rng.choice(_FILLER_OOD, size=int(rng.integers(6, 15))))
            words += [f"dtop{t}", f"dtop{t}", f"ctx{c}"]
            if rng.random() < decoy_prob:
                wrong = int((t + 1 + rng.integers(n_topics - 1)) % n_topics)
                words.append(f"dtop{wrong}")
            rng.shuffle(words)
            texts.append(" ".join(words))
            doc_topic.append(t)
            doc_ctx.append(c)
    doc_topic = np.asarray(doc_topic)
    doc_ctx = np.asarray(doc_ctx)

    examples = []
    while len(examples) < n_eval:
        c = int(rng.integers(n_ctx))
        cohort = np.flatnonzero(doc_ctx == c)
        t = int(doc_topic[cohort[rng.integers(len(cohort))]])
        rel = set(cohort[doc_topic[cohort] == t].tolist())
        if rel:
            examples.append(
                EvalExample(query=f"qtop{t} ctx{c}", relevant_rows=rel)
            )
    return RelevanceTask(
        texts=texts,
        doc_topic=doc_topic,
        doc_ctx=doc_ctx,
        examples=examples,
        train_queries=[],
        train_passages=[],
        train_labels=np.zeros(0, np.float32),
    )
