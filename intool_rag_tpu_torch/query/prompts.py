"""Prompt templates (port of ``intool_rag_tpu/query/prompts.py``; the same
wording, so both packages put the same prompt before their LLM)."""

from __future__ import annotations

RAG_CONTEXT_TEMPLATE = """You are a careful assistant answering strictly from the provided document context.

Context:
{context}

Question: {question}

Answer using only the context above. If the context does not contain the answer, say so. Cite the page numbers you used.

Answer:"""

SUMMARIZATION_TEMPLATE = """Summarize the following document excerpt in at most {max_sentences} sentences, keeping concrete facts (names, amounts, dates).

Excerpt:
{text}

Summary:"""

INTENT_CLASSIFICATION_TEMPLATE = """Classify the user question into exactly one intent label.

Labels: LOOKUP (find a specific fact), EXPLAIN (how/why something works), SUMMARIZE (condense content), COMPARE (contrast two or more things).

Question: {question}

Label:"""

ANSWER_GENERATION_TEMPLATE = """Context:
{context}

Question: {question}

Give a direct, complete answer based only on the context. Include relevant figures verbatim.

Answer:"""

PAGE_AWARE_ANSWER_TEMPLATE = """You are answering from specific document pages. Each context block is tagged with its source page and section.

{context}

Question: {question}

Answer the question and mention which page(s) support each claim.

Answer:"""


def get_rag_prompt(question: str, context: str) -> str:
    return RAG_CONTEXT_TEMPLATE.format(context=context, question=question)


def get_page_aware_prompt(question: str, context: str) -> str:
    return PAGE_AWARE_ANSWER_TEMPLATE.format(context=context, question=question)


def get_intent_prompt(question: str) -> str:
    return INTENT_CLASSIFICATION_TEMPLATE.format(question=question)


def get_summarization_prompt(text: str, max_sentences: int = 3) -> str:
    return SUMMARIZATION_TEMPLATE.format(text=text, max_sentences=max_sentences)
