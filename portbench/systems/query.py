"""The ``/query`` system: a wave of questions retrieved as ``/search`` does
(``PageLevelRetriever._embed`` then ``HybridEngine.search``, top-10 fused
rows over the flat store of ``portbench/system.py``), each question's prompt
assembled from its rows' chunks, then every prompt answered by the port's
DeepSeek-V2 decoder (``CudaLLM``'s model) through its continuous-batching
scheduler (``ContinuousGenerator.generate_many``), one wave a step.

The harness's contract (``portbench/harness.py``):

- :func:`plan`: ``batches`` are the window's waves, each a list of
  ``(question, answer tokens)``, the answers in the traffic's one shuffled
  order;
- :func:`build`: the retrieval stack, the decoder and its scheduler;
  ``step`` runs one wave and returns its questions and host seconds by
  phase (retrieve, assemble, prefill, decode); a checked wave runs with
  capture wrappers on the decoder, which pass everything through and keep
  what the judge reads of the checked streams: the prompt, the tokens, the
  logits at the prompt's last position and at every decoded position, the
  experts each prompt token was routed to, and the latent-cache entries of
  the prompt at the checked layers; the wrappers are removed once the wave
  has run. A wave inside the profiler slice leaves its prompt and answer
  lengths and the program's counters over it in ``run.dsv2`` for the
  readers;
- :func:`reference`: the judge (:class:`Reference`), which holds the
  checked streams to the plain float32 forward of
  ``portbench/reference/deepseek_v2.py`` on weights redrawn from the seed,
  teacher-forced on the program's own tokens:

  - ``prompt_exact``: 1 where the client's prompt differs from the
    reference's assembly (``portbench/reference/prompt.py``) from the
    program's own fused rows, else 0;
  - ``logit_err``: the widest ‖program − reference‖_F / ‖reference‖_F of a
    stream's logits, at the prompt's last position and every decoded one
    (over the stream, not a position: a bf16 rounding that flips one
    token's expert near a tie moves that position's logits by several
    percent, a rare and sound event that a position's maximum would read
    as a fault);
  - ``route_miss``: the share of the reference's expert picks over the
    prompt's tokens that the program did not make, counted at the
    token–layer pairs where the reference's k-th score passes its
    (k+1)-th by more than ``checks.route_gap`` of the k-th;
  - ``cache_err``: the widest ‖program − reference‖_F / ‖reference‖_F of a
    stream's latent-cache entries ``[c | k_pe]`` over its prompt, at each
    layer of ``checks.layers``.

The control (``control_side``) is the reference one precision down: the
latent entries and the expert matrices through float8 e4m3 with one scale
a tensor.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

# imported here, not at build: a program without the DeepSeek-V2 decoder fails before anything is set up
from intool_rag_tpu_torch.models.deepseek_v2 import DeepseekV2Config
from intool_rag_tpu_torch.models.scheduler import ContinuousGenerator
from intool_rag_tpu_torch.providers.cuda_llm import CudaLLM
from portbench import data, generate
from portbench.reference import deepseek_v2 as ref_model
from portbench.reference import prompt as ref_prompt
from portbench.reference.text import token_ids
from portbench.system import System, configure

CHECKED, CHUNKS, TEMPLATE = 8, 9, 10  # host streams of the seed (portbench/data.py numbers 1-7)
# the program's counters a sliced wave records for the readers (portbench/bounds_moe.py)
COUNTERS = ("moe.calls", "moe.assignments", "moe.experts_touched", "moe.decode_assignments", "moe.decode_experts_touched",
            "llm.decode_tokens")


def plan(config: dict, traffic: dict, seed: int) -> dict:
    """``batches`` waves of ``batch`` ``(question, answer tokens)``: the
    questions as ``batch256``'s, from the run's seed; the answer lengths the
    traffic's quantiles in one order shuffled by the traffic's own
    ``answers.order_seed``, the same in every wave and every run, so that
    each wave does the same decode work. The order is drawn, never sorted:
    no client knows an answer's length before it is generated."""
    vocab = data.vocabulary(seed, config["retrieval"]["bm25"]["vocab"])
    rng = data.host_rng(seed, data.TRAFFIC)
    n, waves = traffic["batch"], traffic["batches"]
    texts = generate.questions(rng, vocab, traffic["words"], n * waves, traffic["zipf_s"], n)
    answers = traffic["answers"]
    budgets = np.random.default_rng(answers["order_seed"]).permutation(generate.length_quantiles(answers, n))
    return {"batches": [[(texts[w * n + i], int(budgets[i])) for i in range(n)] for w in range(waves)]}


def build(config: dict, seed: int, device, tmp: Path) -> "Query":
    return Query(config, seed, device, tmp)


def reference(config: dict, seed: int, device, run) -> "Reference":
    return Reference(config, seed, device)


def checked_streams(traffic: dict, slots: int, seed: int) -> list[int]:
    """The wave positions the judge reads: half among the first ``slots``
    (the first fill), half among the refills."""
    rng = data.host_rng(seed, CHECKED)
    half = traffic["check_streams"] // 2
    first = rng.choice(slots, half, replace=False)
    later = slots + rng.choice(traffic["batch"] - slots, traffic["check_streams"] - half, replace=False)
    return sorted(int(i) for i in np.concatenate([first, later]))


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _counters() -> dict[str, int]:
    from intool_rag_tpu_torch.observability import get_metrics

    counters = get_metrics().snapshot()["counters"]
    return {k: counters.get(k, 0) for k in COUNTERS}


class _Client:
    """The client's prompt assembly (the rule of ``portbench/reference/
    prompt.py``), with each row's chunk drawn once a run."""

    def __init__(self, seed: int, spec: dict, vocab: int) -> None:
        self.seed, self.spec, self.vocab = int(seed) % (1 << 64), spec, vocab
        rng = np.random.default_rng([self.seed, TEMPLATE])
        self.template = self._ids(rng, spec["template_tokens"])
        self.chunks: dict[int, list[int]] = {}

    def _ids(self, rng, n: int) -> list[int]:
        return ((rng.zipf(self.spec["zipf_s"], size=n) - 1) % self.vocab).tolist()

    def chunk(self, row: int) -> list[int]:
        ids = self.chunks.get(row)
        if ids is None:
            rng = np.random.default_rng([self.seed, CHUNKS, row])
            chars = int(rng.integers(self.spec["chunk_min_chars"], self.spec["chunk_max_chars"] + 1))
            ids = self.chunks[row] = self._ids(rng, max(1, chars // self.spec["chars_per_token"]))
        return ids

    def prompt(self, question: str, rows: np.ndarray) -> list[int]:
        budget, context = self.spec["context_tokens"], []
        for row in rows.tolist():
            if row >= 0 and len(context) + len(self.chunk(row)) <= budget:
                context += self.chunk(row)
        return self.template + context + token_ids(question, self.vocab, self.spec["question_tokens_max"] + 2)[1:-1]


class _Capture:
    """Pass-through wrappers on the decoder for one checked wave: the
    scheduler's refill (which slot each checked stream takes), the model's
    prefill (the prompt's last logits), its one-token calls (each bound
    checked slot's decoded logits) and each expert layer's router (the
    prompt tokens' experts)."""

    def __init__(self, system: "Query", prompts: list[list[int]], streams: list[int], budgets: list[int]) -> None:
        self.system, self.gen, self.model = system, system.gen, system.model
        self.key = {id(prompts[i]): i for i in streams}
        self.out = {i: {"decoded": [], "routes": {}} for i in streams}
        self.budgets = budgets
        self.bound: dict[int, int] = {}  # slot -> wave position
        self.routes: dict[int, list] | None = None
        self.last = None
        gen, model = self.gen, self.model
        insert, prefill, forward = gen._insert, model.prefill, model.forward
        moe = [(i, layer.mlp) for i, layer in enumerate(model.layers) if hasattr(layer.mlp, "route")]

        def insert_wrapper(cache, s_bucket, entries, state):
            if state is None:  # compaction: the slots keep their streams
                return insert(cache, s_bucket, entries, state)
            for b, _, _ in entries:
                self.bound.pop(b, None)
            mine = [(j, b, self.key[id(toks)]) for j, (b, toks, _) in enumerate(entries) if id(toks) in self.key]
            if not mine:
                return insert(cache, s_bucket, entries, state)
            self.routes = {i: [] for i, _ in moe}
            try:
                firsts = insert(cache, s_bucket, entries, state)
            finally:
                routes, self.routes = self.routes, None
            layers = system.check_layers
            for j, b, key in mine:
                n = len(entries[j][1])
                rec = self.out[key]
                rec["first"] = self.last[j].float().cpu().numpy()
                rec["cache"] = cache.kv[layers, b, cache.length - n : cache.length].float().cpu().numpy()
                for i, calls in routes.items():
                    rec["routes"][i] = torch.cat(calls).view(len(entries), s_bucket, -1)[j, s_bucket - n:].cpu().numpy()
                self.bound[b] = key
            return firsts

        def prefill_wrapper(*args):
            out = prefill(*args)
            self.last = out
            return out

        def forward_wrapper(ids, positions, cache, valid_mask=None):
            out = forward(ids, positions, cache, valid_mask)
            live = [(b, k) for b, k in self.bound.items() if len(self.out[k]["decoded"]) < self.budgets[k] - 1]
            if ids.shape[1] == 1 and live:
                rows = out[[b for b, _ in live], 0].float().cpu().numpy()
                for (_, k), row in zip(live, rows):
                    self.out[k]["decoded"].append(row)
            return out

        def route_wrapper(i, route):
            def wrapped(x):
                w, idx = route(x)
                if self.routes is not None:
                    self.routes[i].append(idx)
                return w, idx
            return wrapped

        gen._insert, model.prefill, model.forward = insert_wrapper, prefill_wrapper, forward_wrapper
        for i, mlp in moe:
            mlp.route = route_wrapper(i, mlp.route)
        self._restore = [(gen, "_insert"), (model, "prefill"), (model, "forward")] + [(m, "route") for _, m in moe]

    def close(self) -> dict:
        for obj, name in self._restore:
            delattr(obj, name)  # the instance attribute goes; the class's method is back
        return self.out


class Query(System):
    """The built ``/query`` system. The retrieval stack is
    ``portbench/system.py``'s (its settings go into the environment and come
    back out at :meth:`close`); the decoder is ``CudaLLM``'s model, drawn
    from the seed on the card, behind a ``ContinuousGenerator``."""

    def __init__(self, config: dict, seed: int, device, tmp: Path) -> None:
        retrieval = config["retrieval"]
        self._env = {k: os.environ.get(k) for k in (*retrieval["port_config"], "STORAGE_DIR", "CACHE_DIR")}
        configure(retrieval, tmp)
        self.k, self.kc = retrieval["search"]["k"], retrieval["search"]["candidates"]
        self.spans: dict[str, list[float]] = {"retrieve": [], "generate": []}  # seconds, traced steps only
        self.captured: dict[int, tuple] = {}
        self.tracing: dict = {}
        super().__init__(retrieval, seed, device, tmp)
        t0 = time.perf_counter()
        dcfg = DeepseekV2Config.from_hf(config, max_position=config["cache_positions"], dtype=config["dtype"])
        self.llm = CudaLLM(config=dcfg, device=self.device, seed=seed, temperature=0.0)
        self.model = self.llm.model
        self.gen = ContinuousGenerator(self.model, n_slots=config["slots"], seg_len=config["seg_len"], eos_id=None)
        _sync()
        self.timings["decoder"] = time.perf_counter() - t0
        self.client = _Client(seed, config["prompt"], config["vocab_size"])
        self.check_layers = list(config["checks"]["layers"])
        self.warm_buckets = list(config["prompt"]["warm_buckets"])
        self.seed, self.slots = seed, config["slots"]

    def install(self, run, tracing: dict) -> None:
        self.batches = run.plan["batches"]
        self.tracing = tracing
        self.streams = checked_streams(run.traffic, self.slots, self.seed)
        run.model = run.config
        run.dsv2 = {"waves": 0, "prompt_lens": [], "answer_lens": [], "counters": dict.fromkeys(COUNTERS, 0)}
        self.run = run

    def warm(self, count: int) -> None:
        """``count`` waves, then one prompt at each of ``warm_buckets``'s
        lengths (the prompt buckets the traffic reaches), two tokens each."""
        for b in range(count):
            self.step(b % len(self.batches), False, False)
        rng = np.random.default_rng([self.seed % (1 << 64), TEMPLATE, 1])
        prompts = [rng.integers(0, self.model.config.vocab_size, n - 1).tolist() for n in self.warm_buckets]
        self.gen.generate_many(prompts, 2)
        _sync()

    def step(self, b: int, trace: bool, grab: bool) -> tuple[int, dict[str, float]]:
        clock = time.perf_counter
        texts, budgets = [q for q, _ in self.batches[b]], [a for _, a in self.batches[b]]
        sliced = bool(self.tracing.get("on"))
        before = _counters() if sliced else None
        t0 = clock()
        with record_function("portbench.retrieve"):
            emb = self.retriever._embed(texts)
            _, rows = self.engine.search(texts, emb, self.k, candidates=self.kc)
            rows = rows.cpu().numpy()
        t1 = clock()
        prompts = [self.client.prompt(q, r) for q, r in zip(texts, rows)]
        t2 = clock()
        capture = _Capture(self, prompts, self.streams, budgets) if grab else None
        try:
            with record_function("portbench.generate"):
                answers, stats = self.gen.generate_many(prompts, budgets)
                _sync()
        finally:
            out = capture.close() if capture is not None else None
        t3 = clock()
        if [len(a) for a in answers] != budgets:
            raise RuntimeError("an answer ended before its drawn length (EOS is off)")
        if grab:
            self.captured[b] = (texts, rows, prompts, answers, out)
        if trace:
            self.spans["retrieve"].append(t1 - t0)
            self.spans["generate"].append(t3 - t2)
        if sliced:
            after = _counters()
            dsv2 = self.run.dsv2
            dsv2["waves"] += 1
            dsv2["prompt_lens"] += [len(p) for p in prompts]
            dsv2["answer_lens"] += budgets
            for k in COUNTERS:
                dsv2["counters"][k] += after[k] - before[k]
        return len(texts), {"retrieve": t1 - t0, "assemble": t2 - t1, "prefill": stats["refill_s"],
                            "decode": t3 - t2 - stats["refill_s"]}

    def collect(self, run) -> list[dict]:
        """One side a checked wave: its checked streams' questions, fused
        rows, prompts, tokens and captures, on the host."""
        sides = []
        for b in sorted(self.captured):
            texts, rows, prompts, answers, out = self.captured[b]
            keys = sorted(out)
            sides.append({
                "texts": [texts[i] for i in keys], "rows": rows[keys], "prompts": [prompts[i] for i in keys],
                "tokens": [answers[i] for i in keys],
                "logits": [np.stack([out[i]["first"], *out[i]["decoded"]]) for i in keys],
                "routes": [out[i]["routes"] for i in keys], "cache": [out[i]["cache"] for i in keys]})
        self.captured = {}
        return sides

    def close(self) -> None:
        for key, value in self._env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        self.llm = self.model = self.gen = None
        super().close()


def _rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """‖a − b‖_F / ‖b‖_F."""
    return (a - b).norm() / b.norm().clamp(min=1e-30)


class Reference:
    """The judge of a checked wave, from the configuration and the seed."""

    def __init__(self, config: dict, seed: int, device) -> None:
        self.config, self.seed, self.device = config, seed, torch.device(device)
        self.weight = ref_model.redraw(config, seed, self.device, getattr(torch, config["dtype"]))
        self.layers = list(config["checks"]["layers"])
        self.gap = float(config["checks"]["route_gap"])
        self._memo: dict = {}

    def _forward(self, side: dict, control: bool = False) -> dict:
        """The forward over each stream's prompt and its tokens but the last
        (never fed), logits from the prompt's last position."""
        key = (control, tuple(tuple(p) + tuple(t) for p, t in zip(side["prompts"], side["tokens"])))
        if key not in self._memo:
            seqs = [torch.tensor(p + t[:-1], device=self.device) for p, t in zip(side["prompts"], side["tokens"])]
            with torch.no_grad():
                self._memo[key] = ref_model.forward(self.config, self.weight, seqs,
                                                    logits_from=[len(p) - 1 for p in side["prompts"]],
                                                    cache_layers=self.layers, control=control)
        return self._memo[key]

    def numbers(self, side: dict) -> dict[str, float]:
        spec, vocab = self.config["prompt"], self.config["vocab_size"]
        exact = all(ref_prompt.assemble(self.seed, q, r.tolist(), spec, vocab) == p
                    for q, r, p in zip(side["texts"], side["rows"], side["prompts"]))
        out = {"prompt_exact": 0.0 if exact else 1.0}
        ref = self._forward(side)
        logit = [float(_rel(torch.as_tensor(got, device=self.device), want))
                 for got, want in zip(side["logits"], ref["logits"])]
        out["logit_err"] = max(logit)
        missed = counted = 0
        k = self.config["num_experts_per_tok"]
        for i, calls in ref["routes"].items():
            for s, (idx, top) in enumerate(calls):
                n = len(side["prompts"][s])
                got = torch.as_tensor(side["routes"][s][i], device=self.device)
                idx, top = idx[:n], top[:n]
                sure = (top[:, k - 1] - top[:, k]) > self.gap * top[:, k - 1]
                hits = (got[:, :, None] == idx[:, None, :]).any(dim=1).sum(dim=1)
                missed += int((k - hits)[sure].sum())
                counted += int(sure.sum()) * k
        out["route_miss"] = missed / counted if counted else 1.0
        cache = [[float(_rel(torch.as_tensor(got[j], device=self.device), ref["cache"][layer][s][: got.shape[1]]))
                  for j, layer in enumerate(self.layers)] for s, got in enumerate(side["cache"])]
        out["cache_err"] = max(max(c) for c in cache)
        by_layer = {layer: max(c[j] for c in cache) for j, layer in enumerate(self.layers)}
        print(f"portbench: query check detail: cache_err by layer {by_layer}, logit_err by stream {logit}",
              file=sys.stderr)
        return out

    def control_side(self, side: dict) -> dict:
        """The control's side: the same prompts and tokens, its own logits,
        routes and latent entries."""
        ctrl = self._forward(side, control=True)
        n = [len(p) for p in side["prompts"]]
        return {**side,
                "logits": [lg.cpu().numpy() for lg in ctrl["logits"]],
                "routes": [{i: calls[s][0][: n[s]].cpu().numpy() for i, calls in ctrl["routes"].items()}
                           for s in range(len(n))],
                "cache": [np.stack([ctrl["cache"][layer][s][: n[s]].cpu().numpy() for layer in self.layers])
                          for s in range(len(n))]}
