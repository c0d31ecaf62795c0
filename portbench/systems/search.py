"""The ``/search`` system: bulk hybrid retrieval, as the retrieval path runs
it (``PageLevelRetriever._embed`` then ``HybridEngine.search``), one
pre-drawn batch of questions a step.

What the harness asks of a system module, and this one's answer:

- :func:`plan`: the window's pre-drawn work, ``{"batches": [...]}``, which
  the closed loop cycles through; here batches of questions from the
  traffic file, over the configuration's BM25 vocabulary;
- :func:`build`: the system built from the configuration and the seed, with
  ``timings`` (set-up seconds by stage) and the methods ``install`` (the
  capture wrappers), ``warm``, ``step`` (one batch; the questions it
  answered and the host seconds of each of its phases), ``collect`` (the
  checked batches' outputs on the host, once the window has closed) and
  ``close`` (puts back what the run replaced and drops the program);
- :func:`reference`: what judges a checked batch (``numbers(side)``) and
  puts the control in the program's place (``control_side(side)``).
"""

from __future__ import annotations

import os
import threading
import time
from pathlib import Path

import torch
from torch.profiler import record_function

from portbench import data, generate, judge
from portbench.system import System, configure


def plan(config: dict, traffic: dict, seed: int) -> dict:
    return generate.plan(traffic, data.vocabulary(seed, config["bm25"]["vocab"]), seed)


def build(config: dict, seed: int, device, tmp: Path) -> "Search":
    return Search(config, seed, device, tmp)


def reference(config: dict, seed: int, device, run) -> judge.Reference:
    return judge.Reference(config, seed, device, tier=run.tier)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else x


class _Capture:
    """The slots the wrappers fill while a checked batch runs."""

    def __init__(self) -> None:
        self.local = threading.local()

    def on(self) -> None:
        self.local.on, self.local.emb, self.local.fuse, self.local.probes = True, None, None, None

    def off(self) -> dict:
        out = {k: getattr(self.local, k, None) for k in ("emb", "fuse", "probes")}
        self.local.on = False
        return out

    @property
    def active(self) -> bool:
        return getattr(self.local, "on", False)


def _side(texts, cap: dict) -> dict:
    d_vals, d_rows, s_vals, s_rows, (f_vals, f_rows) = cap["fuse"]
    q = len(texts)
    side = {"texts": list(texts), "emb": cap["emb"][:q], "d_vals": d_vals[:q], "d_rows": d_rows[:q],
            "s_vals": s_vals[:q], "s_rows": s_rows[:q], "f_vals": f_vals[:q], "f_rows": f_rows[:q]}
    if cap["probes"] is not None:
        side["order"], side["probes"] = cap["probes"]
    return {k: _host(v) for k, v in side.items()}


class Search(System):
    """The built ``/search`` system (``portbench/system.py``) and the loop's
    side of it. The port's settings go into the environment before the port
    is built, and come back out at :meth:`close`."""

    def __init__(self, config: dict, seed: int, device, tmp: Path) -> None:
        self._env = {k: os.environ.get(k) for k in (*config["port_config"], "STORAGE_DIR", "CACHE_DIR")}
        configure(config, tmp)
        search = config["search"]
        self.k, self.kc = search["k"], search["candidates"]
        self.spans: dict[str, list[float]] = {"encode": [], "hybrid": []}  # seconds, traced steps only
        self.captured: dict[int, tuple] = {}
        self.capture = _Capture()
        self._restore = lambda: None
        super().__init__(config, seed, device, tmp)

    def install(self, run, tracing: dict) -> None:
        """Pass-through wrappers that keep references to what a checked batch
        produced (query embeddings; the capacity tier's query tiles and probe
        table; fusion's two pools and its result) and, in the traced slice,
        the probe table of each K3 scan (``run.scans``)."""
        import intool_rag_tpu_torch.index.bits_index as bits_index
        import intool_rag_tpu_torch.index.hybrid as hybrid

        capture = self.capture
        self.batches = run.plan["batches"]
        run.model, run.scans, run.tier = run.config["model"], [], None
        fuse, scan, probes = hybrid._fuse, bits_index.ivf_bits_topk, bits_index.tile_probes
        self._restore = lambda: (setattr(hybrid, "_fuse", fuse), setattr(bits_index, "ivf_bits_topk", scan),
                                 setattr(bits_index, "tile_probes", probes))

        def fuse_wrapper(d_vals, d_rows, s_vals, s_rows, k, **kw):
            out = fuse(d_vals, d_rows, s_vals, s_rows, k, **kw)
            if capture.active:
                capture.local.fuse = (d_vals, d_rows, s_vals, s_rows, out)
            return out

        hybrid._fuse = fuse_wrapper
        embed = self.retriever._embed

        def embed_wrapper(queries):
            out = embed(queries)
            if capture.active:
                capture.local.emb = out
            return out

        self.retriever._embed = embed_wrapper

        def probes_wrapper(queries, centroids, nprobe):
            out = probes(queries, centroids, nprobe)
            if capture.active:
                capture.local.probes = (out[0], out[2])  # query order (tiles of 8), probed lists per tile
            return out

        bits_index.tile_probes = probes_wrapper

        def scan_wrapper(qs, codes, scales, probe_blocks, c_sel, k, **kw):
            if tracing.get("on"):
                run.scans.append({"q": qs.shape[0], "d": qs.shape[1], "probe_blocks": probe_blocks, **kw})
            return scan(qs, codes, scales, probe_blocks, c_sel, k, **kw)

        bits_index.ivf_bits_topk = scan_wrapper

    def warm(self, count: int) -> None:
        for texts in self.batches[:count]:
            emb = self.retriever._embed(texts)
            self.engine.search(texts, emb, self.k, candidates=self.kc)
        _sync()

    def step(self, b: int, trace: bool, grab: bool) -> tuple[int, dict[str, float]]:
        """Batch ``b``: its embeddings, then its hybrid search; with
        ``trace`` each call in a ``record_function`` range and ended by a
        synchronise; with ``grab`` its outputs kept for the judge."""
        clock, texts = time.perf_counter, self.batches[b]
        if grab:
            self.capture.on()
        if trace:
            with record_function("portbench.encode"):
                s = clock()
                emb = self.retriever._embed(texts)
                _sync()
                self.spans["encode"].append(clock() - s)
            with record_function("portbench.hybrid"):
                s = clock()
                self.engine.search(texts, emb, self.k, candidates=self.kc)
                _sync()
                self.spans["hybrid"].append(clock() - s)
            encode, mid = self.spans["encode"][-1], s
        else:
            s = clock()
            emb = self.retriever._embed(texts)
            mid = clock()
            self.engine.search(texts, emb, self.k, candidates=self.kc)
            encode = mid - s
        phases = {"encode": encode, "search": clock() - mid}
        if grab:
            self.captured[b] = (texts, self.capture.off())
        return len(texts), phases

    def collect(self, run) -> list[dict]:
        """The checked batches' sides on the host, and the capacity tier's
        layout (``run.tier``), if the engine built one: its centroids, the
        row each slot holds (−1 empty), the slots of a list, and the slots
        of a scanned block."""
        sides = [_side(*self.captured[b]) for b in sorted(self.captured)]
        self.captured = {}
        ivf = getattr(self.engine.dense, "_ivf", None)
        if ivf is not None and hasattr(ivf, "gid"):
            run.tier = {"centroids": _host(ivf.centroids), "gid": _host(ivf.gid), "cap_l": int(ivf.cap_l),
                        "block_n": int(ivf.block_n)}
        return sides

    def close(self) -> None:
        self._restore()
        for key, value in self._env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        super().close()
