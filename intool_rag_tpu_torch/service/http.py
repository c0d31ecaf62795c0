"""Threaded stdlib HTTP front end for RAGService (port of
``intool_rag_tpu/service/http.py``).

Run: ``python -m intool_rag_tpu_torch.service [--checkpoint <encoder.npz>]
[--port 8001] [--host 0.0.0.0] [--device cuda]``; documents come from
``STORAGE_DIR``. The embedding provider comes from the embedding factory
(``EMBEDDING_PROVIDER``, ``llm/embeddings/factory.py``), as in the JAX
service; ``--checkpoint`` sets ``EMBEDDING_CHECKPOINT`` for the encoder.
``/query`` answers with the LLM factory's choice (``LLM_PROVIDER``,
``llm/factory.py``); a ``stream: true`` query is answered as server-sent
events.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..logging import get_logger
from ..config import get_config
from .app import RAGService

logger = get_logger(__name__)


def make_handler(service: RAGService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _respond(self, method: str) -> None:
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            status, payload = service.handle(
                method, self.path, body, self.headers.get("Content-Type", "")
            )
            if isinstance(payload, dict) and "__stream__" in payload:
                self._respond_sse(status, payload["__stream__"])
                return
            data = json.dumps(payload, ensure_ascii=False).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.send_header("Access-Control-Allow-Origin", "*")  # reference enables CORS
            self.end_headers()
            self.wfile.write(data)

        def _respond_sse(self, status: int, events) -> None:
            self.send_response(status)
            self.send_header("Content-Type", "text/event-stream; charset=utf-8")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Connection", "close")
            self.end_headers()
            try:
                for event in events:
                    self.wfile.write(event.encode())
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client hung up mid-stream
            self.close_connection = True

        def do_GET(self) -> None:  # noqa: N802
            self._respond("GET")

        def do_POST(self) -> None:  # noqa: N802
            self._respond("POST")

        def do_DELETE(self) -> None:  # noqa: N802
            self._respond("DELETE")

        def do_OPTIONS(self) -> None:  # noqa: N802
            self.send_response(204)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "GET, POST, DELETE, OPTIONS")
            self.send_header("Access-Control-Allow-Headers", "Content-Type")
            self.end_headers()

        def log_message(self, fmt: str, *args) -> None:
            logger.info("%s - %s", self.address_string(), fmt % args)

    return Handler


class _Server(ThreadingHTTPServer):
    # default request_queue_size (5) drops connections under bursty
    # concurrent load (measured: ECONNRESET at 32 concurrent clients
    # in bench_http) — raise the accept backlog
    request_queue_size = 128


class ServiceServer:
    def __init__(self, service: RAGService, host: str | None = None,
                 port: int | None = None) -> None:
        cfg = get_config()
        self.service = service
        self.host = host or cfg.SERVICE_HOST
        self.port = port if port is not None else cfg.SERVICE_PORT
        self.httpd = _Server(
            (self.host, self.port), make_handler(self.service)
        )
        self.port = self.httpd.server_address[1]  # resolve port 0

    def serve_forever(self) -> None:
        logger.info("serving on %s:%d", self.host, self.port)
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        thread.start()
        return thread

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def main() -> None:
    import argparse
    import os

    from ..config import reset_config
    from ..llm.embeddings.factory import get_embedding_provider

    parser = argparse.ArgumentParser(description="intool_rag_tpu_torch service")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--checkpoint", default=None, help="encoder checkpoint (default EMBEDDING_CHECKPOINT)")
    parser.add_argument("--device", default=None, help="torch device (default cuda)")
    args = parser.parse_args()
    if args.checkpoint:
        os.environ["EMBEDDING_CHECKPOINT"] = args.checkpoint
        reset_config()
    provider = get_embedding_provider(device=args.device)
    service = RAGService(provider, device=args.device)
    ServiceServer(service, host=args.host, port=args.port).serve_forever()


if __name__ == "__main__":
    main()
