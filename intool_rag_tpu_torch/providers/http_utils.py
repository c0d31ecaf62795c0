"""HTTP for the LLM and embedding providers over the standard library
(port of ``intool_rag_tpu/providers/http_utils.py``, which uses httpx).

Every exchange goes through :func:`transport` (``http.client``, one
connection per request): it connects within ``HTTP_CONNECT_TIMEOUT``,
sends within ``HTTP_WRITE_TIMEOUT`` and reads within
``HTTP_READ_TIMEOUT``, or within the one timeout a caller gives.
:func:`request_with_retry` keeps the JAX version's policy: up to
``HTTP_MAX_RETRIES`` retries with a delay of ``HTTP_RETRY_DELAY · 2^attempt``
on a connection error, a timeout or a 5xx answer, raised as the typed
provider errors. There is no connection pool, so the JAX config's
``HTTP_POOL_TIMEOUT`` and ``HTTP_MAX_*CONNECTIONS`` have no counterpart.
"""

from __future__ import annotations

import dataclasses
import http.client
import json as _json
import socket
import time
import urllib.parse
from typing import Iterator

from ..logging import get_logger
from ..config import get_config
from ..exceptions import ProviderConnectionError, ProviderTimeoutError

logger = get_logger(__name__)


@dataclasses.dataclass
class Response:
    """A finished exchange: the status and the whole body."""

    status_code: int
    content: bytes

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", errors="replace")

    def json(self):
        return _json.loads(self.content)


def transport(method: str, url: str, body: bytes | None = None, *,
              timeout: float | None = None) -> tuple[int, Iterator[bytes]]:
    """One HTTP exchange: ``(status, the body's lines as they arrive)``.
    The connection closes once the lines are read. A failure to connect
    (a timeout included) raises :class:`ProviderConnectionError`, a timeout
    after that :class:`ProviderTimeoutError`."""
    cfg = get_config()
    parts = urllib.parse.urlsplit(url)
    cls = http.client.HTTPSConnection if parts.scheme == "https" else http.client.HTTPConnection
    conn = cls(parts.hostname, parts.port, timeout=timeout or cfg.HTTP_CONNECT_TIMEOUT)
    path = parts.path or "/"
    if parts.query:
        path += "?" + parts.query
    try:
        conn.connect()
    except OSError as exc:
        conn.close()
        raise ProviderConnectionError(f"{parts.scheme}://{parts.netloc}: {exc}") from exc
    try:
        conn.sock.settimeout(timeout or cfg.HTTP_WRITE_TIMEOUT)
        headers = {"Content-Type": "application/json"} if body is not None else {}
        conn.request(method, path, body=body, headers=headers)
        conn.sock.settimeout(timeout or cfg.HTTP_READ_TIMEOUT)
        resp = conn.getresponse()
    except (socket.timeout, TimeoutError) as exc:
        conn.close()
        raise ProviderTimeoutError(f"{parts.netloc}: {exc}") from exc
    except OSError as exc:
        conn.close()
        raise ProviderConnectionError(f"{parts.netloc}: {exc}") from exc

    def lines() -> Iterator[bytes]:
        try:
            while line := resp.readline():
                yield line
        except (socket.timeout, TimeoutError) as exc:
            raise ProviderTimeoutError(f"{parts.netloc}: {exc}") from exc
        finally:
            conn.close()

    return resp.status, lines()


def request_with_retry(method: str, url: str, *, json=None) -> Response:
    """One request with the config's retries and exponential backoff; a
    4xx answer comes back as it is, for the caller to judge."""
    cfg = get_config()
    body = None if json is None else _json.dumps(json).encode()
    last_exc: Exception | None = None
    for attempt in range(cfg.HTTP_MAX_RETRIES + 1):
        try:
            status, lines = transport(method, url, body)
            content = b"".join(lines)
            if status >= 500:
                raise ProviderConnectionError(f"{url} returned {status}")
            return Response(status, content)
        except (ProviderConnectionError, ProviderTimeoutError) as exc:
            last_exc = exc
        if attempt < cfg.HTTP_MAX_RETRIES:
            delay = cfg.HTTP_RETRY_DELAY * (2**attempt)
            logger.warning("retrying %s in %.1fs (%s)", url, delay, last_exc)
            time.sleep(delay)
    raise last_exc  # type: ignore[misc]


def stream_lines(method: str, url: str, *, json=None) -> tuple[int, Iterator[str]]:
    """A streamed exchange, no retries: ``(status, decoded lines)``."""
    status, lines = transport(method, url, None if json is None else _json.dumps(json).encode())
    return status, (ln.decode("utf-8").rstrip("\r\n") for ln in lines)
