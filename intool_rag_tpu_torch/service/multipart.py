"""Minimal multipart/form-data parser (copy of
``intool_rag_tpu/service/multipart.py``; stdlib only, since cgi was removed
in Python 3.13 and no web framework is available)."""

from __future__ import annotations

import re
from dataclasses import dataclass


@dataclass
class FilePart:
    name: str
    filename: str
    content_type: str
    data: bytes


_DISPOSITION = re.compile(
    rb'form-data\s*;\s*name="([^"]*)"(?:\s*;\s*filename="([^"]*)")?', re.I
)


def parse_multipart(body: bytes, content_type: str) -> tuple[dict[str, str], list[FilePart]]:
    """Returns (fields, files)."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("no multipart boundary in content type")
    boundary = b"--" + m.group(1).encode()
    fields: dict[str, str] = {}
    files: list[FilePart] = []
    for raw_part in body.split(boundary):
        part = raw_part.strip(b"\r\n")
        if not part or part == b"--":
            continue
        if b"\r\n\r\n" in part:
            header_blob, data = part.split(b"\r\n\r\n", 1)
        elif b"\n\n" in part:
            header_blob, data = part.split(b"\n\n", 1)
        else:
            continue
        headers: dict[str, bytes] = {}
        for line in header_blob.split(b"\r\n"):
            if b":" in line:
                k, v = line.split(b":", 1)
                headers[k.strip().lower().decode()] = v.strip()
        disp = headers.get("content-disposition", b"")
        dm = _DISPOSITION.search(disp)
        if not dm:
            continue
        name = dm.group(1).decode(errors="replace")
        filename = dm.group(2)
        if filename is not None:
            files.append(
                FilePart(
                    name=name,
                    filename=filename.decode(errors="replace"),
                    content_type=headers.get("content-type", b"application/octet-stream").decode(),
                    data=data,
                )
            )
        else:
            fields[name] = data.decode(errors="replace")
    return fields, files
