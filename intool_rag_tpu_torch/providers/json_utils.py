"""LLM-output JSON hardening (port of
``intool_rag_tpu/providers/json_utils.py``): strip markdown fences, take
the first JSON object or array span, parse."""

from __future__ import annotations

import json
import re

_FENCE = re.compile(r"```(?:json)?\s*(.*?)```", re.S)


def sanitize_json(text: str):
    m = _FENCE.search(text)
    if m:
        text = m.group(1)
    for opener, closer in (("{", "}"), ("[", "]")):
        start = text.find(opener)
        if start < 0:
            continue
        depth = 0
        for i in range(start, len(text)):
            if text[i] == opener:
                depth += 1
            elif text[i] == closer:
                depth -= 1
                if depth == 0:
                    try:
                        return json.loads(text[start : i + 1])
                    except json.JSONDecodeError:
                        break
    return json.loads(text)  # raise with the original context
