"""Tool-call postprocessor: function calls parsed out of generated text
(port of `dynamo_tpu/llm/postprocessor.py`).

Model families emit tool calls in different wire formats; the parsers
normalise them into OpenAI `tool_calls` entries:

- hermes:  <tool_call>{"name": ..., "arguments": {...}}</tool_call>
- mistral: [TOOL_CALLS][{"name": ..., "arguments": {...}}, ...]
- llama3_json / plain JSON: the whole completion is one call object or a
  list of them ({"name": ..., "arguments"|"parameters": {...}})
- "auto" tries each in that order.

Unparseable text returns (text, []): the completion stays a normal
assistant message, never an error.  `StreamingToolCallParser` does the
same incrementally for SSE streams; any chunking of a string gives its
one-shot parse.
"""

from __future__ import annotations

import json
import re
import uuid
from typing import Any, Dict, List, Optional, Tuple

HERMES_RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.DOTALL)
MISTRAL_TAG = "[TOOL_CALLS]"


def _call_entry(name: str, arguments: Any) -> Dict[str, Any]:
    if not isinstance(arguments, str):
        arguments = json.dumps(arguments)
    return {
        "id": f"call_{uuid.uuid4().hex[:24]}",
        "type": "function",
        "function": {"name": name, "arguments": arguments},
    }


def _from_obj(obj: Any) -> Optional[Dict[str, Any]]:
    if not isinstance(obj, dict) or "name" not in obj:
        return None
    args = obj.get("arguments", obj.get("parameters", {}))
    return _call_entry(obj["name"], args)


def _parse_hermes(text: str):
    calls = []
    for m in HERMES_RE.finditer(text):
        try:
            entry = _from_obj(json.loads(m.group(1)))
        except json.JSONDecodeError:
            continue
        if entry:
            calls.append(entry)
    if not calls:
        return text, []
    content = HERMES_RE.sub("", text).strip()
    return content, calls


def _parse_mistral(text: str):
    idx = text.find(MISTRAL_TAG)
    if idx < 0:
        return text, []
    payload = text[idx + len(MISTRAL_TAG):].strip()
    try:
        data = json.loads(payload)
    except json.JSONDecodeError:
        return text, []
    if isinstance(data, dict):
        data = [data]
    calls = [e for e in (_from_obj(o) for o in data) if e]
    if not calls:
        return text, []  # keep the full text: nothing valid was extracted
    return text[:idx].strip(), calls


def _parse_json(text: str):
    stripped = text.strip()
    # Fenced model output (```json ... ```) is common; unwrap it.
    if stripped.startswith("```"):
        stripped = re.sub(r"^```(?:json)?\s*|\s*```$", "", stripped,
                          flags=re.DOTALL).strip()
    if not (stripped.startswith("{") or stripped.startswith("[")):
        return text, []
    try:
        data = json.loads(stripped)
    except json.JSONDecodeError:
        return text, []
    if isinstance(data, dict):
        data = [data]
    if not isinstance(data, list):
        return text, []
    calls = [e for e in (_from_obj(o) for o in data) if e]
    if calls and len(calls) == len(data):
        return "", calls
    return text, []


PARSERS = {
    "hermes": _parse_hermes,
    "mistral": _parse_mistral,
    "json": _parse_json,
    "llama3_json": _parse_json,
}


def forced_tool_name(tool_choice: Any,
                     tools: Optional[List[Dict[str, Any]]]) -> Optional[str]:
    """The function name a `tool_choice` value forces, if any.

    `{"type": "function", "function": {"name": ...}}` pins that name;
    `"required"` with exactly one declared tool pins that tool (with
    several tools the model still chooses — nothing to force here).
    """
    if isinstance(tool_choice, dict):
        return (tool_choice.get("function") or {}).get("name")
    if tool_choice == "required" and tools and len(tools) == 1:
        return (tools[0].get("function") or {}).get("name")
    return None


def force_tool_call(text: str, name: str) -> List[Dict[str, Any]]:
    """Wrap a completion as ONE call to `name` (forced tool_choice: the
    whole generation is the arguments payload, OpenAI semantics — no
    marker syntax expected from the model)."""
    return [_call_entry(name, text)]


class StreamingToolCallParser:
    """Incremental tool-call extraction for SSE chat streams.

    Mirrors the unary `parse_tool_calls` matrix, but emits OpenAI-spec
    `delta.tool_calls` entries mid-stream: the first delta of call `i`
    carries `index`/`id`/`type`/`function.name` (arguments ""), then
    argument fragments follow as `{"index": i, "function":
    {"arguments": ...}}`.

    Strategy per format:
    - hermes: text streams through as content; `<tool_call>` starts a
      capture that is parsed and emitted the moment `</tool_call>`
      closes — truly incremental for multi-call generations.
    - mistral `[TOOL_CALLS]` and bare-JSON completions: the payload is
      one JSON document, unparseable until complete, so it buffers to
      end-of-stream and the calls are emitted from `finish()`.
    - a tail that might still grow into a marker (e.g. "<tool") is
      jailed, exactly like the stop-sequence jail in the detokenizer.
    - `forced_name` (pinned tool_choice): no marker syntax expected —
      the header delta goes out at the first token and every text chunk
      streams as an arguments fragment.
    """

    _HERMES_OPEN = "<tool_call>"
    _HERMES_CLOSE = "</tool_call>"

    def __init__(self, fmt: str = "auto",
                 forced_name: Optional[str] = None) -> None:
        if fmt != "auto" and fmt not in PARSERS:
            raise ValueError(f"unknown tool-call format {fmt!r}; "
                             f"have {sorted(PARSERS)} or 'auto'")
        self.fmt = fmt
        self.forced_name = forced_name
        self.calls_emitted = 0
        self._jail = ""            # possible marker prefix, held back
        self._capture = ""         # text inside an active capture
        self._capturing: Optional[str] = None   # None|"hermes"|"tail"
        self._started = False      # saw any non-whitespace yet
        self._forced_index: Optional[int] = None
        if fmt == "hermes":
            self._markers = (self._HERMES_OPEN,)
        elif fmt == "mistral":
            self._markers = (MISTRAL_TAG,)
        elif fmt == "auto":
            self._markers = (self._HERMES_OPEN, MISTRAL_TAG)
        else:                      # json family: no mid-stream markers
            self._markers = ()

    # -- emission helpers -------------------------------------------------

    def _emit_calls(self, calls: List[Dict[str, Any]]
                    ) -> List[Dict[str, Any]]:
        out = []
        for c in calls:
            idx = self.calls_emitted
            self.calls_emitted += 1
            out.append({"index": idx, "id": c["id"], "type": "function",
                        "function": {"name": c["function"]["name"],
                                     "arguments": ""}})
            args = c["function"]["arguments"]
            if args:
                out.append({"index": idx,
                            "function": {"arguments": args}})
        return out

    def _forced_header(self) -> Dict[str, Any]:
        self._forced_index = self.calls_emitted
        self.calls_emitted += 1
        entry = _call_entry(self.forced_name, "")
        return {"index": self._forced_index, "id": entry["id"],
                "type": "function",
                "function": {"name": self.forced_name, "arguments": ""}}

    def _marker_jail(self, text: str) -> Tuple[str, str]:
        """Split off the longest tail that is a proper prefix of a
        marker (it may still complete in the next chunk)."""
        max_hold = max((len(m) for m in self._markers), default=1) - 1
        for k in range(min(max_hold, len(text)), 0, -1):
            tail = text[-k:]
            if any(m.startswith(tail) for m in self._markers):
                return text[:-k], tail
        return text, ""

    # -- the incremental API ----------------------------------------------

    def push(self, text: str) -> Tuple[str, List[Dict[str, Any]]]:
        """Feed a content delta; returns (releasable_content, deltas)."""
        if self.forced_name is not None:
            deltas = []
            if self._forced_index is None:
                deltas.append(self._forced_header())
            if text:
                deltas.append({"index": self._forced_index,
                               "function": {"arguments": text}})
            return "", deltas

        deltas: List[Dict[str, Any]] = []
        content: List[str] = []
        work = self._jail + text
        self._jail = ""
        while work:
            if self._capturing == "tail":
                self._capture += work
                break
            if self._capturing == "hermes":
                self._capture += work
                end = self._capture.find(self._HERMES_CLOSE)
                if end == -1:
                    break
                seg = self._capture[: end + len(self._HERMES_CLOSE)]
                work = self._capture[end + len(self._HERMES_CLOSE):]
                self._capture = ""
                self._capturing = None
                # Malformed JSON inside the markers: the unary parser
                # keeps the segment as content, so the stream must too
                # (rest == "" whenever the parse succeeded).
                rest, calls = _parse_hermes(seg)
                content.append(rest)
                deltas.extend(self._emit_calls(calls))
                continue
            if not self._started:
                stripped = work.lstrip()
                if not stripped:
                    self._jail = work   # pure whitespace: defer verdict
                    break
                self._started = True
                # A JSON-looking stream head means the WHOLE completion
                # may be one tool-call document: buffer to the end (the
                # unary parser decides at finish).
                if self.fmt in ("json", "llama3_json") or (
                        self.fmt == "auto" and stripped[0] in "{[`"):
                    self._capturing = "tail"
                    continue
            found = [(work.find(m), m) for m in self._markers
                     if m in work]
            if found:
                pos, marker = min(found)
                content.append(work[:pos])
                work = work[pos:]
                if marker == self._HERMES_OPEN:
                    self._capturing = "hermes"
                else:               # [TOOL_CALLS]: buffer to end
                    self._capturing = "tail"
                continue
            release, self._jail = self._marker_jail(work)
            content.append(release)
            break
        return "".join(content), deltas

    def finish(self) -> Tuple[str, List[Dict[str, Any]], bool]:
        """End of stream: flush buffers.  Returns (content, deltas,
        any_calls) — `any_calls` decides the `tool_calls` finish_reason."""
        if self.forced_name is not None:
            deltas = ([self._forced_header()]
                      if self._forced_index is None else [])
            return "", deltas, True
        leftover = self._jail
        self._jail = ""
        if self._capturing == "tail":
            fmt = self.fmt if self.fmt in PARSERS else "auto"
            text, calls = parse_tool_calls(self._capture + leftover, fmt)
        elif self._capturing == "hermes":
            # Unterminated <tool_call>: nothing parseable — the capture
            # is plain content after all.
            text, calls = self._capture + leftover, []
        else:
            text, calls = leftover, []
        self._capture = ""
        self._capturing = None
        deltas = self._emit_calls(calls)
        return text, deltas, self.calls_emitted > 0


def parse_tool_calls(text: str, fmt: str = "auto"
                     ) -> Tuple[str, List[Dict[str, Any]]]:
    """Returns (remaining_content, tool_calls).  tool_calls empty when
    nothing parses — the text passes through untouched."""
    if fmt != "auto":
        parser = PARSERS.get(fmt)
        if parser is None:
            raise ValueError(f"unknown tool-call format {fmt!r}; "
                             f"have {sorted(PARSERS)} or 'auto'")
        return parser(text)
    for parser in (_parse_hermes, _parse_mistral, _parse_json):
        content, calls = parser(text)
        if calls:
            return content, calls
    return text, []
