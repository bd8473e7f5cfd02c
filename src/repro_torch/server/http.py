"""Minimal HTTP/1.1 over asyncio streams — the gateway's wire layer.

Deliberately dependency-light (stdlib only, no FastAPI/uvicorn) so
tier-1 stays runnable in a bare venv: request parsing with
Content-Length bodies, keep-alive responses, and Server-Sent Events
framing for per-token streaming. Chunked transfer encoding is refused
(nothing in the gateway needs it) and header/body sizes are bounded.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional
from urllib.parse import parse_qs, unquote

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 8 * 1024 * 1024

STATUS_TEXT = {
    200: "OK", 201: "Created", 202: "Accepted", 204: "No Content",
    400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
    409: "Conflict", 413: "Payload Too Large",
    429: "Too Many Requests", 500: "Internal Server Error",
    503: "Service Unavailable",
}


class BadRequest(Exception):
    """Malformed or unsupported HTTP input; rendered as a 400."""


@dataclasses.dataclass
class HttpRequest:
    method: str
    target: str                       # raw request-target
    path: str                         # decoded path, no query string
    query: Dict[str, str]             # first value per key
    headers: Dict[str, str]           # keys lower-cased
    body: bytes

    def json(self) -> dict:
        if not self.body:
            return {}
        try:
            obj = json.loads(self.body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise BadRequest(f"invalid JSON body: {e}") from None
        if not isinstance(obj, dict):
            raise BadRequest("JSON body must be an object")
        return obj

    @property
    def wants_keepalive(self) -> bool:
        return self.headers.get("connection", "").lower() != "close"


async def read_request(reader) -> Optional[HttpRequest]:
    """Parse one request off the stream; None on a clean EOF (client
    closed between requests), ``BadRequest`` on malformed input."""
    try:
        line = await reader.readline()
    except (ConnectionError, EOFError):
        return None
    if not line:
        return None
    if len(line) > MAX_HEADER_BYTES:
        raise BadRequest("request line too long")
    parts = line.decode("latin-1").strip().split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/"):
        raise BadRequest(f"malformed request line: {line!r}")
    method, target, _version = parts
    headers: Dict[str, str] = {}
    total = 0
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n"):
            break
        if not h:
            raise BadRequest("EOF inside header block")
        total += len(h)
        if total > MAX_HEADER_BYTES:
            raise BadRequest("header block too large")
        key, sep, value = h.decode("latin-1").partition(":")
        if not sep:
            raise BadRequest(f"malformed header line: {h!r}")
        headers[key.strip().lower()] = value.strip()
    if "chunked" in headers.get("transfer-encoding", "").lower():
        raise BadRequest("chunked transfer encoding not supported")
    length = headers.get("content-length", "")
    try:
        n = int(length) if length else 0
    except ValueError:
        raise BadRequest(f"bad Content-Length: {length!r}") from None
    if n < 0 or n > MAX_BODY_BYTES:
        raise BadRequest(f"body of {n} bytes out of bounds")
    body = await reader.readexactly(n) if n else b""
    raw_path, _, raw_query = target.partition("?")
    query = {k: vs[0] for k, vs in parse_qs(raw_query).items()}
    return HttpRequest(method=method.upper(), target=target,
                       path=unquote(raw_path), query=query,
                       headers=headers, body=body)


def response_bytes(status: int, body=b"", *,
                   content_type: str = "application/json",
                   headers: Optional[Dict[str, str]] = None,
                   close: bool = False) -> bytes:
    """One complete keep-alive-friendly response. ``body`` may be
    bytes, str, or a JSON-serializable object."""
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode("utf-8")
    elif isinstance(body, str):
        body = body.encode("utf-8")
    text = STATUS_TEXT.get(status, "Unknown")
    lines = [f"HTTP/1.1 {status} {text}",
             f"Content-Type: {content_type}",
             f"Content-Length: {len(body)}",
             f"Connection: {'close' if close else 'keep-alive'}"]
    for k, v in (headers or {}).items():
        lines.append(f"{k}: {v}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body


def sse_headers() -> bytes:
    """Response head opening a Server-Sent Events stream. No
    Content-Length — the stream is delimited by connection close."""
    return (b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Connection: close\r\n\r\n")


def sse_event(data) -> bytes:
    """One SSE frame. ``data`` may be a JSON-serializable object or a
    literal string (e.g. the ``[DONE]`` sentinel)."""
    if not isinstance(data, str):
        data = json.dumps(data)
    return f"data: {data}\n\n".encode("utf-8")
