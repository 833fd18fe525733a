"""Minimal threaded JSON HTTP server (stdlib only).

The reference serves over FastAPI + uvicorn; neither is installed in this
image, so the serving layer runs on ``http.server.ThreadingHTTPServer`` with
a small JSON routing shim. Handlers receive a :class:`Request` and return a
dict (→ 200 JSON), a ``(status, dict)`` tuple, or a :class:`Response` for
full control (used by the MCP server's SSE responses).
"""

from __future__ import annotations

import json
import re
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional
from urllib.parse import parse_qs, unquote, urlparse


@dataclass
class Request:
    method: str
    path: str
    params: dict[str, str]
    query: dict[str, str]
    json: Any
    headers: dict[str, str]


@dataclass
class Response:
    status: int = 200
    body: bytes = b""
    content_type: str = "application/json"
    headers: dict[str, str] = field(default_factory=dict)

    @classmethod
    def json(cls, payload: Any, status: int = 200, headers: Optional[dict] = None) -> "Response":
        return cls(status, json.dumps(payload, ensure_ascii=False).encode(), "application/json", headers or {})

    @classmethod
    def sse(cls, payload: Any, status: int = 200, headers: Optional[dict] = None) -> "Response":
        data = json.dumps(payload, ensure_ascii=False)
        return cls(status, f"event: message\ndata: {data}\n\n".encode(), "text/event-stream", headers or {})


Handler = Callable[[Request], Any]


class JsonApp:
    """Route table: method + path pattern with ``{param}`` captures."""

    def __init__(self, name: str = "app"):
        self.name = name
        self.routes: list[tuple[str, re.Pattern, Handler]] = []

    def route(self, method: str, pattern: str):
        # Escape the literal path segments: an unescaped '.' or '+' in a
        # route would compile as a regex metachar and over-match.
        parts = re.split(r"(\{\w+\})", pattern)
        built = "".join(
            rf"(?P<{p[1:-1]}>[^/]+)" if p.startswith("{") else re.escape(p)
            for p in parts
        )
        regex = re.compile("^" + built + "$")

        def register(fn: Handler) -> Handler:
            self.routes.append((method.upper(), regex, fn))
            return fn

        return register

    def get(self, pattern: str):
        return self.route("GET", pattern)

    def post(self, pattern: str):
        return self.route("POST", pattern)

    def delete(self, pattern: str):
        return self.route("DELETE", pattern)

    def dispatch(self, request: Request) -> Response:
        for method, regex, fn in self.routes:
            if method != request.method:
                continue
            m = regex.match(request.path)
            if not m:
                continue
            # Percent-decode path params ({param} captures) the same way
            # parse_qs decodes query params — an encoded id like
            # "my%20dataset" must target the stored "my dataset" key.
            request.params = {k: unquote(v) for k, v in m.groupdict().items()}
            try:
                out = fn(request)
                # Serialization stays INSIDE the try: a non-JSON-serializable
                # return (e.g. a numpy scalar) must become a 500, not a
                # dropped connection.
                if isinstance(out, Response):
                    return out
                if isinstance(out, tuple):
                    return Response.json(out[1], out[0])
                return Response.json(out)
            except HTTPError as e:
                return Response.json({"error": e.detail}, e.status)
            except Exception as e:  # failure-to-status at every boundary
                return Response.json({"error": str(e)}, 500)
        return Response.json({"error": f"no route for {request.method} {request.path}"}, 404)


class HTTPError(Exception):
    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


def _make_handler(app: JsonApp):
    class _Handler(BaseHTTPRequestHandler):
        # A stalled client (Content-Length promised, bytes never sent) must
        # not pin a handler thread forever; 30 s covers slow LANs.
        timeout = 30
        # Cap request bodies: an attacker-sized Content-Length must not
        # buffer gigabytes (chunk payloads are << 16 MB).
        MAX_BODY = 16 * 1024 * 1024
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _handle(self):
            try:
                self._handle_inner()
            except Exception:
                # Last-resort guard: a transport-level surprise (malformed
                # Content-Length, client disconnect mid-write) must not
                # crash the handler thread without a response attempt.
                try:
                    self.send_error(500)
                except Exception:
                    pass

        def _handle_inner(self):
            parsed = urlparse(self.path)
            query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                length = 0
            if length > self.MAX_BODY:
                self.send_error(413, "request body too large")
                return
            raw = self.rfile.read(length) if length else b""
            try:
                body = json.loads(raw) if raw else None
            except json.JSONDecodeError:
                body = None
            request = Request(
                method=self.command,
                path=parsed.path,
                params={},
                query=query,
                json=body,
                headers={k.lower(): v for k, v in self.headers.items()},
            )
            response = app.dispatch(request)
            self.send_response(response.status)
            self.send_header("Content-Type", response.content_type)
            self.send_header("Content-Length", str(len(response.body)))
            self.send_header("Access-Control-Allow-Origin", "*")
            for key, value in response.headers.items():
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(response.body)

        def do_OPTIONS(self):
            # CORS preflight: the ACAO header on responses promises
            # cross-origin access; without this, browsers' preflight hits
            # BaseHTTPRequestHandler's default 501 and every cross-origin
            # JSON POST fails.
            self.send_response(204)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "GET, POST, PUT, DELETE, OPTIONS")
            self.send_header("Access-Control-Allow-Headers", "Content-Type, mcp-session-id")
            self.send_header("Content-Length", "0")
            self.end_headers()

        do_GET = do_POST = do_DELETE = do_PUT = _handle

    return _Handler


class _Server(ThreadingHTTPServer):
    # socketserver's default accept backlog of 5 drops connections under
    # concurrent load (measured: 7/691 resets at 32 parallel clients in the
    # 1M serving_concurrent benchmark); listen() deeper.
    request_queue_size = 128


class AppServer:
    """Threaded server wrapper with background start/stop (for tests too)."""

    def __init__(self, app: JsonApp, host: str = "127.0.0.1", port: int = 0):
        self.app = app
        self.httpd = _Server((host, port), _make_handler(app))
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start_background(self) -> "AppServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
