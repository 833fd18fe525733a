"""Minimal MCP streamable-http client (the adapters' bridge half, C21).

Copy of ``ragfin_tpu/serving/mcp_client.py`` over the standard library's
``http.client`` (the JAX package uses ``httpx``, which a CUDA host need not have);
the wire behaviour is the same.

Hand-rolled MCP session flow with the same wire behavior as the reference's
adapter client (``adapters/vectorrag_adapter.py:33-113``): POST initialize →
capture ``mcp-session-id`` response header → POST notifications/initialized →
POST tools/call, parsing ``data:`` lines out of the SSE body and unwrapping
the tool-result text content.
"""

from __future__ import annotations

import http.client
import json
import threading
from typing import Any, Optional
from urllib.parse import urlsplit


class MCPClientError(RuntimeError):
    pass


def _parse_sse(body: str) -> dict:
    for line in body.splitlines():
        if line.startswith("data:"):
            return json.loads(line[len("data:") :].strip())
    # Plain JSON fallback
    try:
        return json.loads(body)
    except json.JSONDecodeError as e:
        raise MCPClientError(f"no data: line in response: {body[:200]}") from e


class _Reply:
    """Body text and headers of one POST."""

    __slots__ = ("text", "headers")

    def __init__(self, text: str, headers):
        self.text = text
        self.headers = headers


class MCPClient:
    def __init__(self, base_url: str, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.session_id: Optional[str] = None
        self._rpc_id = 0
        # The lock serializes the handshake and rpc-id bumps across the
        # adapter's handler threads (concurrent first requests raced
        # duplicate initializes).
        self._lock = threading.Lock()

    def _headers(self) -> dict:
        headers = {
            "Content-Type": "application/json",
            "Accept": "application/json, text/event-stream",
        }
        if self.session_id:
            headers["mcp-session-id"] = self.session_id
        return headers

    def _post(self, payload: dict) -> "_Reply":
        # http.client talks to the server directly: no proxy from the
        # environment is consulted for what is a local hop. An error status
        # still carries a JSON-RPC body the caller parses.
        url = urlsplit(self.base_url)
        conn = http.client.HTTPConnection(url.hostname, url.port, timeout=self.timeout)
        try:
            conn.request(
                "POST", f"{url.path}/mcp",
                body=json.dumps(payload).encode("utf-8"), headers=self._headers(),
            )
            resp = conn.getresponse()
            return _Reply(resp.read().decode("utf-8"), resp.headers)
        finally:
            conn.close()

    def _next_id(self) -> int:
        with self._lock:
            self._rpc_id += 1
            return self._rpc_id

    def _ensure_session(self) -> None:
        # Double-checked under the lock so concurrent first requests from
        # the adapter's handler threads perform exactly one handshake.
        if self.session_id is not None:
            return
        with self._lock:
            if self.session_id is None:
                self._initialize_locked()

    def _initialize_locked(self) -> dict:
        resp = self._post(
            {
                "jsonrpc": "2.0",
                "id": self._rpc_id + 1,
                "method": "initialize",
                "params": {
                    "protocolVersion": "2025-03-26",
                    "capabilities": {},
                    "clientInfo": {"name": "ragfin-adapter", "version": "1.0"},
                },
            }
        )
        self._rpc_id += 1
        self.session_id = resp.headers.get("mcp-session-id")
        result = _parse_sse(resp.text)
        # Complete the handshake.
        self._post({"jsonrpc": "2.0", "method": "notifications/initialized"})
        return result.get("result", {})

    def initialize(self) -> dict:
        with self._lock:
            return self._initialize_locked()

    def close(self) -> None:
        """Nothing is held open between requests."""

    def list_tools(self) -> list[dict]:
        self._ensure_session()
        resp = self._post(
            {"jsonrpc": "2.0", "id": self._next_id(), "method": "tools/list"}
        )
        return _parse_sse(resp.text).get("result", {}).get("tools", [])

    def call_tool(self, name: str, arguments: Optional[dict] = None) -> Any:
        self._ensure_session()
        resp = self._post(
            {
                "jsonrpc": "2.0",
                "id": self._next_id(),
                "method": "tools/call",
                "params": {"name": name, "arguments": arguments or {}},
            }
        )
        data = _parse_sse(resp.text)
        if "error" in data:
            raise MCPClientError(str(data["error"]))
        result = data.get("result", {})
        content = result.get("content", [])
        out: Any = result
        if content and content[0].get("type") == "text":
            try:
                out = json.loads(content[0]["text"])
            except json.JSONDecodeError:
                out = content[0]["text"]
        if result.get("isError"):
            # Spec: tool failure is signaled via isError, not a JSON-RPC
            # error — surfacing it as a successful return would let the
            # REST bridges serve error payloads as data with HTTP 200.
            raise MCPClientError(str(out))
        return out
