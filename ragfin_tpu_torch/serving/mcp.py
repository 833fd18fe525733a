"""MCP servers: vector RAG (:9006), graph RAG (:9007), monolith (:9008).

From-scratch MCP streamable-http implementation (no fastmcp in this image):
JSON-RPC 2.0 over POST with SSE-framed responses and the ``mcp-session-id``
handshake — exactly the wire behavior the reference's hand-rolled adapter
client expects (``adapters/vectorrag_adapter.py:33-113``: initialize →
capture session header → notifications/initialized → tools/call → parse
``data:`` lines).

Tool surfaces mirror the reference servers:
- vector (:9006, ``vector_rag_mcp/main.py:129-169``): health_check,
  search_vectors, answer_question, get_collection_stats
- graph (:9007, ``graph_rag_mcp/tools/``): health_check, get_server_info,
  extract_financial_entities, extract_and_save_to_graph,
  build_financial_graph, get_graph_stats, clear_graph_data,
  query_financial_graph, execute_fallback_query, generate_cypher_query
  (returns the device query *plan* — the Cypher-equivalent here)
- monolith (:9008, ``mcp_graph_rag/graph_rag_tools.py``): graph tools plus
  traverse_entity_relationships, compare_quarters, test_llm_providers,
  test_llm_generation
"""

from __future__ import annotations

import asyncio
import inspect
import json
import threading
import typing
import uuid
from typing import Any, Callable, Optional

from ..config.constants import SUPPORTED_MODELS
from ..data.models import FinancialChunk
from .engine import RagFinEngine, get_engine
from .httpd import AppServer, JsonApp, Request, Response

PROTOCOL_VERSION = "2025-03-26"

# One shared event loop on a dedicated thread for async tool bodies.
# Tool calls arrive on per-connection HTTP handler threads; running
# ``asyncio.run`` per call would spin up an event loop per request and let
# provider coroutines (and their RateLimiter state) interleave across many
# loops. A single long-lived loop serializes coroutine state while handler
# threads block only on their own future.
_loop_lock = threading.Lock()
_shared_loop: Optional[asyncio.AbstractEventLoop] = None


def _tool_loop() -> asyncio.AbstractEventLoop:
    global _shared_loop
    with _loop_lock:
        if _shared_loop is None or _shared_loop.is_closed():
            loop = asyncio.new_event_loop()
            threading.Thread(target=loop.run_forever, daemon=True, name="mcp-tool-loop").start()
            _shared_loop = loop
    return _shared_loop


def run_tool_coroutine(coro, timeout: float = 120.0):
    """Run an async tool body on the shared loop from any handler thread."""
    return asyncio.run_coroutine_threadsafe(coro, _tool_loop()).result(timeout=timeout)


class MCPToolServer:
    """JSON-RPC 2.0 MCP server with SSE responses over one POST endpoint."""

    def __init__(self, name: str, version: str = "1.0.0"):
        self.name = name
        self.version = version
        self.tools: dict[str, dict] = {}
        self.sessions: set[str] = set()
        self.app = JsonApp(name)
        self.app.post("/mcp")(self._endpoint)
        self.app.post("/mcp/")(self._endpoint)

    def tool(self, fn: Optional[Callable] = None, *, name: Optional[str] = None, description: str = ""):
        def register(func):
            tool_name = name or func.__name__
            sig = inspect.signature(func)
            # PEP 563 (`from __future__ import annotations`) makes
            # param.annotation a STRING — resolve to real types or every
            # parameter would be advertised as "string" and schema-driven
            # clients would send mistyped arguments.
            try:
                hints = typing.get_type_hints(func)
            except Exception:
                hints = {}
            properties = {}
            required = []
            for pname, param in sig.parameters.items():
                ann = hints.get(pname, param.annotation)
                if typing.get_origin(ann) is typing.Union:
                    # Optional[T] -> T for the schema type.
                    non_none = [a for a in typing.get_args(ann) if a is not type(None)]
                    if len(non_none) == 1:
                        ann = non_none[0]
                origin = typing.get_origin(ann) or ann
                jtype = {int: "integer", float: "number", bool: "boolean", str: "string",
                         list: "array", dict: "object"}.get(origin, "string")
                properties[pname] = {"type": jtype}
                if param.default is inspect.Parameter.empty:
                    required.append(pname)
            self.tools[tool_name] = {
                "fn": func,
                "description": description or (func.__doc__ or "").strip(),
                "inputSchema": {"type": "object", "properties": properties, "required": required},
            }
            return func

        return register(fn) if fn is not None else register

    # --- protocol ---------------------------------------------------------
    def _endpoint(self, request: Request) -> Response:
        msg = request.json or {}
        if not isinstance(msg, dict):
            # A JSON-RPC batch array (or any non-object body) is not
            # supported — answer with the spec's Invalid Request instead of
            # crashing into a generic 500.
            return Response.json(
                {"jsonrpc": "2.0", "id": None,
                 "error": {"code": -32600, "message": "Invalid Request: expected a JSON-RPC object"}},
                status=400,
            )
        method = msg.get("method")
        msg_id = msg.get("id")
        if method == "initialize":
            session = uuid.uuid4().hex
            if len(self.sessions) > 1024:  # bound memory for reconnecting clients
                self.sessions.clear()
            self.sessions.add(session)
            result = {
                "protocolVersion": PROTOCOL_VERSION,
                "capabilities": {"tools": {"listChanged": False}},
                "serverInfo": {"name": self.name, "version": self.version},
            }
            return Response.sse(
                {"jsonrpc": "2.0", "id": msg_id, "result": result},
                headers={"mcp-session-id": session},
            )
        if method == "notifications/initialized":
            return Response(202, b"", "application/json")
        if method == "tools/list":
            tools = [
                {"name": n, "description": t["description"], "inputSchema": t["inputSchema"]}
                for n, t in self.tools.items()
            ]
            return Response.sse({"jsonrpc": "2.0", "id": msg_id, "result": {"tools": tools}})
        if method == "tools/call":
            params = msg.get("params") or {}
            name = params.get("name")
            arguments = params.get("arguments") or {}
            tool = self.tools.get(name)
            if tool is None:
                return Response.sse(
                    {"jsonrpc": "2.0", "id": msg_id,
                     "error": {"code": -32602, "message": f"unknown tool {name}"}}
                )
            is_error = False
            try:
                out = tool["fn"](**arguments)
                if asyncio.iscoroutine(out):
                    out = run_tool_coroutine(out)
            except Exception as e:
                out = {"success": False, "error": str(e)}
                is_error = True  # spec clients detect failure via isError
            content = [{"type": "text", "text": json.dumps(out, ensure_ascii=False, default=str)}]
            return Response.sse(
                {"jsonrpc": "2.0", "id": msg_id, "result": {"content": content, "isError": is_error}}
            )
        return Response.sse(
            {"jsonrpc": "2.0", "id": msg_id, "error": {"code": -32601, "message": f"unknown method {method}"}}
        )

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> AppServer:
        return AppServer(self.app, host, port)


# ---------------------------------------------------------------------------
# Vector RAG MCP server (:9006)
# ---------------------------------------------------------------------------


def build_vector_mcp(engine: Optional[RagFinEngine] = None) -> MCPToolServer:
    engine = engine or get_engine()
    server = MCPToolServer("vector-rag-tpu")

    @server.tool(description="Deep health check: index entity count + provider status")
    def health_check():
        return engine.health()

    @server.tool(description="Semantic search over financial chunks; returns scored chunks")
    def search_vectors(query: str, top_k: int = 3):
        return {"success": True, "query": query, "results": engine.vector_rag.search(query, top_k)}

    @server.tool(description="Retrieve top-k chunks and answer the question")
    async def answer_question(question: str, top_k: int = 3):
        out = await engine.vector_rag.search_and_answer(question, top_k)
        return {"success": True, **out}

    @server.tool(description="Vector collection statistics")
    def get_collection_stats():
        from ..utils.profiling import METRICS

        metrics = METRICS.summary()
        batcher = {
            k: v for k, v in metrics.get("counters", {}).items() if k.startswith("batcher.")
        }
        batcher.update(
            {k: v for k, v in metrics.get("latency_ms", {}).items() if k.startswith("batcher.")}
        )
        return {
            "success": True,
            **engine.vector_index.stats(),
            "batching_enabled": engine.batcher is not None,
            "batcher": batcher,
        }

    return server


# ---------------------------------------------------------------------------
# Graph RAG MCP server (:9007) + monolith extras (:9008)
# ---------------------------------------------------------------------------


def build_graph_mcp(engine: Optional[RagFinEngine] = None, monolith: bool = False) -> MCPToolServer:
    engine = engine or get_engine()
    server = MCPToolServer("graph-rag-tpu-monolith" if monolith else "graph-rag-tpu")

    @server.tool(description="Deep health check for graph service dependencies")
    def health_check():
        return engine.health()

    @server.tool(description="Server info: tools, model, config validation")
    def get_server_info():
        return {
            "name": server.name,
            "version": server.version,
            "tools": sorted(server.tools),
            "extraction_model": engine.graph_builder.current_model,
            "supported_models": sorted(SUPPORTED_MODELS),
            "config_issues": engine.settings.validate(),
        }

    @server.tool(description="Extract financial entities from chunk text")
    async def extract_financial_entities(chunk_text: str, chunk_id: str = "adhoc", period: str = "Q1_FY2024"):
        chunk = FinancialChunk(id=chunk_id, period=period, type="adhoc", size=len(chunk_text), text=chunk_text)
        entities = await engine.graph_builder.extractor.extract(chunk)
        return {"success": True, "entities": entities.model_dump(), "entity_count": entities.total_count()}

    @server.tool(description="Extract entities from chunk text and save to the graph")
    async def extract_and_save_to_graph(chunk_text: str, chunk_id: str = "adhoc",
                                        period: str = "Q1_FY2024", dataset_id: str = "icici_fy2024"):
        chunk = FinancialChunk(id=chunk_id, period=period, type="adhoc", size=len(chunk_text), text=chunk_text)
        entities = await engine.graph_builder.extractor.extract(chunk)
        saved = engine.graph.save_entities(entities, chunk_id, dataset_id)
        return {"success": bool(saved), "entities_saved": saved, "quarter": entities.quarter}

    @server.tool(description="Build the knowledge graph from a list of chunks")
    async def build_financial_graph(chunks: list, dataset_id: str = "icici_fy2024", clear_existing: bool = False):
        return await engine.graph_builder.build(chunks, dataset_id, clear_existing)

    @server.tool(description="Graph statistics: node counts per type and per quarter")
    def get_graph_stats():
        return {"success": True, **engine.graph.stats()}

    @server.tool(description="Clear graph data for a dataset (or all)")
    def clear_graph_data(dataset_id: str = ""):
        engine.graph.clear_data(dataset_id or None)
        return {"success": True, "cleared": dataset_id or "all"}

    @server.tool(description="Natural-language query against the knowledge graph")
    async def query_financial_graph(question: str, limit: int = 10):
        out = await engine.graph_builder.query_engine.query(question, limit)
        return {"success": True, "question": question, "results": out["results"],
                "result_count": len(out["results"]), "plan": out["plan"], "fallback": out["fallback"]}

    @server.tool(description="Run the safe fallback query (latest metrics)")
    def execute_fallback_query(limit: int = 10):
        fb = engine.graph_builder.query_engine.fallback_plan(limit)
        results = engine.graph_builder.query_engine._execute(fb)
        return {"success": True, "results": results, "result_count": len(results)}

    @server.tool(description="Generate the device query plan for a question (Cypher-equivalent)")
    async def generate_cypher_query(question: str, limit: int = 10):
        out = await engine.graph_builder.query_engine.query(question, limit)
        return {"success": True, "plan": out["plan"],
                "note": "device query plan; this framework executes plans on-device instead of Cypher"}

    if monolith:

        @server.tool(description="Hybrid vector+graph retrieval with on-device fusion")
        async def hybrid_query(question: str, vector_k: int = 10, k_out: int = 20):
            out = await engine.hybrid.hybrid_query(question, vector_k=vector_k, k_out=k_out)
            return {"success": True, **out}

        @server.tool(description="Execute a raw JSON query plan against the graph (execute_raw_cypher equivalent)")
        def execute_raw_plan(plan: dict):
            results = engine.graph_builder.query_engine._execute(plan or {})
            return {"success": True, "results": results, "result_count": len(results)}

        @server.tool(description="Per-entity cross-type co-occurrence by quarter")
        def traverse_entity_relationships(entity_name: str, limit: int = 50):
            rows = engine.graph.expand([entity_name], limit=limit)
            by_quarter: dict[str, list] = {}
            for r in rows:
                by_quarter.setdefault(r["quarter"], []).append(r)
            return {"success": True, "entity": entity_name, "related_by_quarter": by_quarter,
                    "result_count": len(rows)}

        @server.tool(description="Compare two quarters: growth metrics + segments + sequential growth rates")
        def compare_quarters(quarter1: str, quarter2: str):
            from ..index.graph_index import METRIC, SEGMENT

            out: dict[str, Any] = {"success": True, "quarter1": quarter1, "quarter2": quarter2}
            metrics = {}
            for name in ("NET PROFIT", "Operating Profit", "Total Income"):
                rows = engine.graph.match(quarters=[quarter1, quarter2], names=[name], types=[METRIC])
                vals = {r["quarter"]: r["value"] for r in rows}
                # value can be a stored None (NaN facts) — skip the metric
                # rather than crash the whole tool on subtraction.
                if vals.get(quarter1) and vals.get(quarter2) is not None:
                    growth = (vals[quarter2] - vals[quarter1]) / vals[quarter1] * 100
                    metrics[name] = {quarter1: vals[quarter1], quarter2: vals[quarter2],
                                     "growth_pct": round(growth, 2)}
            segments = {}
            rows = engine.graph.match(quarters=[quarter1, quarter2], types=[SEGMENT], limit=64)
            for r in rows:
                segments.setdefault(r["segment_name"], {})[r["quarter"]] = r["revenue"]
            out["metrics"] = metrics
            out["segments"] = segments
            return out

        @server.tool(description="List provider availability and configured keys")
        def test_llm_providers():
            s = engine.settings
            return {
                "success": True,
                "providers": {
                    "gemini": bool(s.gemini_api_key),
                    "openai": bool(s.openai_api_key),
                    "groq": bool(s.groq_api_key),
                    "fake": True,
                },
                "default_model": s.default_model,
            }

        @server.tool(description="Round-trip a test generation through the active provider")
        async def test_llm_generation(prompt: str = "Reply with OK"):
            if engine.provider is None:
                return {"success": True, "model": "offline", "response": "OK (offline deterministic)"}
            try:
                text = await engine.provider.generate_content(prompt)
                return {"success": True, "model": engine.provider.model_name, "response": text[:500]}
            except Exception as e:
                return {"success": False, "error": str(e)}

    return server
