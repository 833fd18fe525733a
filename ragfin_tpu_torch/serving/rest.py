"""REST services and REST→MCP adapters (C17, C21).

Four apps with the reference's endpoint surfaces:

- **Entity service** (:8001, ``FinRag_knowledge_graph/entity/api.py:22-104``):
  ``POST /api/v1/extract``, ``POST /api/v1/extract/batch``,
  ``POST /api/v1/model/switch``, ``GET /api/v1/models``, ``GET /health``.
- **Graph service** (:8002, ``FinRag_knowledge_graph/graph/api.py:9-67``):
  ``POST /api/v1/build``, ``POST /api/v1/query``, ``GET /api/v1/stats``,
  ``DELETE /api/v1/clear/{dataset_id}``, ``GET /health``,
  ``GET /quick-stats``.
- **Vector adapter** (:9001, ``adapters/vectorrag_adapter.py:134-164``):
  ``POST /search``, ``POST /answer``, ``GET /stats``, ``GET /health`` —
  bridged to the vector MCP server through the MCP client.
- **Graph adapter** (:9002, ``adapters/graphrag_adapter.py:141-183``):
  ``POST /extract``, ``POST /build``, ``POST /query``, ``GET /stats``,
  ``POST /clear`` — bridged to the graph MCP server.
"""

from __future__ import annotations

import time
from typing import Optional

from ..config.constants import SUPPORTED_MODELS
from ..data.models import FinancialChunk, GraphQueryRequest
from .engine import RagFinEngine, get_engine
from .httpd import HTTPError, JsonApp, Request
from .mcp import run_tool_coroutine
from .mcp_client import MCPClient




def _body(request: Request) -> dict:
    """Request body as a JSON object; a non-object body (e.g. a bare list)
    is a 422, not an AttributeError-turned-500."""
    body = request.json
    if body is None:
        return {}
    if not isinstance(body, dict):
        raise HTTPError(422, "request body must be a JSON object")
    return body


# ---------------------------------------------------------------------------
# Entity service (:8001)
# ---------------------------------------------------------------------------


def build_entity_app(engine: Optional[RagFinEngine] = None) -> JsonApp:
    engine = engine or get_engine()
    app = JsonApp("entity-service")

    def _chunk_from(payload: dict) -> FinancialChunk:
        if payload is None:
            raise HTTPError(422, "JSON body required")
        if "text" in payload and "id" not in payload:
            payload = {
                "id": "adhoc",
                "period": payload.get("period", "Q1_FY2024"),
                "type": payload.get("type", "adhoc"),
                "size": len(payload["text"]),
                "text": payload["text"],
            }
        try:
            return FinancialChunk.model_validate(payload)
        except Exception as e:
            raise HTTPError(422, f"invalid chunk: {e}")

    @app.post("/api/v1/extract")
    def extract(request: Request):
        chunk = _chunk_from(_body(request).get("chunk", request.json))
        t0 = time.perf_counter()
        entities = run_tool_coroutine(engine.graph_builder.extractor.extract(chunk))
        return {
            "success": True,
            "chunk_id": chunk.id,
            "entities": entities.model_dump(),
            "entity_count": entities.total_count(),
            "extraction_time": time.perf_counter() - t0,
            "model": engine.graph_builder.current_model,
        }

    @app.post("/api/v1/extract/batch")
    def extract_batch(request: Request):
        raw_chunks = _body(request).get("chunks", [])
        if not isinstance(raw_chunks, list):
            raise HTTPError(422, "'chunks' must be a list")
        results, failed = [], []
        for i, raw in enumerate(raw_chunks):
            # Per-chunk validation: one malformed chunk must not 422 the
            # whole batch (mirrors the graph build endpoint's per-chunk
            # failure accounting).
            try:
                chunk = _chunk_from(raw)
                entities = run_tool_coroutine(engine.graph_builder.extractor.extract(chunk))
            except HTTPError as e:
                cid = raw.get("id") if isinstance(raw, dict) else None
                failed.append({"index": i, "chunk_id": cid, "error": e.detail})
                continue
            results.append(
                {"chunk_id": chunk.id, "entities": entities.model_dump(), "entity_count": entities.total_count()}
            )
        out = {"success": True, "processed": len(results), "results": results}
        if failed:
            out["failed"] = failed
        return out

    @app.post("/api/v1/model/switch")
    def model_switch(request: Request):
        model = _body(request).get("model")
        if model not in SUPPORTED_MODELS and model != "rule-based":
            raise HTTPError(400, f"unsupported model '{model}'")
        if model == "rule-based":
            from ..extraction.service import RuleBasedExtractor

            engine.graph_builder.extractor = RuleBasedExtractor()
        else:
            engine.graph_builder.switch_extraction_model(
                model, engine.settings.get_api_key_for_model(model)
            )
        return {"success": True, "model": model}

    @app.get("/api/v1/models")
    def models(request: Request):
        return {
            "models": sorted(SUPPORTED_MODELS) + ["rule-based"],
            "current": engine.graph_builder.current_model,
        }

    @app.get("/health")
    def health(request: Request):
        h = engine.health()
        return {"status": h["status"], "entity_service_available": True, "model": h["extraction_model"]}

    return app


# ---------------------------------------------------------------------------
# Graph service (:8002)
# ---------------------------------------------------------------------------


def build_graph_app(engine: Optional[RagFinEngine] = None) -> JsonApp:
    engine = engine or get_engine()
    app = JsonApp("graph-service")

    @app.post("/api/v1/build")
    def build(request: Request):
        payload = _body(request)
        chunks = payload.get("chunks", [])
        result = run_tool_coroutine(
            engine.graph_builder.build(
                chunks,
                dataset_id=payload.get("dataset_id", "icici_fy2024"),
                clear_existing=bool(payload.get("clear_existing", False)),
            )
        )
        return {
            "success": result["success"],
            "message": f"processed {result['chunks_processed']} chunks",
            "chunks_processed": result["chunks_processed"],
            "entities_created": result["total_entities_created"],
            "dataset_id": result["dataset_id"],
            "failed_chunk_ids": result["failed_chunk_ids"],
        }

    @app.post("/api/v1/query")
    def query(request: Request):
        try:
            req = GraphQueryRequest.model_validate(_body(request))
        except Exception as e:
            raise HTTPError(422, str(e))
        t0 = time.perf_counter()
        out = run_tool_coroutine(engine.graph_builder.query_engine.query(req.question, req.limit))
        return {
            "success": True,
            "question": req.question,
            "results": out["results"],
            "result_count": len(out["results"]),
            "execution_time_ms": (time.perf_counter() - t0) * 1e3,
        }

    @app.get("/api/v1/stats")
    def stats(request: Request):
        return {"success": True, **engine.graph.stats()}

    @app.delete("/api/v1/clear/{dataset_id}")
    def clear(request: Request):
        engine.graph.clear_data(request.params["dataset_id"])
        return {"success": True, "cleared": request.params["dataset_id"]}

    @app.get("/quick-stats")
    def quick_stats(request: Request):
        s = engine.graph.stats()
        return {
            "quarters": s.get("quarters_available", []),
            "total_facts": s.get("total_facts", 0),
            "by_type": {k: v for k, v in s.items() if k.endswith("_count")},
        }

    @app.get("/health")
    def health(request: Request):
        h = engine.health()
        return {
            "status": h["status"],
            "neo4j_connected": True,  # payload parity: maps to device graph store
            "entity_service_available": True,
            "version": "1.0.0",
        }

    return app


# ---------------------------------------------------------------------------
# Adapters (:9001 vector, :9002 graph) — REST bridges over the MCP client
# ---------------------------------------------------------------------------


def build_vector_adapter(mcp_url: str) -> JsonApp:
    app = JsonApp("vectorrag-adapter")
    client = MCPClient(mcp_url)

    @app.post("/search")
    def search(request: Request):
        payload = _body(request)
        return client.call_tool(
            "search_vectors",
            {"query": payload.get("query", ""), "top_k": int(payload.get("top_k", 3))},
        )

    @app.post("/answer")
    def answer(request: Request):
        payload = _body(request)
        return client.call_tool(
            "answer_question",
            {"question": payload.get("question", ""), "top_k": int(payload.get("top_k", 3))},
        )

    @app.get("/stats")
    def stats(request: Request):
        return client.call_tool("get_collection_stats")

    @app.get("/health")
    def health(request: Request):
        return client.call_tool("health_check")

    return app


def build_graph_adapter(mcp_url: str) -> JsonApp:
    app = JsonApp("graphrag-adapter")
    client = MCPClient(mcp_url)

    @app.post("/extract")
    def extract(request: Request):
        payload = _body(request)
        return client.call_tool(
            "extract_financial_entities",
            {
                "chunk_text": payload.get("chunk_text", payload.get("text", "")),
                "chunk_id": payload.get("chunk_id", "adhoc"),
                "period": payload.get("period", "Q1_FY2024"),
            },
        )

    @app.post("/build")
    def build(request: Request):
        payload = _body(request)
        return client.call_tool(
            "build_financial_graph",
            {
                "chunks": payload.get("chunks", []),
                "dataset_id": payload.get("dataset_id", "icici_fy2024"),
                "clear_existing": bool(payload.get("clear_existing", False)),
            },
        )

    @app.post("/query")
    def query(request: Request):
        payload = _body(request)
        return client.call_tool(
            "query_financial_graph",
            {"question": payload.get("question", ""), "limit": int(payload.get("limit", 10))},
        )

    @app.get("/stats")
    def stats(request: Request):
        return client.call_tool("get_graph_stats")

    @app.post("/clear")
    def clear(request: Request):
        payload = _body(request)
        return client.call_tool("clear_graph_data", {"dataset_id": payload.get("dataset_id", "")})

    @app.get("/health")
    def health(request: Request):
        return client.call_tool("health_check")

    return app
