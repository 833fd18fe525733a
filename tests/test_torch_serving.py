"""Both packages' service registries, side by side, over one generated corpus.

``launch()`` of ``ragfin_tpu.serving.main`` and of
``ragfin_tpu_torch.serving.main`` start all seven services on ephemeral
ports, each over its own engine built from the same generated
``extract_data`` tree (``default_model="fake"``, trained encoder; the port on
``device="cpu"``). Every REST endpoint and every MCP tool is called on both
and the JSON bodies are compared:

- equal, after dropping timings (``extraction_time``, ``execution_time_ms``),
  the batcher's counters and the port's extra ``dtype``/``device`` entries;
- a ``score`` may differ by 2e-3: each package encodes with its own bf16
  MiniLM forward, and the two round activations in different places
  (``tests/test_torch_engine.py``); ids and answers must be equal;
- a 422's detail text is pydantic's on one side and the port's dataclass
  validation on the other, so for validation errors only the status code is
  compared.

The whole: the corpus answered through HTTP by the port gives the JAX
engine's hits and extractive answers.
"""

import threading

import httpx
import pytest

from ragfin_tpu.config.settings import Settings as JSettings
from ragfin_tpu.serving import main as j_main
from ragfin_tpu.serving.engine import RagFinEngine as JEngine
from ragfin_tpu.serving.mcp_client import MCPClient as JClient
from ragfin_tpu_torch.config.settings import Settings as TSettings
from ragfin_tpu_torch.eval.statements import write_extract_data
from ragfin_tpu_torch.serving import engine as t_engine_mod
from ragfin_tpu_torch.serving import main as t_main
from ragfin_tpu_torch.serving.mcp_client import MCPClient as TClient
from ragfin_tpu_torch.utils.profiling import METRICS as T_METRICS

SCORE_TOL = 2e-3
DROPPED = {"extraction_time", "execution_time_ms", "batcher", "dtype", "device"}
QUESTIONS = [
    "What was ICICI Bank's net profit in Q1 FY2024?",
    "What was the total income in Q2 FY2024?",
    "How did net profit trend across all quarters of FY2024?",
    "What was the retail banking segment revenue in Q4 FY2024?",
    "What were total customer deposits in Q3 FY2024?",
]


def same(a, b, path="$"):
    """Recursive JSON comparison under the module docstring's rules."""
    if isinstance(a, dict) and isinstance(b, dict):
        ka, kb = set(a) - DROPPED, set(b) - DROPPED
        assert ka == kb, f"{path}: keys {sorted(ka ^ kb)} differ"
        for k in ka:
            same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), f"{path}: lengths {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif path.endswith(".score") and isinstance(a, float) and isinstance(b, float):
        assert abs(a - b) <= SCORE_TOL, f"{path}: {a} != {b}"
    elif isinstance(a, str) and a.startswith("invalid chunk:"):
        assert isinstance(b, str) and b.startswith("invalid chunk:"), f"{path}: {b!r}"
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    tree = write_extract_data(str(tmp_path_factory.mktemp("serving") / "extract_data"), seed=21)
    jeng = JEngine(JSettings(default_model="fake", data_dir=tree, index_dir=""))
    teng = t_engine_mod.get_engine(
        settings=TSettings(default_model="fake", data_dir=tree, index_dir="", device="cpu")
    )
    assert len(jeng.chunks) == len(teng.chunks) == 16
    for eng in (jeng, teng):
        eng.graph_builder.build_from_vector_index(eng.vector_index)
    ports = {name: 0 for name in j_main.ALL_SERVICES}
    jservers = j_main.launch(ports=ports, engine=jeng)
    tservers = t_main.launch(ports=ports, engine=teng)
    assert set(jservers) == set(tservers) == set(t_main.ALL_SERVICES) == set(j_main.ALL_SERVICES)
    yield {
        "j": {k: f"http://127.0.0.1:{v.port}" for k, v in jservers.items()},
        "t": {k: f"http://127.0.0.1:{v.port}" for k, v in tservers.items()},
        "jeng": jeng, "teng": teng,
    }
    for server in list(jservers.values()) + list(tservers.values()):
        server.stop()
    jeng.close()
    t_engine_mod.reset_engine()
    assert t_engine_mod._engine is None and teng.batcher is None


def both(stacks, method, service, path, **kwargs):
    """The same HTTP request to both packages' service: (jax, port) responses."""
    out = []
    for side in ("j", "t"):
        out.append(httpx.request(method, stacks[side][service] + path, timeout=120, **kwargs))
    return out


def both_tools(stacks, service, name, arguments=None):
    j = JClient(stacks["j"][service]).call_tool(name, arguments)
    t = TClient(stacks["t"][service]).call_tool(name, arguments)
    return j, t


def _chunk(stacks, i=0):
    return stacks["teng"].chunks[i].to_financial_chunk().model_dump()


REST_CALLS = [
    ("entity_service", "POST", "/api/v1/extract", lambda s: {"text": s["teng"].chunks[0].text, "period": "Q1_FY2024"}),
    ("entity_service", "POST", "/api/v1/extract", lambda s: {"chunk": _chunk(s, 5)}),
    ("entity_service", "POST", "/api/v1/extract/batch", lambda s: {"chunks": [_chunk(s, 1), {"id": "broken"}, _chunk(s, 2)]}),
    ("entity_service", "POST", "/api/v1/model/switch", lambda s: {"model": "rule-based"}),
    ("entity_service", "GET", "/api/v1/models", None),
    ("entity_service", "GET", "/health", None),
    ("graph_service", "POST", "/api/v1/query", lambda s: {"question": QUESTIONS[0], "limit": 5}),
    ("graph_service", "POST", "/api/v1/query", lambda s: {"question": QUESTIONS[2]}),
    ("graph_service", "GET", "/api/v1/stats", None),
    ("graph_service", "GET", "/quick-stats", None),
    ("graph_service", "GET", "/health", None),
    ("graph_service", "POST", "/api/v1/build", lambda s: {"chunks": [_chunk(s, 3), _chunk(s, 7)], "dataset_id": "extra"}),
    ("graph_service", "DELETE", "/api/v1/clear/extra", None),
    ("vector_adapter", "POST", "/search", lambda s: {"query": QUESTIONS[0], "top_k": 3}),
    ("vector_adapter", "POST", "/search", lambda s: {"query": QUESTIONS[4], "top_k": 5}),
    ("vector_adapter", "POST", "/answer", lambda s: {"question": QUESTIONS[1], "top_k": 3}),
    ("vector_adapter", "GET", "/stats", None),
    ("vector_adapter", "GET", "/health", None),
    ("graph_adapter", "POST", "/extract", lambda s: {"chunk_text": s["teng"].chunks[4].text, "period": "Q2_FY2024"}),
    ("graph_adapter", "POST", "/query", lambda s: {"question": QUESTIONS[3], "limit": 4}),
    ("graph_adapter", "GET", "/stats", None),
    ("graph_adapter", "POST", "/build", lambda s: {"chunks": [_chunk(s, 8)], "dataset_id": "extra2"}),
    ("graph_adapter", "POST", "/clear", lambda s: {"dataset_id": "extra2"}),
    ("graph_adapter", "GET", "/health", None),
]


@pytest.mark.parametrize("service,method,path,body", REST_CALLS,
                         ids=[f"{c[0]}:{c[1]}:{c[2]}:{i}" for i, c in enumerate(REST_CALLS)])
def test_rest_endpoint_equal(stacks, service, method, path, body):
    kwargs = {"json": body(stacks)} if body else {}
    rj, rt = both(stacks, method, service, path, **kwargs)
    assert rj.status_code == rt.status_code == 200, (rj.text[:300], rt.text[:300])
    same(rj.json(), rt.json())


ERROR_CALLS = [
    ("entity_service", "POST", "/api/v1/extract", {"id": "x"}, 422),
    ("entity_service", "POST", "/api/v1/extract", [1, 2], 422),
    ("entity_service", "POST", "/api/v1/extract/batch", {"chunks": "nope"}, 422),
    ("entity_service", "POST", "/api/v1/model/switch", {"model": "gpt-17"}, 400),
    ("graph_service", "POST", "/api/v1/query", {"question": "hm"}, 422),
    ("graph_service", "POST", "/api/v1/query", {"question": QUESTIONS[0], "limit": 1000}, 422),
    ("graph_service", "POST", "/api/v1/query", {}, 422),
    ("graph_service", "GET", "/api/v1/nothing", None, 404),
    ("vector_adapter", "POST", "/search", ["not", "an", "object"], 422),
    ("vector_mcp", "GET", "/mcp", None, 405),
]


@pytest.mark.parametrize("service,method,path,body,status", ERROR_CALLS,
                         ids=[f"{c[0]}:{c[2]}:{c[4]}:{i}" for i, c in enumerate(ERROR_CALLS)])
def test_error_status_equal(stacks, service, method, path, body, status):
    kwargs = {} if body is None else {"json": body}
    rj, rt = both(stacks, method, service, path, **kwargs)
    assert rj.status_code == rt.status_code, (rj.status_code, rt.status_code, rt.text[:200])
    if status not in (405,):
        assert rt.status_code == status
    if status in (400, 404):
        same(rj.json(), rt.json())


TOOL_CALLS = [
    ("vector_mcp", "health_check", None),
    ("vector_mcp", "search_vectors", {"query": QUESTIONS[0], "top_k": 3}),
    ("vector_mcp", "answer_question", {"question": QUESTIONS[3], "top_k": 3}),
    ("vector_mcp", "get_collection_stats", None),
    ("graph_mcp", "health_check", None),
    ("graph_mcp", "get_server_info", None),
    ("graph_mcp", "extract_financial_entities", lambda s: {"chunk_text": s["teng"].chunks[6].text}),
    ("graph_mcp", "extract_and_save_to_graph",
     lambda s: {"chunk_text": s["teng"].chunks[9].text, "chunk_id": "saved", "period": "Q3_FY2024",
                "dataset_id": "tool_ds"}),
    ("graph_mcp", "get_graph_stats", None),
    ("graph_mcp", "clear_graph_data", {"dataset_id": "tool_ds"}),
    ("graph_mcp", "build_financial_graph", lambda s: {"chunks": [_chunk(s, 10)], "dataset_id": "tool_ds2"}),
    ("graph_mcp", "clear_graph_data", {"dataset_id": "tool_ds2"}),
    ("graph_mcp", "query_financial_graph", {"question": QUESTIONS[0], "limit": 5}),
    ("graph_mcp", "query_financial_graph", {"question": QUESTIONS[2], "limit": 10}),
    ("graph_mcp", "execute_fallback_query", {"limit": 5}),
    ("graph_mcp", "generate_cypher_query", {"question": QUESTIONS[3]}),
    ("graph_mcp_monolith", "hybrid_query", {"question": QUESTIONS[2], "vector_k": 5, "k_out": 10}),
    ("graph_mcp_monolith", "hybrid_query", {"question": QUESTIONS[0]}),
    ("graph_mcp_monolith", "execute_raw_plan", {"plan": {"limit": 3}}),
    ("graph_mcp_monolith", "traverse_entity_relationships", {"entity_name": "NET PROFIT", "limit": 20}),
    ("graph_mcp_monolith", "compare_quarters", {"quarter1": "Q1_FY2024", "quarter2": "Q2_FY2024"}),
    ("graph_mcp_monolith", "test_llm_providers", None),
    ("graph_mcp_monolith", "test_llm_generation", None),
]


@pytest.mark.parametrize("service,name,arguments", TOOL_CALLS,
                         ids=[f"{c[0]}:{c[1]}:{i}" for i, c in enumerate(TOOL_CALLS)])
def test_mcp_tool_equal(stacks, service, name, arguments):
    if callable(arguments):
        arguments = arguments(stacks)
    j, t = both_tools(stacks, service, name, arguments)
    same(j, t)
    if name == "health_check":
        # The port's only extra entries (dropped above) sit under vector_index.
        assert set(t) == set(j) and "integrity_active" in t
        assert set(t["vector_index"]) - set(j["vector_index"]) == {"dtype", "device"}


@pytest.mark.parametrize("service", ["vector_mcp", "graph_mcp", "graph_mcp_monolith"])
def test_tool_lists_and_protocol_equal(stacks, service):
    jc, tc = JClient(stacks["j"][service]), TClient(stacks["t"][service])
    same(jc.initialize(), tc.initialize())
    assert jc.session_id and tc.session_id
    same(jc.list_tools(), tc.list_tools())
    from ragfin_tpu.serving.mcp_client import MCPClientError as JErr
    from ragfin_tpu_torch.serving.mcp_client import MCPClientError as TErr

    with pytest.raises(JErr) as je:
        jc.call_tool("no_such_tool")
    with pytest.raises(TErr) as te:
        tc.call_tool("no_such_tool")
    assert str(je.value) == str(te.value) and "unknown tool" in str(te.value)
    # A failing tool body comes back as isError on both.
    with pytest.raises(JErr):
        jc.call_tool("health_check", {"unexpected": 1})
    with pytest.raises(TErr):
        tc.call_tool("health_check", {"unexpected": 1})
    for side in ("j", "t"):
        r = httpx.post(stacks[side][service] + "/mcp", json={"jsonrpc": "2.0", "id": 9, "method": "nope"})
        assert '"code": -32601' in r.text
        r = httpx.post(stacks[side][service] + "/mcp", json=[1])
        assert r.status_code == 400


@pytest.mark.parametrize("question", QUESTIONS)
def test_port_over_http_gives_the_jax_engines_hits_and_answers(stacks, question):
    """The slice as a whole: HTTP -> adapter -> MCP client -> MCP server ->
    batcher -> port engine against the JAX engine object."""
    want = stacks["jeng"].vector_rag.search(question, top_k=3)
    got = httpx.post(stacks["t"]["vector_adapter"] + "/search",
                     json={"query": question, "top_k": 3}, timeout=120).json()
    assert got["success"] and [h["id"] for h in got["results"]] == [h["id"] for h in want]
    for a, b in zip(got["results"], want):
        assert abs(a["score"] - b["score"]) <= 1e-3
    import asyncio

    answered = asyncio.run(stacks["jeng"].vector_rag.search_and_answer(question, 3))
    over = httpx.post(stacks["t"]["vector_adapter"] + "/answer",
                      json={"question": question, "top_k": 3}, timeout=120).json()
    assert over["answer"] == answered["answer"] and over["answer_mode"] == answered["answer_mode"]


def test_concurrent_mcp_clients_coalesce_in_the_batcher(stacks):
    engine = stacks["teng"]
    assert engine.batcher is not None
    before = T_METRICS.summary()["counters"]
    n_threads, per_thread = 8, 4
    errors, results, lock = [], [], threading.Lock()

    def worker(tid: int):
        try:
            client = TClient(stacks["t"]["vector_mcp"])
            for i in range(per_thread):
                out = client.call_tool(
                    "answer_question",
                    {"question": f"What was net profit in Q{1 + (tid + i) % 4} FY2024?", "top_k": 3},
                )
                with lock:
                    results.append(out)
        except Exception as e:  # noqa: BLE001 - reported below
            with lock:
                errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    assert len(results) == n_threads * per_thread and all(r.get("answer") for r in results)
    futures = [engine.batcher.submit(f"total income Q{1 + i % 4} FY2024", top_k=3) for i in range(32)]
    for f in futures:
        assert f.result(timeout=60) is not None
    after = T_METRICS.summary()["counters"]
    queries = after.get("batcher.queries", 0) - before.get("batcher.queries", 0)
    batches = after.get("batcher.batches", 0) - before.get("batcher.batches", 0)
    assert queries >= 64 and batches < queries  # coalescing happened
    stats = TClient(stacks["t"]["vector_mcp"]).call_tool("get_collection_stats")
    assert stats["batching_enabled"] and stats["batcher"].get("batcher.queries", 0) > 0


def test_get_engine_is_a_singleton_with_reset(stacks):
    assert t_engine_mod.get_engine() is stacks["teng"]
