"""Concurrent-load serving benchmark of the PyTorch port, on the CUDA card.

Counterpart of scripts/serving_concurrent.py. Drives the full RPC stack,
REST adapter -> the port's MCP client -> vector MCP server -> VectorRAG ->
QueryBatcher -> one batched device dispatch, with C parallel HTTP clients
against the 16 real chunks + SERVE_N generated distractors, and reports:

- sustained QPS (completed requests / wall) and the clients' p50/p95;
- the batcher's batch-size distribution over the run (METRICS
  ``batcher.batch_size``: does dynamic micro-batching form Q > 1 device
  batches under load?);
- device dispatches against requests (the amortisation ratio).

Everything runs in this process (the services on background threads), so
the batcher's METRICS are readable; the clients still cross real HTTP and
MCP-SSE hops. Each client thread keeps one ``http.client.HTTPConnection``;
the port's server answers HTTP/1.0 and closes the connection after each
response, so every request opens a new connection, and each level's line
says so ("conn/request").

The 16 real chunks and the questions come from REFERENCE_ROOT when it is set
(``qa_subset.json`` and its paraphrases), else from a generated
``extract_data`` tree (seed 0) and the holdout phrasings shipped in the
package (scripts/trained_eval_torch.py:reference_inputs).

Usage: [SERVE_N=1000000] [CLIENTS=8,32] [DURATION=45] [SERVE_DTYPE=bfloat16]
       [SERVE_BACKEND=hashed|trained] python3 scripts/serving_concurrent_torch.py
Appends one line per client level to scripts/probe_results_h100.log (or
$EVAL_OUT/probe_results_h100.log when EVAL_OUT is set). SERVE_DTYPE accepts a
comma list ("float32,int8"): every index tier is built up front and each
client level alternates dtype within one process, so the host's drift cancels
out of the comparison. SERVE_BACKEND=trained reuses trained_eval_torch.py's
slab cache (the same corpus). The services run on the CUDA card;
RAGFIN_DEVICE=cpu runs them on the CPU.
"""

import http.client
import json
import os
import sys
import threading
import time
from urllib.parse import urlsplit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def _stage(msg: str) -> None:
    print(f"[conc {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def post(conn: http.client.HTTPConnection, path: str, query: str, top_k: int = 3) -> dict:
    """One ``POST /search`` on ``conn``; the parsed body of a 200 that holds
    results, else raises. ``http.client`` reopens a connection the server
    closed."""
    conn.request("POST", path, body=json.dumps({"query": query, "top_k": top_k}).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    if resp.status != 200:
        raise RuntimeError(f"HTTP {resp.status}: {data[:80]!r}")
    body = json.loads(data)
    if not body.get("success") or not body.get("results"):
        raise ValueError(f"bad body: {str(body)[:80]}")
    return body


def serve(engine) -> tuple[dict, str]:
    """The vector MCP server and the vector adapter over ``engine`` on
    ephemeral ports: (the servers by name, the adapter's /search URL)."""
    from ragfin_tpu_torch.serving.main import launch

    servers = launch(
        services=("vector_mcp", "vector_adapter"),
        ports={"vector_mcp": 0, "vector_adapter": 0},
        engine=engine,
    )
    return servers, f"http://127.0.0.1:{servers['vector_adapter'].port}/search"


def warm(url: str, questions) -> dict:
    """One pass of ``questions``, one at a time on one connection: each
    question's results."""
    parts = urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=600)
    try:
        return {q: post(conn, parts.path, q)["results"] for q in questions}
    finally:
        conn.close()


def level(url: str, questions, n_clients: int, duration: float, record=None) -> dict:
    """C client threads post ``/search`` round-robin over ``questions`` for
    ``duration`` seconds, each on its own HTTPConnection. METRICS is reset
    first, so call this only with nothing in flight. Returns the requests
    done, errors, wall seconds, QPS, client p50/p95 in ms, whether the
    server kept connections alive, and the batcher's dispatches, queries
    and batch-size mean/p50/p90 over the level. ``record``, a list where
    given, receives (question, results) of every answered request."""
    import numpy as np

    from ragfin_tpu_torch.utils.profiling import METRICS

    parts = urlsplit(url)
    METRICS.reset()
    stop_at = time.perf_counter() + duration
    lat: list[list[float]] = [[] for _ in range(n_clients)]
    errors = [0] * n_clients
    first_error: list = [None]
    keep_alive: list = [None]

    def client(i: int) -> None:
        conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=120)
        j = i  # staggered round-robin starting points
        try:
            while time.perf_counter() < stop_at:
                q = questions[j % len(questions)]
                j += n_clients
                t = time.perf_counter()
                try:
                    body = post(conn, parts.path, q)
                    lat[i].append(time.perf_counter() - t)
                    if record is not None:
                        record.append((q, body["results"]))
                    # http.client drops the socket after a response that
                    # closes the connection.
                    keep_alive[0] = conn.sock is not None
                except Exception as e:  # counted and reported per level
                    conn.close()
                    errors[i] += 1
                    if first_error[0] is None:
                        first_error[0] = repr(e)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    after = METRICS.summary()
    batches = after.get("counters", {}).get("batcher.batches", 0)
    served = after.get("counters", {}).get("batcher.queries", 0)
    bhist = after.get("values", {}).get("batcher.batch_size", {})
    done = int(sum(len(x) for x in lat))
    all_lat = np.sort(np.concatenate([np.array(x) for x in lat if x])) * 1e3 if done else np.zeros(1)
    return {
        "clients": n_clients, "done": done, "errors": int(sum(errors)),
        "first_error": first_error[0], "wall_s": wall, "qps": done / wall,
        "p50_ms": float(all_lat[len(all_lat) // 2]),
        "p95_ms": float(all_lat[int(len(all_lat) * 0.95)]),
        "keep_alive": keep_alive[0],
        "batches": int(batches), "queries": int(served),
        "batch_mean": served / batches if batches else 0.0,
        "batch_p50": float(bhist.get("p50", 0)), "batch_p90": float(bhist.get("p90", 0)),
    }


def line(n: int, r: dict, tag: str, card: str) -> str:
    """One level's result in the JAX script's format, with the card."""
    conn = "" if r["keep_alive"] else ", conn/request"
    return (
        f"serving_concurrent N={n} C={r['clients']}{tag}: {r['qps']:,.1f} QPS sustained "
        f"p50={r['p50_ms']:.0f} ms p95={r['p95_ms']:.0f} ms "
        f"({r['done']} reqs/{r['wall_s']:.0f}s, errors={r['errors']}{conn}; batcher: "
        f"{r['batches']} dispatches batch mean={r['batch_mean']:.1f} p50={r['batch_p50']:.0f} "
        f"p90={r['batch_p90']:.0f}) [{card}]"
    )


def main() -> None:
    from ragfin_tpu_torch.config.settings import get_config
    from ragfin_tpu_torch.eval.distractors import generate_distractors, paraphrased_questions
    from ragfin_tpu_torch.serving.engine import RagFinEngine
    from ragfin_tpu_torch.utils.device import resolve_device
    from trained_eval_torch import reference_inputs

    device = resolve_device(os.environ.get("RAGFIN_DEVICE") or None)
    n = int(os.environ.get("SERVE_N", 1_000_000))
    clients = [int(c) for c in os.environ.get("CLIENTS", "8,32").split(",")]
    duration = float(os.environ.get("DURATION", 45))
    dtypes = [d.strip() for d in os.environ.get("SERVE_DTYPE", "bfloat16").split(",") if d.strip()]
    backend = os.environ.get("SERVE_BACKEND", "hashed")
    out_dir = os.environ.get("EVAL_OUT")
    log = os.path.join(out_dir or os.path.join(ROOT, "scripts"), "probe_results_h100.log")
    if device.type == "cuda":
        from ragfin_tpu_torch.utils.profiling import card

        card_name = card()
    else:
        card_name = "cpu"

    _stage(f"device={device}; building {n}-distractor corpus")
    real, qa, _, hp = reference_inputs(os.environ.get("REFERENCE_ROOT") or None)
    chunks = list(real) + generate_distractors(n, seed=1)
    os.environ.setdefault("RAGFIN_BATCH_QUERIES", "1")
    # The benchmark serves the corpus it built, never an index saved in the
    # working directory.
    os.environ.setdefault("RAGFIN_INDEX_DIR", "")

    def build_stack(dtype: str):
        t0 = time.perf_counter()
        os.environ["RAGFIN_INDEX_DTYPE"] = dtype
        prebuilt = None
        if backend == "trained":
            # The production default backend: reuse trained_eval_torch.py's
            # slab cache (the same corpus, distractor seed and order).
            from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex
            from ragfin_tpu_torch.models.embedder import TrainedEmbedder
            from trained_eval_torch import emb_dir, encode_corpus

            embedder = TrainedEmbedder(batch_size=512, pad_multiple=192, device=device)
            matrix = encode_corpus(embedder, [c.text for c in chunks], time.perf_counter(), emb_dir(n))
            prebuilt = DeviceVectorIndex(matrix, chunks, dtype=dtype, device=device)
            prebuilt.embedder = TrainedEmbedder(device=device)  # query shapes: pad_multiple 16
        else:
            # The RPC and batcher stack with the weight-free lexical featurizer.
            os.environ.setdefault("RAGFIN_EMBED_BACKEND", "hashed")
        get_config.cache_clear()
        engine = RagFinEngine(chunks=chunks, vector_index=prebuilt, device=device)
        if engine.batcher is None:
            raise RuntimeError("the batcher must be on for this benchmark")
        _stage(f"[{dtype}] engine up in {time.perf_counter()-t0:.0f}s; launching servers")
        return (engine, *serve(engine))

    if qa:
        questions = [q.question for q in qa] + [q.question for q in paraphrased_questions(qa)]
    else:
        questions = [q.question for q in hp]

    stacks = {}
    try:
        for d in dtypes:
            stacks[d] = build_stack(d)
            _stage(f"[{d}] warming {len(questions)} question shapes through the adapter")
            t0 = time.perf_counter()
            warm(stacks[d][2], questions)
            _stage(f"[{d}] warm pass {time.perf_counter()-t0:.1f}s")

        for n_clients, dtype in [(c, d) for c in clients for d in dtypes]:
            r = level(stacks[dtype][2], questions, n_clients, duration)
            if not r["done"]:
                raise RuntimeError(f"C={n_clients}: every request failed ({r['errors']} errors; "
                                   f"first: {r['first_error']})")
            if r["first_error"]:
                _stage(f"C={n_clients}: {r['errors']} errors; first: {r['first_error']}")
            tag = "" if backend == "hashed" else f" backend={backend}"
            if dtype != "bfloat16" or len(dtypes) > 1:
                tag += f" dtype={dtype}"
            if len(dtypes) > 1:
                tag += " [back-to-back]"
            text = line(n, r, tag, card_name)
            with open(log, "a") as f:
                f.write(text + "\n")
            print(text, flush=True)
    finally:
        for engine, servers, _ in stacks.values():
            for s in servers.values():
                s.stop()
            engine.close()


if __name__ == "__main__":
    main()
