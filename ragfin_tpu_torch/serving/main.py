"""Service launcher CLI.

``python -m ragfin_tpu_torch.serving.main [--model MODEL] [--services a,b,c]``
starts the full service registry on the reference's ports (SURVEY.md §5):
entity :8001, graph :8002, vector adapter :9001, graph adapter :9002,
vector MCP :9006, graph MCP :9007, monolith MCP :9008. ``--model`` mirrors
the reference's CLI model switch (``main_graph.py:21-26,181-189``). The
services run on the CUDA card; ``RAGFIN_DEVICE=cpu`` runs them on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import time

from ..config.settings import get_config, switch_default_model
from .engine import get_engine
from .httpd import AppServer
from .mcp import build_graph_mcp, build_vector_mcp
from .rest import build_entity_app, build_graph_adapter, build_graph_app, build_vector_adapter

ALL_SERVICES = (
    "entity_service",
    "graph_service",
    "vector_mcp",
    "graph_mcp",
    "graph_mcp_monolith",
    "vector_adapter",
    "graph_adapter",
)


def launch(services=ALL_SERVICES, host: str = "127.0.0.1", ports=None, engine=None):
    """Start the requested services in background threads; returns
    {name: AppServer} (ports chosen from the registry unless overridden)."""
    settings = get_config()
    ports = {**settings.ports, **(ports or {})}
    engine = engine or get_engine()
    engine.warmup()
    servers: dict[str, AppServer] = {}

    def start(name, app):
        servers[name] = AppServer(app, host, ports.get(name, 0)).start_background()

    if "entity_service" in services:
        start("entity_service", build_entity_app(engine))
    if "graph_service" in services:
        start("graph_service", build_graph_app(engine))
    if "vector_mcp" in services:
        start("vector_mcp", build_vector_mcp(engine).app)
    if "graph_mcp" in services:
        start("graph_mcp", build_graph_mcp(engine).app)
    if "graph_mcp_monolith" in services:
        start("graph_mcp_monolith", build_graph_mcp(engine, monolith=True).app)
    if "vector_adapter" in services:
        url = f"http://{host}:{servers['vector_mcp'].port}" if "vector_mcp" in servers else f"http://{host}:{ports['vector_mcp']}"
        start("vector_adapter", build_vector_adapter(url))
    if "graph_adapter" in services:
        url = f"http://{host}:{servers['graph_mcp'].port}" if "graph_mcp" in servers else f"http://{host}:{ports['graph_mcp']}"
        start("graph_adapter", build_graph_adapter(url))
    return servers


def configure_logging(level: int = logging.INFO) -> None:
    """stdout INFO logging (parity with the reference services' basicConfig)."""
    logging.basicConfig(
        level=level,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
    )


def main(argv=None) -> None:
    configure_logging()
    parser = argparse.ArgumentParser(description="ragfin_tpu_torch service launcher")
    parser.add_argument("--model", default=None, help="default LLM (e.g. gemini-2.0-flash, fake)")
    parser.add_argument("--services", default=",".join(ALL_SERVICES))
    parser.add_argument("--host", default="127.0.0.1")
    args = parser.parse_args(argv)

    if args.model:
        switch_default_model(args.model)
    services = tuple(s.strip() for s in args.services.split(",") if s.strip())
    servers = launch(services, host=args.host)
    for name, server in servers.items():
        print(f"{name}: http://{args.host}:{server.port}")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        for server in servers.values():
            server.stop()


if __name__ == "__main__":
    main()
