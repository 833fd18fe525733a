"""Names and small variants of the benchmark's cells, for the CPU tests."""

SCOPED = "trained-f32-10M.scoped-b64x1"
RAW = "minilm-l6-int8-10M.raw-b64x1"


def small_cell(name: str, per_caller: int = 1):
    """The cell as BENCHMARK.json defines it, with the checked calls drawn
    among each caller's first calls (a short CPU window sends few)."""
    from benchmark.lib import spec

    cell = spec.cell(name)
    cell["mix"]["checked_calls"] = {"per_caller": per_caller, "among_first": per_caller}
    return cell
