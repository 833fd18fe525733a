"""Run one benchmark cell of ragfin_tpu_torch on the card and print its result.

    python3 benchmark/run.py --workload <config>.<traffic> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix, limits and metric readers are found
by name (``benchmark/lib/spec.py``). Set-up makes the corpus and any seeded
weights on the card from the seed, builds the deployment, and warms every
shape the mix uses; then the mix's closed-loop callers run for ``--seconds``.
After the window the program's state is freed and the checked calls are
judged against the plain reference (``benchmark/lib/judge.py``). The last
lines of standard error are the numbers compared beside their limits; the
last line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end metrics, or with ``--trace 1`` the
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last. Without a CUDA card, or with fewer cards than the cell
asks for, it exits 3 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != _ROOT:
    sys.path.insert(0, _ROOT)
# Build caches live at fixed paths inside the checkout, so only a cell's
# first run there compiles.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(_ROOT, "build", "bench_cache", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_ROOT, "build", "bench_cache", "triton"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ragfin_tpu")


class RunData:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    @property
    def completed(self):
        return [c for c in self.calls if c.end <= self.window_end and c.error is None]


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def checked_keys(mix: dict, seed: int) -> set:
    rule = mix["checked_calls"]
    rng = np.random.default_rng([int(seed) % (1 << 64), 7])
    out = set()
    for c in range(mix["callers"]):
        for i in rng.choice(rule["among_first"], size=rule["per_caller"], replace=False):
            out.add((c, int(i)))
    return out


def _warm_calls(pools, tokens, count: int) -> list:
    """``count`` calls from the pools, plus one for every longest-question
    length in sixteens that the pools hold, so that every padded shape the
    window can meet has run once."""
    picked, lengths = [], set()
    for pool in pools:
        for call in pool:
            key = -(-max(tokens(t) for t in call) // 16)
            if key not in lengths:
                lengths.add(key)
                picked.append(call)
    return picked + [pools[i % len(pools)][i // len(pools)] for i in range(count)]


def host_peak_gib() -> float:
    """Peak resident memory of this process so far, in GiB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, rows: int | None = None,
             records: list | None = None, numbers: dict | None = None, log=print) -> dict:
    """One run of a cell. ``records`` may hand in the corpus's records,
    which do not depend on the seed, to runs of several seeds in one process;
    ``numbers``, if given, receives every number the judge read."""
    from benchmark.lib import corpus, driver, judge, questions, spec, weights
    from benchmark.lib import trace as trace_lib
    from benchmark.lib.system import System

    config, mix = cell["config"], cell["mix"]
    seed = int(seed) % (1 << 64)
    on_card = torch.device(device).type == "cuda"
    layout = corpus.Layout.from_config(config["corpus"], rows)
    tok = judge.tokenizer_for(config, _ROOT)
    token_counts: dict = {}

    def tokens(text: str) -> int:
        n = token_counts.get(text)
        if n is None:
            n = token_counts[text] = len(tok.encode(text))
        return n

    # The collector stays off through set-up, whose tens of millions of
    # objects live as long as the run; they are then frozen, so that
    # collections in the window do not walk them.
    gc.disable()
    if records is None:
        t = time.perf_counter()
        records = corpus.make_records(layout, System.record_class())
        log(f"setup: {layout.rows} records {time.perf_counter() - t:.2f} s", file=sys.stderr)
    t = time.perf_counter()
    vectors = corpus.make_vectors(layout, seed, device)
    seeded = None if config["deployment"].get("checkpoint") else weights.seeded(config, seed, device)
    system = System(config, _ROOT, records, vectors, seeded, mix["entry"], device)
    del vectors, seeded
    log(f"setup: system {time.perf_counter() - t:.2f} s", file=sys.stderr)
    pools = [questions.caller_calls(mix, seed, c, mix["pooled_calls"]) for c in range(mix["callers"])]
    checked = checked_keys(mix, seed)
    t = time.perf_counter()
    for call in _warm_calls(pools, tokens, mix["warm_calls"]):
        system.entry(call, top_k=mix["top_k"])
    if on_card:
        torch.cuda.synchronize()
    log(f"setup: warm-up {time.perf_counter() - t:.2f} s; host peak {host_peak_gib():.2f} GiB",
        file=sys.stderr)
    gc.freeze()
    gc.enable()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    launches0 = system.kernel_launches()
    masks0 = system.mask_cache_sizes()
    setup_s = time.perf_counter() - T_START

    system.probes.tracing = trace
    with trace_lib.Capture() if trace else contextlib.nullcontext() as capture:
        calls, w_start, w_end, hung = driver.run_window(system, pools, seconds, mix["top_k"], checked,
                                                        tracing=trace)
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    launches = {k: v - launches0[k] for k, v in system.kernel_launches().items()}
    masks = system.mask_cache_sizes()
    reduced = None
    if capture is not None:
        t = time.perf_counter()
        reduced = trace_lib.reduce(capture)
        log(f"trace: profiler stopped in {capture.stop_s:.1f} s, read in {time.perf_counter() - t:.1f} s",
            file=sys.stderr)
    del capture

    checked_calls = judge.checked_calls(calls, pools, checked)
    system.close()
    del system, records
    if on_card:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = judge.Reference(config, mix, layout, seed, _ROOT, device)
    judged = judge.judge(ref, mix["entry"], checked_calls)
    if numbers is not None:
        numbers.update(judged)
    numbers = judged
    del ref
    log(f"check: {numbers['questions']} questions of {len(checked_calls)} calls "
        f"judged in {time.perf_counter() - t:.2f} s; host peak {host_peak_gib():.2f} GiB", file=sys.stderr)
    if on_card:
        torch.cuda.empty_cache()

    run = RunData(calls=calls, window_start=w_start, window_end=w_end, seconds=seconds,
                  setup_s=setup_s, peak_bytes=peak, trace=reduced, layout=layout, config=config,
                  top_k=mix["top_k"], dtype=config["deployment"]["settings"]["index_dtype"],
                  tokens=tokens)
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = cell["limits"]
    checks = {name: {"value": numbers[name], "limit": limits[name]} for name in limits}
    correct = (hung == 0 and numbers["questions"] > 0
               and all(v["value"] <= v["limit"] for v in checks.values()))
    attempted = sum(c.questions for c in calls)
    failed = sum(c.questions for c in calls if c.error is not None)
    for c in calls:
        if c.error is not None:
            log(f"failed call {c.caller}/{c.index}: {c.error}", file=sys.stderr)
    completed = run.completed
    if completed:
        log(f"window: per call median {np.median([c.end - c.start for c in completed]) * 1e3:.3f} ms, "
            f"encoder {np.median([c.stats.encode_s for c in completed]) * 1e3:.3f} ms, "
            f"index outside it {np.median([c.stats.index_s for c in completed]) * 1e3:.3f} ms",
            file=sys.stderr)
    log(f"window: {len(completed)} calls completed of {len(calls)} sent, {hung} callers hung; "
        f"kernel launches {launches}; mask cache entries (host, device) {masks0} before, "
        f"{masks} after", file=sys.stderr)
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed, "metrics": metrics}
    out["device"] = device_info(peak, reduced, on_card)
    if reduced is not None:
        out["breakdown"] = {"device_ops": reduced["device_ops"], "idle_gaps": reduced["idle_gaps"]}
        log(f"trace: {reduced['device_events']} device events, {reduced['index_events']} inside index "
            f"calls; kernels {reduced['kernel_counts']}", file=sys.stderr)
    out["checks"] = checks
    return out


def device_info(peak: int, reduced: dict | None, on_card: bool) -> dict:
    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(peak)}
    if reduced is not None:
        info["busy_s"] = reduced["busy_s"]
        info["window_s"] = reduced["window_s"]
    return info


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark.lib import spec

    cell = spec.cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, check in out["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
