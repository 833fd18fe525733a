"""Query uploads to the card per call: the program's `index.query_upload`
counter (each `_queries_tensor`: vectors the encoder just sent to the host,
sent back)."""

from benchmark.lib import spans


def read(run):
    return spans.count(run, "index.query_upload")
