"""Host time blocked on the card per call: the program's `encode.readback`
spans (the embeddings' copy back) and `index.readback` spans (the first host
read of each top-k result), in ms."""

from benchmark.lib import spans


def read(run):
    return spans.ms(run, "encode.readback", "index.readback")
