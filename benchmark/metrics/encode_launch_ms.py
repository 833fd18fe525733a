"""Host time launching the encoder's forward per call: the program's
`encode.forward` spans (the upload of the token ids and mask and the eager
forward's launches), in ms."""

from benchmark.lib import spans


def read(run):
    return spans.ms(run, "encode.forward")
