"""Host time in the encoder's tokenising and padding per call: the program's
`encode.tokenize` spans (WordPiece or the featurizer, and the row and sequence
padding), in ms."""

from benchmark.lib import spans


def read(run):
    return spans.ms(run, "encode.tokenize")
