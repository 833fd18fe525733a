"""Seconds from the harness's start to the window's: imports, the corpus and
weights, the index build, kernel builds on a first run, and the warm-up."""


def read(run):
    return run.setup_s
