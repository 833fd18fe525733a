"""Calls into the index's ``search_texts`` / ``search_texts_tiers`` per timed
call (the outermost only), over the calls completed inside the window."""


def read(run):
    if not run.completed:
        return None
    return sum(c.stats.dispatches for c in run.completed) / len(run.completed)
