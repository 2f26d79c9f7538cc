"""Milliseconds of one env step's district step (``step_packed``: the
stepped ``district_step`` at D=1 and the history row it packs), to
completion on the card, over the window's steps."""


def read(run):
    times = run.spans.get("step_packed")
    return 1e3 * sum(times) / len(times) if times else None
