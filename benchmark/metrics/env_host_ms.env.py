"""Milliseconds of one ``env.step`` outside ``step_packed``: parsing the
action lists, the copy to the card, the copy of the history row back, and
the host's observation and reward lists."""


def read(run):
    steps, packed = run.spans.get("env_step"), run.spans.get("step_packed")
    if not steps or not packed:
        return None
    return 1e3 * (sum(steps) / len(steps) - sum(packed) / len(packed))
