"""Milliseconds of one collect chunk less the updates it runs
(``BatchedSAC._collect_chunk``: the observation gather, the policy sweep,
K2 and the replay writes), per chunk of the window."""


def read(run):
    chunks, updates = run.spans.get("collect_chunk"), run.spans.get("sac_update", [])
    return 1e3 * (sum(chunks) - sum(updates)) / len(chunks) if chunks else None
