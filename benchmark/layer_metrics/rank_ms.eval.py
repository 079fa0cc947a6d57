"""Ranking time of one evaluation: the harness's span around
``cosine_distance_matrix`` and ``evaluate_rank`` (ended by the host copy of
the CMC), in ms."""


def read(run):
    s = run.spans.get("rank")
    if s is None or not run.counts.get("evaluations"):
        return None
    return 1e3 * s / run.counts["evaluations"]
