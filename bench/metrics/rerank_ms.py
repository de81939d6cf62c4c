"""Aggregation: wall time of the window's rerank calls per query."""
from fedbench.readers import span_ms_per_query


def read(run):
    return span_ms_per_query(run, "rerank")
