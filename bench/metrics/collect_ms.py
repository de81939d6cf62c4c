"""Federation: wall time of the window's collect calls per query collected."""
from fedbench.readers import span_ms_per_query


def read(run):
    return span_ms_per_query(run, "collect")
