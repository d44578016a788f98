"""The device's idle share while the program's own host code runs: the
idle seconds of the traced window (the window and kernels of `idle_share`)
whose innermost program span is one that does work (`prefill`, `block`,
`host_read`, `chunk_out`, `admit.plan`, `harvest`; not the spans that hold
them, `_spans.UMBRELLA`), outside every `cudaGraphLaunch`, over the window.
The split it sums: `_spans.idle_split` (`perfbench/idle_split.py` prints
it). In a traced run the profiler's cost is inside: its eager launches in
`prefill`, its slower reads in `host_read`."""

from perfbench.metrics import _spans


def read(run):
    split = _spans.idle_split(run)
    if split is None:
        return None
    skip = _spans.UMBRELLA + ("launch", "none")
    return 100.0 * sum(v for k, v in split.items() if k not in skip) / run.trace_s
