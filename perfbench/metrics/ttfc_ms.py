"""Host ms from a sampled request's call to `stream_fast` to its first chunk
(the eager prefill and the first device loop), median over the window."""

from perfbench.drive import median_ms


def read(run):
    return median_ms(run.ttfc)
