"""Device ms of one replay of the sampling engine's `grow` graph, CUDA
events around each replay, averaged over the window."""


def read(run):
    return run.phase_ms.get("grow")
