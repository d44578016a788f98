"""Tokens committed per batched iteration of the sampling engine's
`serve_device` calls: its counters `num_decoding_steps /
num_large_model_steps`, summed over the window."""


def read(run):
    w = run.window
    return w.sampled_tokens / w.sampled_steps if w.sampled_steps else None
