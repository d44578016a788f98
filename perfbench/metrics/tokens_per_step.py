"""Tokens committed per target step of the sampled requests: the engine's
counters `num_decoding_steps / num_large_model_steps`, summed over the
window."""


def read(run):
    w = run.window
    return w.sampled_tokens / w.sampled_steps if w.sampled_steps else None
