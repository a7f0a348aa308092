"""train_tokens_per_s: the window's training tokens (steps x batch x
positions) over the window's host seconds."""


def read(run):
    return run.counters["tokens"] / run.window_s if "tokens" in run.counters else None
