"""peak_gib.train: the allocator's peak over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), GiB."""


def read(run):
    b = run.counters.get("peak_bytes", 0)
    return b / 2 ** 30 if b else None
