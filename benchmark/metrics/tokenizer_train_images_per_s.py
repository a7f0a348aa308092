"""tokenizer_train_images_per_s: the window's training images (steps x
batch) over the window's host seconds."""


def read(run):
    return run.counters["images"] / run.window_s if "steps" in run.counters else None
