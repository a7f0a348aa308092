"""export_images_per_s: images whose ten code grids reached the host, over
the window's host seconds."""


def read(run):
    return run.counters["images"] / run.window_s if "crops" in run.counters else None
