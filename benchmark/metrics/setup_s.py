"""setup_s: seconds from the start of the process to the start of the
measured window (imports, the CUDA context, building the program, seeded
weights and traffic, kernel builds, warm-up and the checked steps)."""


def read(run):
    return run.setup_s
