"""Process start to the window's start: imports, the kernels' build where
it is not yet there, the tables made and laid out, the warm-up queries."""


def read(run):
    return run.setup_s
