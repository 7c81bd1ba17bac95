"""setup_s: seconds from the process's start to the window's opening
(interpreter and imports, kernels loaded, weights drawn, cache allocated,
the cell's programs warmed and captured)."""


def read(run):
    return run.setup_s
