"""step_ms: the window's length over its engine steps, in ms."""


def read(run):
    steps = run.window_steps()
    return 1e3 * run.window_s / len(steps) if steps else None
