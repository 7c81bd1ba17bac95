"""chunk_step_share: the share of the window's engine steps that ran a
chunk program (some slot ingesting its prompt), in %."""


def read(run):
    steps = run.window_steps()
    if not steps:
        return None
    return 100.0 * sum(s.width > 0 for s in steps) / len(steps)
