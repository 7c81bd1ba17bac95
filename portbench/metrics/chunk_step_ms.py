"""chunk_step_ms: the mean host wall of a window step that ran a chunk
program, from the call into ``step`` to its return (the tokens on the
host), in ms."""


def read(run):
    walls = [s.t1 - s.t0 for s in run.window_steps() if s.width > 0]
    return 1e3 * sum(walls) / len(walls) if walls else None
