"""Host ms inside ``Renderer.step`` a pass, the mean over the window's
frames, from the benchmark's span.  The call enqueues the pass; it also
waits wherever the program synchronises or the launch queue is full."""


def read(run):
    if not run.dispatch_s:
        return None
    return sum(run.dispatch_s) / len(run.dispatch_s) * 1e3
