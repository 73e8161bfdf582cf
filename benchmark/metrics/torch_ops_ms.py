"""Device ms a pass of every operation ``Renderer.step`` issues that is
not one of the program's own CUDA kernels: PyTorch's kernels, copies and
fills (the split path's bounce body, ray generation, the canvas add)."""


def read(run):
    return run.device_ms(lambda op: op.span == "step" and op.family is None)
