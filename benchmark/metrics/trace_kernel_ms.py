"""Device ms a pass of the whole-trace kernel (csrc/trace_kernel.cu)."""


def read(run):
    return run.device_ms(lambda op: op.family == "trace")
