"""Device ms a pass of the per-bounce shade kernel
(csrc/bounce_kernel.cu)."""


def read(run):
    return run.device_ms(lambda op: op.family == "shade")
