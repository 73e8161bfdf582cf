"""Device ms a frame of the kernels and the device-to-host copy that
``Renderer.image()`` issues (the tonemap, the untile, the u8 image)."""


def read(run):
    return run.device_ms(lambda op: op.span == "image")
