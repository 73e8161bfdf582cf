"""Device ms a pass of the BVH launches' kernels: the visiting order,
the ray compaction and the warp walk (csrc/bvh_kernel.cu)."""


def read(run):
    return run.device_ms(lambda op: op.family == "bvh")
