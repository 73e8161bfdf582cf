"""Host seconds to build the scene onto the card: the ``Renderer``'s
construction with its scene (the port's flattening, the host library's
SAH BVH, clusters and tables, the upload), from the benchmark's span."""


def read(run):
    return run.scene_build_s
