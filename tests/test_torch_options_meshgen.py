"""The port's RenderOptions and models/meshgen against
simple_raytracer_tpu's.

``RenderOptions`` declares the JAX package's fields in the JAX order with
the same defaults, so one positional call configures both packages alike.
``models/meshgen.torus`` gives the JAX generator's positions and normals
bit for bit.
"""
import dataclasses

import numpy as np
import pytest

from simple_raytracer_tpu.engine import RenderOptions as JOptions
from simple_raytracer_tpu.models import meshgen as jmeshgen
from simple_raytracer_tpu_torch.engine import RenderOptions
from simple_raytracer_tpu_torch.models import meshgen


def test_render_options_fields_in_the_jax_order():
    """The fields' names, order and defaults are the JAX package's."""
    want = [(f.name, f.default) for f in dataclasses.fields(JOptions)]
    got = [(f.name, f.default) for f in dataclasses.fields(RenderOptions)]
    assert got == want


def test_one_positional_call_configures_both_alike():
    """Every field given positionally, in declaration order: each package
    reads the same value under the same name."""
    args = (320, 180, 3, 5, False, "depth", 128, "bvh", (8, 32), True)
    assert len(args) == len(dataclasses.fields(JOptions))
    j, t = JOptions(*args), RenderOptions(*args)
    for f in dataclasses.fields(JOptions):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.tri_backend == "bvh" and t.ray_tile == (8, 32)


@pytest.mark.parametrize("kw", [{}, dict(major=2.5, minor=0.6, n_major=7,
                                         n_minor=5)])
def test_torus_matches_jax(kw):
    """torus() at the defaults and at another size: the JAX positions and
    normals bit for bit, two triangles a quad of the surface."""
    want_p, want_n = jmeshgen.torus(**kw)
    got_p, got_n = meshgen.torus(**kw)
    assert got_p.dtype == np.float32 and got_n.dtype == np.float32
    np.testing.assert_array_equal(got_p.view(np.int32), want_p.view(np.int32))
    np.testing.assert_array_equal(got_n.view(np.int32), want_n.view(np.int32))
    n_major, n_minor = kw.get("n_major", 24), kw.get("n_minor", 12)
    assert got_p.shape == (2 * n_major * n_minor, 3, 3)
