"""The lowering probes' plain versions (the port's
``scripts/probe_kernel_ops.probe_plain``) against the TPU probes of
``scripts/probe_kernel_ops.py``.

The JAX script is loaded by its path (``scripts/`` is no package) and its
``kernel_a``, ``kernel_b`` and ``kernel_c`` run through
``pl.pallas_call(..., interpret=True)`` with the block and scratch specs
of its ``run``, on the port's seeded inputs (``probe_inputs``): the ones,
integers 0-2 (C never fires), integers 0-3 (C fires in columns of both
halves, some only in rows 0-255, some only in rows 256-511) and uniform
floats with a few entries above 2.  On the integer inputs every sum is
exact, so each probe equals the JAX one bit for bit; on the floats A and
B add in another order than JAX's (the sum of each column, then the
columns in turn, against ``x.sum()``): rtol 1e-6 of the sum
(``probe_kernel_ops.RTOL``; 6e-8 observed).  C adds each fired column in
ascending order, as the TPU kernel does, and equals it bit for bit on
every input.  The CUDA kernels run only on the card (chip_smoke.py
phases 3, 4 and 6 hold them to these plain versions there).
"""
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from simple_raytracer_tpu_torch.scripts import probe_kernel_ops as probe

JAX_SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / \
    "probe_kernel_ops.py"
INPUTS = tuple(probe.probe_inputs())
INTEGER_INPUTS = ("ones", "ints_0_2", "ints_0_3")


@pytest.fixture(scope="module")
def jax_probes():
    """probe name -> the JAX probe on a (512, 128) numpy array, in Pallas
    interpret mode with its ``run``'s specs."""
    spec = importlib.util.spec_from_file_location("jax_probe_kernel_ops",
                                                  JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    kernels = {"A": (mod.kernel_a, (mod.BR, mod.C)),
               "B": (mod.kernel_b, (1, mod.C)),
               "C": (mod.kernel_c, (mod.BR, mod.C))}

    def call(name, x):
        kernel, scr_shape = kernels[name]
        f = pl.pallas_call(
            kernel, grid=(1,),
            in_specs=[pl.BlockSpec((mod.BR, mod.C), lambda i: (0, 0),
                                   memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((mod.BR, mod.C), lambda i: (0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((mod.BR, mod.C), jnp.float32),
            scratch_shapes=[pltpu.VMEM(scr_shape, jnp.float32)],
            interpret=True)
        return np.asarray(f(jnp.asarray(x)))

    assert (mod.BR, mod.C) == (probe.ROWS, probe.COLS)
    return call


@pytest.fixture(scope="module")
def inputs():
    return probe.probe_inputs()


def plain(name, x):
    return probe.probe_plain(name, torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("name", tuple(probe.PROBES))
@pytest.mark.parametrize("key", INPUTS)
def test_probe_plain_matches_jax(jax_probes, inputs, key, name):
    """Each plain probe against the JAX probe on each seeded input: bit
    for bit, but A and B within RTOL of the sum on the uniform floats."""
    x = inputs[key]
    want = jax_probes(name, x)
    got = plain(name, x)
    assert got.shape == want.shape and got.dtype == want.dtype
    if key in INTEGER_INPUTS or name == "C":
        np.testing.assert_array_equal(got, want)
    else:
        total = float(np.abs(want).max())
        assert np.all(np.abs(got - want) <= probe.RTOL * total)
    assert probe.agrees(name, torch.from_numpy(x),
                        torch.from_numpy(want.copy()))


def test_probe_c_fires_in_one_half(jax_probes, inputs):
    """C on the integers 0-3: a column that fires only in rows 0-255 adds
    to rows 256-511 too, as the JAX probe does (the port's kernel used to
    gate each half of 256 rows apart, and its plain version gave zeros)."""
    x = inputs["ints_0_3"]
    above = x > 2
    low_only = np.flatnonzero(above[:256].any(0) & ~above[256:].any(0))
    high_only = np.flatnonzero(above[256:].any(0) & ~above[:256].any(0))
    assert len(low_only) == 8 and len(high_only) == 8
    want = jax_probes("C", x)
    got = plain("C", x)
    np.testing.assert_array_equal(got[256:], want[256:])
    fired = np.flatnonzero(above.any(0))
    row_sums = x[:, fired].sum(axis=1)      # exact: small integers
    np.testing.assert_array_equal(got, np.repeat(row_sums[:, None],
                                                 probe.COLS, axis=1))
    # a gate over rows 256-511 alone would leave the low-only columns out
    # of those rows
    half_gated = x[256:, np.flatnonzero(above[256:].any(0))].sum(axis=1)
    assert np.any(half_gated != row_sums[256:])


def _hand_input():
    x = np.ones((probe.ROWS, probe.COLS), np.float32)
    x[10, 5] = 3.0
    x[300, 70] = 2.5
    return x


# the hand input's outputs: rows 10 and 300, and every other row
HAND = {"A": (65539.5, 65539.5, 65539.5), "B": (65539.5, 65539.5, 65539.5),
        "C": (4.0, 3.5, 2.0)}


@pytest.mark.parametrize("name", tuple(probe.PROBES))
def test_probe_plain_hand_computed(jax_probes, name):
    """A ones array with 3 at (10, 5) and 2.5 at (300, 70): A and B give
    the sum, 65536 + 2 + 1.5, everywhere; C fires in columns 5 and 70, so
    each row's output is x[r, 5] + x[r, 70]: 4 in row 10, 3.5 in row 300,
    2 elsewhere.  The JAX probe gives the same."""
    x = _hand_input()
    got = plain(name, x)
    r10, r300, other = HAND[name]
    want = np.full(x.shape, other, np.float32)
    want[10], want[300] = r10, r300
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jax_probes(name, x), want)


def test_probe_inputs_are_seeded(inputs):
    """probe_inputs: (512, 128) f32 arrays, the same for the same seed;
    ints_0_2 never fires C; uniform fires it in 8 columns."""
    again = probe.probe_inputs()
    for key, x in inputs.items():
        assert x.shape == (probe.ROWS, probe.COLS) and x.dtype == np.float32
        np.testing.assert_array_equal(x, again[key])
    assert inputs["ints_0_2"].max() == 2.0
    assert set(np.unique(inputs["ints_0_3"])) == {0.0, 1.0, 2.0, 3.0}
    assert int((inputs["ints_0_3"] > 2).any(0).sum()) == 24
    assert int((inputs["uniform"] > 2).any(0).sum()) == 8
    assert not np.array_equal(inputs["uniform"],
                              probe.probe_inputs(seed=1)["uniform"])


def test_agrees_holds_the_stated_tolerance(inputs):
    """agrees: bit for bit on integer values and for C; A and B within
    RTOL of the sum on the floats, not beyond it."""
    x = torch.from_numpy(inputs["uniform"])
    total = float(x.sum())
    for name in ("A", "B"):
        want = probe.probe_plain(name, x)
        assert probe.agrees(name, x, want + 0.5 * probe.RTOL * total)
        assert not probe.agrees(name, x, want + 2 * probe.RTOL * total)
    want = probe.probe_plain("C", x)
    assert not probe.agrees("C", x, want + 1e-7 * want.abs().max())
    xi = torch.from_numpy(inputs["ints_0_3"])
    for name in probe.PROBES:
        want = probe.probe_plain(name, xi)
        assert probe.agrees(name, xi, want.clone())
        assert not probe.agrees(name, xi, want + 1.0)


def test_probe_source_matches_the_wrapper():
    """The CUDA source's cluster, empty launch, marks and C interface
    version are the wrapper's; the launch takes the timing instance's
    cycles and refuses a buffer of another shape before any launch."""
    src = Path(probe.SOURCE).read_text()
    assert re.search(rf"kCluster = {probe.CLUSTER};", src)
    assert re.search(rf"kEmptyLaunch = {probe.EMPTY}\b", src)
    body = re.search(r"enum Mark \{(.*?)\};", src, re.S).group(1)
    marks = re.findall(r"kMark(?!s\b)(\w+) = (\d+)", body)
    assert [int(v) for _, v in marks] == list(range(len(probe.MARKS)))
    assert [re.sub(r"(?<!^)([A-Z])", r"_\1", n).lower()
            for n, _ in marks] == list(probe.MARKS)
    assert re.search(rf"kMarks = {len(probe.MARKS)}\b", src)
    assert re.search(r"int srt_probe_interface\(\) \{ return "
                     rf"{probe.INTERFACE}; \}}", src)
    assert probe.ROWS % probe.CLUSTER == 0
    x = torch.ones((probe.ROWS, probe.COLS))
    before = probe.KERNEL.launches
    with pytest.raises(ValueError, match="cycles must be"):
        probe.launch("C", x, x.clone(),
                     torch.zeros(probe.CLUSTER, dtype=torch.int64))
    with pytest.raises(ValueError, match="bad tensor"):
        probe.launch_empty(x, x.clone())
    assert probe.KERNEL.launches == before
