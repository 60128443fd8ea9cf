"""The slice's full-graph path on the CPU against the reference package:
ForceAtlas2 with the grid backends, ``full_layout_colored`` and the
layout-quality metrics. Inputs are made with numpy from a seed and handed
to both.

Tolerances: positions after a few iterations from a shared start differ by
the summation order of the grid fields, the attraction and the speed
controller's sums: |Δpos| ≤ 1e-4·max|pos| (measured ≤ 2e-5 at 8,000 nodes,
where a node may cross a cell boundary on one side only). Trace rows as in
test_torch_fa2.py. Groups, iteration counts, recovery counts and the
quality metrics' floats are exact.
"""
import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import repro  # noqa: E402
from repro.core import forceatlas2 as jfa2  # noqa: E402
from repro.graph.utils import mode_degree  # noqa: E402
from repro.kernels.grid import ref as jax_grid  # noqa: E402
from repro.quality import metrics as jax_quality  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.convert import config_from_reference  # noqa: E402
from repro_torch.core import forceatlas2 as fa2  # noqa: E402
from repro_torch.graph.generators import planted_partition  # noqa: E402
from repro_torch.kernels.grid import ref as grid  # noqa: E402
from repro_torch.obs.metrics import REGISTRY  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.quality import metrics as quality  # noqa: E402


def _inputs(n=400, e=1600, seed=0, poison=0):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, (e, 2)).astype(np.int32)
    edges[-20:] = n  # trash-padded slots
    w = rng.integers(1, 6, e).astype(np.float32)
    if poison:
        w[rng.choice(e - 20, size=poison, replace=False)] = np.nan
    mass = rng.integers(1, 40, n).astype(np.float32)
    mass[-10:] = 0.0
    pos0 = rng.uniform(-1000, 1000, (n, 2)).astype(np.float32)
    return edges, w, mass, pos0, n


def _close_pos(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def _close_trace(got, want):
    got, want = got.numpy(), np.asarray(want)
    for c in range(want.shape[1]):
        atol = 1e-5 * float(np.abs(want[:, c]).max())
        np.testing.assert_allclose(got[:, c], want[:, c], rtol=1e-4, atol=atol)


def _run(jcfg, edges, w, mass, pos0, n):
    want = jfa2.layout(jnp.asarray(edges), jnp.asarray(w), jnp.asarray(mass), n, jcfg,
                       pos0=jnp.asarray(pos0))
    got = fa2.layout(edges, w, mass, n, config_from_reference(jcfg),
                     pos0=torch.as_tensor(pos0), device="cpu")
    return want, got


@pytest.mark.parametrize("rebuild", [1, 3])
@pytest.mark.parametrize("repulsion", ["grid", "grid_dense"])
def test_grid_layout_from_shared_pos0(repulsion, rebuild):
    edges, w, mass, pos0, n = _inputs()
    jcfg = jfa2.FA2Config(iterations=8, repulsion=repulsion, grid_size=8, grid_window=8,
                          grid_rebuild=rebuild, use_radii=False)
    (wp, wt, wi), (gp, gt, gi) = _run(jcfg, edges, w, mass, pos0, n)
    _close_pos(gp, wp)
    _close_trace(gt, wt)
    assert gi == int(wi) == 8


def test_grid_pallas_is_grid_and_radii_are_ignored():
    """On the port the device picks the kernels, so "grid_pallas" is "grid";
    the grid backends ignore ``use_radii``, as in the reference."""
    edges, w, mass, pos0, n = _inputs(seed=1)
    runs = [fa2.layout(edges, w, mass, n,
                       fa2.FA2Config(iterations=4, repulsion=r, grid_size=8,
                                     use_radii=u),
                       pos0=torch.as_tensor(pos0), device="cpu")[0]
            for r, u in (("grid", False), ("grid_pallas", False), ("grid", True))]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


def test_grid_adaptive_stop_with_carry():
    """The adaptive stop composes with the (cell, order) carry, as the
    reference's test_adaptive_stop_grid_backend_with_carry pins it."""
    edges, w, mass, pos0, n = _inputs(n=180, e=700, seed=6)
    base = jfa2.FA2Config(iterations=20, repulsion="grid", grid_size=8, grid_window=8,
                          grid_rebuild=2, use_radii=False)
    adapt = dataclasses.replace(base, stop_tolerance=1e9, min_iterations=6)
    (wp, wt, wi), (gp, gt, gi) = _run(adapt, edges, w, mass, pos0, n)
    assert gi == int(wi) == 6
    assert not gt[6:].any()
    _close_pos(gp, wp)
    fixed, _, _ = fa2.layout(edges, w, mass, n,
                             config_from_reference(dataclasses.replace(base, iterations=6)),
                             pos0=torch.as_tensor(pos0), device="cpu")
    assert torch.equal(fixed, gp)
    # A tolerance that triggers on its own stops on the same iteration.
    real = dataclasses.replace(base, iterations=60, stop_tolerance=0.6, min_iterations=5)
    (wp, wt, wi), (gp, gt, gi) = _run(real, edges, w, mass, pos0, n)
    assert 5 <= gi == int(wi) < 60
    _close_trace(gt, wt)


@pytest.mark.parametrize("stop_tolerance", [0.0, 0.5])
def test_grid_nan_guard_recovery_count(stop_tolerance):
    edges, w, mass, pos0, n = _inputs(seed=4, poison=4)
    jcfg = jfa2.FA2Config(iterations=12, repulsion="grid", grid_size=8, grid_window=8,
                          nan_guard=True, min_iterations=1, stop_tolerance=stop_tolerance)
    (wp, wt, wi), (gp, gt, gi) = _run(jcfg, edges, w, mass, pos0, n)
    assert gi == int(wi)
    assert fa2.recovery_count(gt) == jfa2.recovery_count(wt) > 0
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))  # never moved


def test_grid_step_with_precomputed_cells():
    edges, w, mass, pos0, n = _inputs(seed=5)
    jcfg = jfa2.FA2Config(repulsion="grid", grid_size=8, grid_window=8)
    radii = np.sqrt(mass)
    cell, order = jax_grid.bin_and_sort(jnp.asarray(pos0), 8)
    jstate = (jnp.asarray(pos0), jnp.zeros_like(jnp.asarray(pos0)), jnp.asarray(1.0))
    jargs = [jnp.asarray(x) for x in (edges, w, mass, radii)]
    (jp, _, _), jrow = jfa2.step(jstate, *jargs, jcfg, n, cell=cell, order=order)
    p = torch.as_tensor(pos0)
    tcell, torder = grid.bin_and_sort(p, 8)
    targs = [torch.as_tensor(x) for x in (edges, w, mass, radii)]
    state = (p, torch.zeros_like(p), torch.tensor(1.0))
    (tp, _, _), trow = fa2.step(state, *targs, config_from_reference(jcfg), n,
                                cell=tcell, order=torder)
    _close_pos(tp, jp)
    np.testing.assert_allclose(trow.numpy(), np.asarray(jrow), rtol=1e-4)
    (up, _, _), _ = fa2.step(state, *targs, config_from_reference(jcfg), n)
    assert torch.equal(up, tp)  # the default re-bins the same positions


@pytest.mark.parametrize("n,iterations,init", [(5000, 4, "degree"), (1200, 3, "degree"),
                                              (5000, 4, "random"), (1200, 3, "random")],
                         ids=["5000-4", "1200-3", "5000-4-random", "1200-3-random"])
def test_full_layout_colored_matches_reference(n, iterations, init):
    """Above 4,096 nodes "exact" becomes "grid"; at 1,200 it stays exact.
    From the degree init and from the default "random" one, which draws the
    reference's start bit for bit."""
    edges, _ = planted_partition(n, 40, 0.02 * 5000 / n, 0.0004, seed=1)
    cfg = repro.default_config(n, len(edges), mode_degree(edges, n), iterations=5,
                               init=init)
    want_p, want_g = repro.full_layout_colored(edges, n, cfg, iterations=iterations)
    tr = Tracer()
    tcfg = dataclasses.replace(config_from_reference(cfg), obs=tr)
    got_p, got_g = repro_torch.full_layout_colored(edges, n, tcfg, iterations=iterations,
                                                   device="cpu")
    assert got_p.shape == (n, 2) and got_g.shape == (n,)
    np.testing.assert_array_equal(got_g, np.asarray(want_g))
    _close_pos(got_p, want_p)
    full = [s for s in tr.spans() if s.name == "layout.full"]
    assert full[0].attrs["repulsion"] == ("grid" if n > 4096 else "exact")
    assert {"layout.full.detect", "layout.full.supergraph"} <= tr.span_names()
    assert REGISTRY.gauge("layout.full_iterations_run").value == iterations


def test_full_layout_colored_adaptive_override():
    n = 120
    edges, _ = planted_partition(n, 4, 0.3, 0.01, seed=2)
    cfg = repro.default_config(n, len(edges), mode_degree(edges, n), rounds=2,
                               iterations=5, init="degree")
    tcfg = config_from_reference(cfg)
    want, _ = repro.full_layout_colored(edges, n, cfg, iterations=30, stop_tolerance=1e9,
                                        min_iterations=1)
    got, _ = repro_torch.full_layout_colored(edges, n, tcfg, iterations=30,
                                             stop_tolerance=1e9, min_iterations=1,
                                             device="cpu")
    assert REGISTRY.gauge("layout.full_iterations_run").value == 1
    _close_pos(got, want)
    longer, _ = repro_torch.full_layout_colored(edges, n, tcfg, iterations=30,
                                                device="cpu")
    assert not np.array_equal(longer, got)


def test_quality_metrics_identical_floats():
    n = 3000
    edges, _ = planted_partition(n, 30, 0.04, 0.0008, seed=0)
    rng = np.random.default_rng(0)
    for pos in (rng.uniform(-500, 500, (n, 2)).astype(np.float32),
                (rng.standard_normal((n, 2)) * 100).astype(np.float64)):
        for seed in (0, 3):
            want = jax_quality.layout_quality(pos, edges, n, seed=seed)
            got = quality.layout_quality(pos, edges, n, seed=seed)
            assert got == want
            for ring, band in ((2, 128), (1, 16)):
                kw = dict(n_samples=128, ring=ring, band=band, seed=seed)
                assert (quality.neighborhood_preservation(pos, edges, n, **kw)
                        == jax_quality.neighborhood_preservation(pos, edges, n, **kw))


def test_grid_knobs_in_config_and_signatures():
    for name in ("default_config", "full_layout_colored"):
        want = list(inspect.signature(getattr(repro, name)).parameters)
        got = list(inspect.signature(getattr(repro_torch, name)).parameters)
        assert got == want + (["device"] if name == "full_layout_colored" else []), name
    cfg = repro.default_config(500, 2000, 4, repulsion="grid", grid_size=32,
                               grid_window=16, grid_rebuild=3)
    got = config_from_reference(cfg)
    assert got == repro_torch.default_config(500, 2000, 4, repulsion="grid", grid_size=32,
                                             grid_window=16, grid_rebuild=3)
    assert (got.layout.grid_size, got.layout.grid_window, got.layout.grid_rebuild) == (
        32, 16, 3)


# ``layout.dtype="bfloat16"`` on the issue's planted-partition graph (3,000
# nodes: exact repulsion) and on 5,000 nodes (grid). The port forms and sums
# K2's pair terms and the attraction's in float32 and rounds each force once;
# the reference does that arithmetic in bfloat16. After one iteration the
# positions agree within 2^-7·max|pos| (measured 3.97e-3); the speed
# controller amplifies each node's one-ulp differences, and after three
# they agree within 2^-6·max|pos| (measured 7.81e-3 from the degree init,
# 1.17e-2 from the random one at 3,000 nodes, where the reference's own
# bfloat16 layout is 1.89e-2 from its float32 layout from the same start).
@pytest.mark.parametrize("case,iterations,init", [
    ("ppart-3000", 1, "random"), ("ppart-3000", 3, "random"), ("ppart-3000", 3, "degree"),
    ("grid-5000", 1, "degree"), ("grid-5000", 3, "degree")])
def test_full_layout_colored_bfloat16_matches_reference(case, iterations, init):
    if case == "ppart-3000":
        n = 3000
        edges, _ = planted_partition(n, 30, 0.04, 0.0008, seed=0)
    else:
        n = 5000
        edges, _ = planted_partition(n, 40, 0.02, 0.0004, seed=1)
    cfg = repro.default_config(n, len(edges), mode_degree(edges, n), iterations=5,
                               init=init)
    cfg = dataclasses.replace(cfg, layout=dataclasses.replace(cfg.layout, dtype="bfloat16"))
    want_p, want_g = repro.full_layout_colored(edges, n, cfg, iterations=iterations)
    tr = Tracer()
    tcfg = dataclasses.replace(config_from_reference(cfg), obs=tr)
    got_p, got_g = repro_torch.full_layout_colored(edges, n, tcfg, iterations=iterations,
                                                   device="cpu")
    full = [s for s in tr.spans() if s.name == "layout.full"]
    assert full[0].attrs["repulsion"] == ("grid" if n > 4096 else "exact")
    assert np.asarray(want_p).dtype == jnp.bfloat16 and got_p.dtype == np.float32
    # float32 holding bfloat16 values
    assert np.array_equal(torch.as_tensor(got_p).to(torch.bfloat16).float().numpy(), got_p)
    np.testing.assert_array_equal(got_g, np.asarray(want_g))
    want = np.asarray(want_p).astype(np.float32)
    tol = 2.0**-7 if iterations == 1 else 2.0**-6
    assert np.isfinite(got_p).all()
    np.testing.assert_allclose(got_p, want, rtol=0, atol=tol * np.abs(want).max())


def test_full_layout_colored_float64_is_the_references_float32():
    """"float64" truncated to float32 with a warning, in both packages."""
    n = 1200
    edges, _ = planted_partition(n, 40, 0.02 * 5000 / n, 0.0004, seed=1)
    cfg = repro.default_config(n, len(edges), mode_degree(edges, n), iterations=5)
    cfg = dataclasses.replace(cfg, layout=dataclasses.replace(cfg.layout, dtype="float64"))
    with pytest.warns(UserWarning, match="float64"):
        want_p, want_g = repro.full_layout_colored(edges, n, cfg, iterations=3)
    with pytest.warns(UserWarning, match="float64"):
        got_p, got_g = repro_torch.full_layout_colored(edges, n, config_from_reference(cfg),
                                                       iterations=3, device="cpu")
    assert np.asarray(want_p).dtype == got_p.dtype == np.float32
    np.testing.assert_array_equal(got_g, np.asarray(want_g))
    _close_pos(got_p, want_p)
