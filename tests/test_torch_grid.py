"""The uniform-grid repulsion family of the port on the CPU — binning, cell
statistics, the far field (kernel K5's plain version), the near field (K6's)
and the whole ``grid_repulsion`` stage — against the reference package: its
plain versions and its Pallas kernels in interpret mode. Inputs are made
with numpy from a seed and handed to both.

Tolerances:
- Cell ids, the stable cell order and the cell statistics are bitwise: the
  same unfused float32 operations in the same order.
- Far field, per node and axis: |Δf_i| ≤ 1e-5·Σ_j|f_ij|. Each pair force
  agrees to an ulp (the reference's compiler may fuse d² into a fused
  multiply-add), and the two sums over ≤ 1,024 cells run in other orders.
- Near field: |Δf_i| ≤ 1e-5·Σ_j|f_ij| per node and axis, for the same
  reason; the port's halo rows are bitwise its full version's rows.
- The whole stage: the per-row bound of its two fields added.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import forceatlas2 as jfa2  # noqa: E402
from repro.kernels.grid import ops as jax_grid_ops  # noqa: E402
from repro.kernels.grid import ref as jax_grid  # noqa: E402
from repro.kernels.grid.tiled import far_field_pallas, near_field_pallas  # noqa: E402

from repro_torch.convert import config_from_reference  # noqa: E402
from repro_torch.core import forceatlas2 as fa2  # noqa: E402
from repro_torch.kernels.grid import ops as grid_ops  # noqa: E402
from repro_torch.kernels.grid import ref as grid  # noqa: E402

KR = 80.0
TOL = 1e-5


def _t(x):
    return torch.as_tensor(np.array(x))


def _points(n, seed, half=300.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-half, half, (n, 2)).astype(np.float32)
    mass = rng.uniform(0.5, 4.0, n).astype(np.float32)
    return pos, mass


def _sorted_state(pos, mass, g):
    cell, order = jax_grid.bin_and_sort(jnp.asarray(pos), g)
    o = np.asarray(order)
    return pos[o], mass[o], np.asarray(cell)[o]


def _far_scale(pos, mass, cell, ccent, cmass):
    """Σ_j |f_ij| per node and axis, in float64."""
    p, c = pos.astype(np.float64), ccent.astype(np.float64)
    dx = p[:, 0:1] - c[None, :, 0]
    dy = p[:, 1:2] - c[None, :, 1]
    mag = KR * mass[:, None] * cmass[None, :] / np.maximum(dx * dx + dy * dy, 1e-4)
    mag[cell[:, None] == np.arange(len(cmass))[None, :]] = 0.0
    return np.stack([np.abs(mag * dx).sum(1), np.abs(mag * dy).sum(1)], 1)


def _near_scale(pos_s, mass_s, cell_s, window):
    n = len(pos_s)
    out = np.zeros((n, 2))
    p = pos_s.astype(np.float64)
    for k in range(-window, window + 1):
        j = np.arange(n) + k
        ok = (j >= 0) & (j < n) & (k != 0)
        jj = np.clip(j, 0, n - 1)
        ok &= cell_s[jj] == cell_s
        d = p - p[jj]
        mag = np.where(ok, KR * mass_s * mass_s[jj] / np.maximum((d * d).sum(1), 1e-4), 0)
        out += np.abs(mag[:, None] * d)
    return out


def _within(got, want, scale):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    assert np.all(np.abs(got - want) <= TOL * scale + 1e-30), float(
        np.max(np.abs(got - want) - TOL * scale))


@pytest.mark.parametrize("case", ["random", "one_cell", "zero_extent", "huge_coords",
                                  "ties", "single_node"])
def test_binning_bitwise(case):
    g = 64
    pos, _ = _points(3000, 1)
    if case == "one_cell":
        g = 1
    elif case == "zero_extent":
        pos[:] = pos[0]
    elif case == "huge_coords":
        pos = pos * np.float32(1e30)
    elif case == "ties":
        pos = np.round(pos / 50) * 50  # many nodes on cell boundaries
    elif case == "single_node":
        pos = pos[:1]
    jc, jo = jax_grid.bin_and_sort(jnp.asarray(pos), g)
    tc, to = grid.bin_and_sort(_t(pos), g)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(grid.bin_nodes(_t(pos), g).numpy(),
                                  np.asarray(jax_grid.bin_nodes(jnp.asarray(pos), g)))


@pytest.mark.parametrize("n,g", [(300, 8), (1000, 16), (512, 32), (2000, 64)])
def test_cell_stats_and_far_field(n, g):
    pos, mass = _points(n, n + g)
    mass[-5:] = 0.0  # dead padding
    pos_s, mass_s, cell_s = _sorted_state(pos, mass, g)
    jcc, jcm = jax_grid_ops.cell_stats(jnp.asarray(pos_s), jnp.asarray(mass_s),
                                       jnp.asarray(cell_s), g * g, backend="ref")
    tcc, tcm = grid_ops.cell_stats(_t(pos_s), _t(mass_s), _t(cell_s), g * g)
    np.testing.assert_array_equal(tcc.numpy(), np.asarray(jcc))
    np.testing.assert_array_equal(tcm.numpy(), np.asarray(jcm))
    ccent, cmass = np.asarray(jcc), np.asarray(jcm)
    args = (pos_s, mass_s, cell_s, ccent, cmass)
    want = jax_grid.far_field_ref(*[jnp.asarray(x) for x in args], KR)
    pallas = far_field_pallas(*[jnp.asarray(x) for x in args], KR, ti=128, tc=128,
                              interpret=True)
    scale = _far_scale(*args)
    for got in (grid.far_field_ref(*[_t(x) for x in args], KR),
                grid.far_field_ref(*[_t(x) for x in args], KR, nb=96),
                grid_ops.far_field(*[_t(x) for x in args], KR)):
        _within(got, want, scale)
        _within(got, pallas, scale)


def test_far_field_padding_and_empty_cells_are_neutral():
    """Mass-0 nodes with cell −1 exert and receive nothing; empty cells
    (mass 0, centroid 0) contribute nothing."""
    pos, mass = _points(200, 17, half=50.0)
    cell, _ = grid.bin_and_sort(_t(pos), 8)
    ccent, cmass = grid_ops.cell_stats(_t(pos), _t(mass), cell, 64)
    f1 = grid_ops.far_field(_t(pos), _t(mass), cell, ccent, cmass, KR)
    pos_p = torch.cat([_t(pos), torch.zeros(56, 2)])
    mass_p = torch.cat([_t(mass), torch.zeros(56)])
    cell_p = torch.cat([cell, torch.full((56,), -1, dtype=torch.int32)])
    f2 = grid_ops.far_field(pos_p, mass_p, cell_p, ccent, cmass, KR)
    assert torch.equal(f1, f2[:200]) and not f2[200:].any()
    assert int((cmass == 0).sum()) > 0  # the case has empty cells


@pytest.mark.parametrize("n,g,window", [
    (300, 8, 16),
    (700, 4, 64),    # heavy cells: occupancy far above the window
    (256, 16, 0),    # empty band
    (100, 1, 256),   # window > n, one cell
    (1, 1, 4),       # a single node
    (600, 8, 31),    # windows beside the full layout's 32
    (600, 8, 33),
    (20, 2, 32),     # n < window
])
def test_near_field(n, g, window):
    pos, mass = _points(n, n + window)
    pos_s, mass_s, cell_s = _sorted_state(pos, mass, g)
    jargs = [jnp.asarray(x) for x in (pos_s, mass_s, cell_s)]
    want = jax_grid.near_field_ref(*jargs, KR, window)
    pallas = near_field_pallas(*jargs, KR, window, ti=128, interpret=True)
    scale = _near_scale(pos_s, mass_s, cell_s, window)
    targs = [_t(x) for x in (pos_s, mass_s, cell_s)]
    got = grid.near_field_ref(*targs, KR, window)
    assert torch.equal(got, grid_ops.near_field_sorted(*targs, KR, window))
    _within(got, want, scale)
    _within(got, pallas, scale)
    if window == 0:
        assert not got.any()


def test_near_field_rows_bitwise_and_against_reference():
    """Halo rows == the full version's rows, bitwise; and the reference's
    halo rows within the near-field tolerance."""
    rng = np.random.default_rng(1)
    n = 160
    pos = rng.uniform(-10, 10, (n, 2)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    pos_s, mass_s, cell_s = _sorted_state(pos, mass, 4)
    targs = [_t(x) for x in (pos_s, mass_s, cell_s)]
    jargs = [jnp.asarray(x) for x in (pos_s, mass_s, cell_s)]
    full = grid.near_field_ref(*targs, 7.0, 16)
    scale = _near_scale(pos_s, mass_s, cell_s, 16) * 7.0 / KR
    for i0, nl in ((0, 40), (40, 40), (120, 40), (8, 16)):
        part = grid.near_field_rows(*targs, 7.0, 16, i0, nl)
        assert torch.equal(full[i0:i0 + nl], part)
        want = jax_grid.near_field_rows(*jargs, 7.0, 16, i0, nl)
        _within(part, want, scale[i0:i0 + nl])


@pytest.mark.parametrize("n,g,window", [(400, 8, 8), (900, 16, 32), (300, 4, 64)])
def test_grid_repulsion_and_dense_match_reference(n, g, window):
    pos, mass = _points(n, 3 * n)
    mass[-7:] = 0.0
    want = jax_grid_ops.grid_repulsion(jnp.asarray(pos), jnp.asarray(mass), KR, g, window,
                                       backend="ref")
    got = grid_ops.grid_repulsion(_t(pos), _t(mass), KR, g, window)
    pos_s, mass_s, cell_s = _sorted_state(pos, mass, g)
    tcc, tcm = grid_ops.cell_stats(_t(pos_s), _t(mass_s), _t(cell_s), g * g)
    scale_s = (_far_scale(pos_s, mass_s, cell_s, tcc.numpy(), tcm.numpy())
               + _near_scale(pos_s, mass_s, cell_s, window))
    _, order = grid.bin_and_sort(_t(pos), g)
    scale = np.empty_like(scale_s)
    scale[order.numpy()] = scale_s
    _within(got, want, scale)
    # Precomputed (cell, order) give the same forces.
    cell, order = grid.bin_and_sort(_t(pos), g)
    assert torch.equal(grid_ops.grid_repulsion(_t(pos), _t(mass), KR, g, window,
                                               cell=cell, order=order), got)
    # The dense baseline: the own-cell monopole is added and subtracted
    # again, so its far field carries the rounding of that large term.
    jcfg = jfa2.FA2Config(repulsion="grid_dense", grid_size=g, grid_window=window,
                          repulsion_k=KR)
    want_d = np.asarray(jfa2._grid_repulsion(jnp.asarray(pos), jnp.asarray(mass), jcfg))
    got_d = fa2._grid_repulsion(_t(pos), _t(mass), config_from_reference(jcfg)).numpy()
    np.testing.assert_allclose(got_d, want_d, rtol=1e-4, atol=1e-5 * np.abs(want_d).max())
    np.testing.assert_allclose(got_d, got.numpy(), rtol=1e-3,
                               atol=1e-4 * np.abs(want_d).max())


def test_cpu_wrappers_take_the_plain_versions_and_meta_raises():
    pos, mass = _points(64, 5)
    pos_s, mass_s, cell_s = [_t(x) for x in _sorted_state(pos, mass, 4)]
    ccent, cmass = grid_ops.cell_stats(pos_s, mass_s, cell_s, 16)
    assert torch.equal(grid_ops.far_field(pos_s, mass_s, cell_s, ccent, cmass, KR),
                       grid.far_field_ref(pos_s, mass_s, cell_s, ccent, cmass, KR))
    meta = [x.to("meta") for x in (pos_s, mass_s, cell_s)]
    with pytest.raises(ValueError, match="unsupported device"):
        grid_ops.near_field_sorted(*meta, KR, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        grid_ops.far_field(*meta, ccent.to("meta"), cmass.to("meta"), KR)
