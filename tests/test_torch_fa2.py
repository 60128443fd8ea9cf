"""ForceAtlas2 ("exact" backend): the port on the CPU against the reference
package from shared inputs made with numpy.

Tolerances: the degree init is the same float32 formula, but the
reference's compiled square root and the two libraries' sines and cosines
each round within 1 ulp of the true value, so positions agree to ≤ 2 ulp
(measured: 2). Layout positions after a few iterations differ only by
summation order in the repulsion and attraction sums, amplified by the
speed controller: |Δpos| ≤ 1e-4·max|pos|. Trace rows (sums over all nodes
of force differences) compare at rtol 1e-4 plus 1e-5 of their column's
largest value, since a small g_swing is a difference of large forces. The
adaptive stop's iteration count and the ``nan_guard`` recovery count are
exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import forceatlas2 as jfa2  # noqa: E402

from repro_torch.convert import config_from_reference, state_from_numpy  # noqa: E402
from repro_torch.core import forceatlas2 as fa2  # noqa: E402


def _inputs(n=150, e=600, seed=0, poison=0):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, (e, 2)).astype(np.int32)
    edges[-20:] = n  # trash-padded slots
    w = rng.integers(1, 6, e).astype(np.float32)
    if poison:
        w[rng.choice(e - 20, size=poison, replace=False)] = np.nan
    mass = rng.integers(1, 400, n).astype(np.float32)
    mass[-10:] = 0.0  # dead padding supernodes
    pos0 = rng.uniform(-1000, 1000, (n, 2)).astype(np.float32)
    return edges, w, mass, pos0, n


def _close_pos(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def _close_trace(got, want):
    got, want = got.numpy(), np.asarray(want)
    for c in range(want.shape[1]):
        atol = 1e-5 * float(np.abs(want[:, c]).max())
        np.testing.assert_allclose(got[:, c], want[:, c], rtol=1e-4, atol=atol)


def test_init_degree_within_two_ulp():
    rng = np.random.default_rng(1)
    mass = rng.integers(0, 30, 700).astype(np.float32)  # many ties
    want = jfa2.init_positions_degree(700, jnp.asarray(mass))
    got = fa2.init_positions_degree(700, torch.as_tensor(mass))
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=2)


@pytest.mark.parametrize("n", [701, 1031])
def test_init_degree_within_two_ulp_at_ragged_lengths(n):
    """Lengths that are no multiple of any vector width put elements in the
    scalar tail of a vectorised loop; the init must not depend on that."""
    rng = np.random.default_rng(n)
    mass = rng.integers(0, 30, n).astype(np.float32)
    want = jfa2.init_positions_degree(n, jnp.asarray(mass))
    got = fa2.init_positions_degree(n, torch.as_tensor(mass))
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=2)
    tail = fa2.init_positions_degree(n - 1, torch.as_tensor(mass[:-1]))
    np.testing.assert_array_max_ulp(
        tail.numpy(), np.asarray(jfa2.init_positions_degree(n - 1, jnp.asarray(mass[:-1]))),
        maxulp=2)


@pytest.mark.parametrize("use_radii", [True, False])
@pytest.mark.parametrize("strong_gravity", [False, True])
def test_layout_from_shared_pos0(use_radii, strong_gravity):
    edges, w, mass, pos0, n = _inputs()
    jcfg = jfa2.FA2Config(iterations=5, use_radii=use_radii,
                          strong_gravity=strong_gravity)
    want_p, want_t, want_it = jfa2.layout(
        jnp.asarray(edges), jnp.asarray(w), jnp.asarray(mass), n, jcfg,
        pos0=jnp.asarray(pos0),
    )
    got_p, got_t, got_it = fa2.layout(
        edges, w, mass, n, config_from_reference(jcfg),
        pos0=state_from_numpy("pos0", pos0), device="cpu",
    )
    _close_pos(got_p, want_p)
    _close_trace(got_t, want_t)
    assert got_it == int(want_it) == 5


def test_layout_init_degree_matches():
    edges, w, mass, _, n = _inputs(seed=2)
    jcfg = jfa2.FA2Config(iterations=3, init="degree")
    want_p, _, _ = jfa2.layout(jnp.asarray(edges), jnp.asarray(w),
                               jnp.asarray(mass), n, jcfg)
    got_p, _, _ = fa2.layout(edges, w, mass, n, config_from_reference(jcfg),
                             device="cpu")
    _close_pos(got_p, want_p)


def test_adaptive_stop_iterations_and_trace():
    edges, w, mass, pos0, n = _inputs(seed=3)
    jcfg = jfa2.FA2Config(iterations=60, stop_tolerance=0.6, min_iterations=5,
                          init="degree")
    want_p, want_t, want_it = jfa2.layout(
        jnp.asarray(edges), jnp.asarray(w), jnp.asarray(mass), n, jcfg
    )
    got_p, got_t, got_it = fa2.layout(edges, w, mass, n,
                                      config_from_reference(jcfg), device="cpu")
    assert 5 <= got_it == int(want_it) < 60
    _close_trace(got_t, want_t)
    assert not got_t[got_it:].any()  # frozen iterations trace zero rows
    _close_pos(got_p, want_p)


@pytest.mark.parametrize("stop_tolerance", [0.0, 0.5, 1e9])
def test_nan_guard_recovery_count_matches(stop_tolerance):
    edges, w, mass, pos0, n = _inputs(seed=4, poison=4)
    jcfg = jfa2.FA2Config(iterations=20, nan_guard=True, min_iterations=1,
                          stop_tolerance=stop_tolerance)
    want_p, want_t, want_it = jfa2.layout(
        jnp.asarray(edges), jnp.asarray(w), jnp.asarray(mass), n, jcfg,
        pos0=jnp.asarray(pos0),
    )
    got_p, got_t, got_it = fa2.layout(edges, w, mass, n,
                                      config_from_reference(jcfg),
                                      pos0=torch.as_tensor(pos0), device="cpu")
    assert got_it == int(want_it)
    assert fa2.recovery_count(got_t) == jfa2.recovery_count(want_t) > 0
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))  # never moved
    unguarded, _, _ = fa2.layout(edges, w, mass, n, fa2.FA2Config(iterations=3),
                                 pos0=torch.as_tensor(pos0), device="cpu")
    assert not torch.isfinite(unguarded).all()


def test_single_step_matches():
    edges, w, mass, pos0, n = _inputs(seed=5)
    jcfg = jfa2.FA2Config()
    radii = np.sqrt(mass)
    jstate = (jnp.asarray(pos0), jnp.zeros_like(jnp.asarray(pos0)), jnp.asarray(1.0))
    (jp, jf, jg), jrow = jfa2.step(jstate, jnp.asarray(edges), jnp.asarray(w),
                                   jnp.asarray(mass), jnp.asarray(radii), jcfg, n)
    p = torch.as_tensor(pos0)
    (tp, tf, tg), trow = fa2.step(
        (p, torch.zeros_like(p), torch.tensor(1.0)), torch.as_tensor(edges),
        torch.as_tensor(w), torch.as_tensor(mass), torch.as_tensor(radii),
        config_from_reference(jcfg), n,
    )
    _close_pos(tp, jp)
    np.testing.assert_allclose(trow.numpy(), np.asarray(jrow), rtol=1e-4)


def test_random_and_bfs_inits_are_seeded_and_grid_backends_raise():
    """The seeded inits repeat and are the reference's starts ("random"
    bitwise, "bfs" within the tolerance of test_torch_prng.py); an unknown
    repulsion backend raises. (The grid backends run since the full-graph
    slice: test_torch_full_layout.py.)"""
    edges, w, mass, _, n = _inputs(seed=6)
    for init in ("random", "bfs"):
        cfg = fa2.FA2Config(init=init, seed=3)
        a = fa2.initial_positions(torch.as_tensor(edges), torch.as_tensor(mass), n, cfg)
        b = fa2.initial_positions(torch.as_tensor(edges), torch.as_tensor(mass), n, cfg)
        assert a.shape == (n, 2) and torch.isfinite(a).all()
        assert torch.equal(a, b)
        want = np.asarray(jfa2._initial_positions_jit(
            jnp.asarray(edges), jnp.asarray(mass), n, jfa2.FA2Config(init=init, seed=3)))
        if init == "random":
            np.testing.assert_array_equal(a.numpy().view(np.uint32), want.view(np.uint32))
        else:
            np.testing.assert_allclose(a.numpy(), want, rtol=0,
                                       atol=8 * np.spacing(np.abs(want).max()))
    for backend in ("barnes_hut", "Grid", ""):
        with pytest.raises(ValueError, match="unknown repulsion backend"):
            fa2.layout(edges, w, mass, n, fa2.FA2Config(repulsion=backend),
                       device="cpu")


# A bfloat16 layout: the port widens K2's and the attraction's inputs to
# float32 and rounds each force once (its kernels and plain versions alike),
# where the reference forms and sums every pair term in bfloat16. Positions
# agree within 2^-7·max|pos| (two bfloat16 ulps of the largest coordinate;
# measured 3.98e-3 at 1 and 3.92e-3 at 3 iterations, radii on and off); the
# speed controller doubles that by 5 iterations (7.75e-3), so the gate holds
# up to 3. Trace rows agree within 2^-7 of their column's largest value
# (measured 4.0e-3).
BF16_TOL = 2.0**-7


def _bf16_host(x):
    """A bfloat16 array of either package as float32 holding its values."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return x.float().numpy()
    assert x.dtype == jnp.bfloat16
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("iterations", [1, 3])
@pytest.mark.parametrize("use_radii", [True, False])
def test_bfloat16_layout_from_shared_pos0(iterations, use_radii):
    edges, w, mass, pos0, n = _inputs()
    jcfg = jfa2.FA2Config(iterations=iterations, use_radii=use_radii, dtype="bfloat16")
    want_p, want_t, want_it = jfa2.layout(
        jnp.asarray(edges), jnp.asarray(w), jnp.asarray(mass), n, jcfg,
        pos0=jnp.asarray(pos0),
    )
    got_p, got_t, got_it = fa2.layout(
        edges, w, mass, n, config_from_reference(jcfg),
        pos0=state_from_numpy("pos0", pos0), device="cpu",
    )
    assert got_p.dtype == got_t.dtype == torch.bfloat16
    gp, wp = _bf16_host(got_p), _bf16_host(want_p)
    assert np.isfinite(gp).all()
    np.testing.assert_allclose(gp, wp, rtol=0, atol=BF16_TOL * np.abs(wp).max())
    gt, wt = _bf16_host(got_t), _bf16_host(want_t)
    for c in range(3):
        np.testing.assert_allclose(gt[:, c], wt[:, c], rtol=0,
                                   atol=BF16_TOL * float(np.abs(wt[:, c]).max()))
    assert got_it == int(want_it) == iterations


def test_bfloat16_single_step_matches():
    """One ``step`` on a bfloat16 state: the two-scatter attraction forms
    its terms in bfloat16 as the reference does and adds them in float32."""
    edges, w, mass, pos0, n = _inputs(seed=5)
    jcfg = jfa2.FA2Config(dtype="bfloat16")
    bf = jnp.bfloat16
    radii = np.sqrt(mass)
    jstate = (jnp.asarray(pos0, bf), jnp.zeros((n, 2), bf), jnp.asarray(1.0, bf))
    (jp, _, _), jrow = jfa2.step(jstate, jnp.asarray(edges), jnp.asarray(w, bf),
                                 jnp.asarray(mass, bf), jnp.asarray(radii, bf), jcfg, n)
    t = torch.bfloat16
    p = torch.as_tensor(pos0).to(t)
    (tp, _, _), trow = fa2.step(
        (p, torch.zeros_like(p), torch.tensor(1.0, dtype=t)), torch.as_tensor(edges),
        torch.as_tensor(w).to(t), torch.as_tensor(mass).to(t),
        torch.as_tensor(radii).to(t), config_from_reference(jcfg), n,
    )
    assert tp.dtype == trow.dtype == t
    gp, wp = _bf16_host(tp), _bf16_host(jp)
    np.testing.assert_allclose(gp, wp, rtol=0, atol=BF16_TOL * np.abs(wp).max())
    gr, wr = _bf16_host(trow), _bf16_host(jrow)
    np.testing.assert_allclose(gr, wr, rtol=BF16_TOL)


def test_bfloat16_recovery_count_matches():
    """``recovery_count`` reads a bfloat16 ``nan_guard`` trace (numpy has no
    bfloat16: the trace leaves as float32)."""
    edges, w, mass, pos0, n = _inputs(seed=4, poison=4)
    jcfg = jfa2.FA2Config(iterations=6, nan_guard=True, dtype="bfloat16")
    want_p, want_t, _ = jfa2.layout(jnp.asarray(edges), jnp.asarray(w), jnp.asarray(mass),
                                    n, jcfg, pos0=jnp.asarray(pos0))
    got_p, got_t, _ = fa2.layout(edges, w, mass, n, config_from_reference(jcfg),
                                 pos0=torch.as_tensor(pos0), device="cpu")
    assert got_t.dtype == torch.bfloat16
    assert fa2.recovery_count(got_t) == jfa2.recovery_count(want_t) == 6
    np.testing.assert_array_equal(_bf16_host(got_p), _bf16_host(want_p))  # never moved


def test_float64_layout_is_the_references_float32():
    """With 64-bit types off (the reference's default) "float64" computes in
    float32 and warns: positions, trace and the warning as the reference's."""
    edges, w, mass, pos0, n = _inputs(seed=7)
    jcfg = jfa2.FA2Config(iterations=3, dtype="float64")
    with pytest.warns(UserWarning, match="float64"):
        want_p, want_t, _ = jfa2.layout(jnp.asarray(edges), jnp.asarray(w),
                                        jnp.asarray(mass), n, jcfg, pos0=jnp.asarray(pos0))
    with pytest.warns(UserWarning, match="float64"):
        got_p, got_t, _ = fa2.layout(edges, w, mass, n, config_from_reference(jcfg),
                                     pos0=torch.as_tensor(pos0), device="cpu")
    assert np.asarray(want_p).dtype == np.float32 and got_p.dtype == torch.float32
    assert got_t.dtype == torch.float32
    _close_pos(got_p, want_p)
    _close_trace(got_t, want_t)
    f32, _, _ = fa2.layout(edges, w, mass, n, fa2.FA2Config(iterations=3),
                           pos0=torch.as_tensor(pos0), device="cpu")
    assert torch.equal(got_p, f32)
    with pytest.raises(ValueError, match="unknown layout dtype"):
        fa2.layout(edges, w, mass, n, fa2.FA2Config(dtype="int8"), device="cpu")
