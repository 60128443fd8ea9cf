"""The port's seeded draws (``repro_torch.core.prng``) against ``jax.random``
on the CPU, and the FA2 starting layouts drawn from them against the
reference's.

Bitwise: keys, ``split``, ``random_bits``, ``uniform`` in float32,
bfloat16 and float16, ``normal`` and the compiled reference's float32
``log1p`` under it, and the "random" init in float32 and bfloat16 (the
draw is the whole init). The "bfs" init draws its jitter bitwise, but the reference
takes its float32 cosine and sine with its own approximations (within an
ulp of the correctly rounded ones the port takes) and its sums in its own
order: positions within 8 ulp of max|pos| (measured at most 5 on these
graphs); in bfloat16, where that can flip a rounding of the float32
result, within one bfloat16 ulp of max|pos| (measured: bitwise).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import forceatlas2 as jfa2  # noqa: E402

from repro_torch.convert import config_from_reference  # noqa: E402
from repro_torch.core import forceatlas2 as fa2  # noqa: E402
from repro_torch.core import prng  # noqa: E402

SEEDS = [0, 1, 7, 2**31 - 1, -1, 2**40]
SHAPES = [(0,), (1,), (5,), (1000, 2), (3, 7, 2)]
NORMAL_SHAPES = [(), (1,), (3, 5, 7), (200000,), (1 << 20,)]
DTYPES = {"float32": (jnp.float32, torch.float32, np.uint32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, np.uint16),
          "float16": (jnp.float16, torch.float16, np.uint16)}
BFS_ULP = 8


def _bits(x, view):
    """Bit patterns of a float array of either package."""
    if isinstance(x, torch.Tensor):
        itype = torch.int32 if x.element_size() == 4 else torch.int16
        return x.view(itype).numpy().view(view)
    return np.asarray(x).view(view)


def _graph(n, e, seed):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, (e, 2)).astype(np.int32)
    edges[-20:] = n  # trash-padded slots
    mass = rng.integers(1, 400, n).astype(np.float32)
    return edges, mass


@pytest.mark.parametrize("seed", SEEDS)
def test_key_is_the_reference_key(seed):
    want = tuple(int(w) for w in jax.random.key_data(jax.random.PRNGKey(seed)))
    assert prng.key(seed) == want


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_bitwise(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32))
    got = prng.random_bits(prng.key(seed), shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("bounds", [(-1000.0, 1000.0), (0.0, 1.0)], ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bitwise(seed, shape, dtype, bounds):
    jdt, tdt, view = DTYPES[dtype]
    want = jax.random.uniform(jax.random.PRNGKey(seed), shape, jdt, *bounds)
    got = prng.uniform(prng.key(seed), shape, *bounds, dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_bits(got, view), _bits(want, view))


@pytest.mark.parametrize("bounds", [(1e-30, 1.5), (-1e-30, 1.5), (-0.3, 0.7), (3.0, 3.5)],
                         ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_uniform_bitwise_where_rounding_is_close(dtype, bounds):
    """Bounds that round in the narrow type, and sums not exact in float64
    whose float64 rounding lands on a float32 tie (f·1.5 ± 1e-30: a float64
    sum rounded again to float32 differs from the reference in 8 % of the
    values; round-to-odd keeps it one rounding)."""
    jdt, tdt, view = DTYPES[dtype]
    want = jax.random.uniform(jax.random.PRNGKey(7), (1000, 2), jdt, *bounds)
    got = prng.uniform(prng.key(7), (1000, 2), *bounds, dtype=tdt)
    np.testing.assert_array_equal(_bits(got, view), _bits(want, view))


def test_uniform_rejects_other_types():
    with pytest.raises(ValueError, match="dtype"):
        prng.uniform(prng.key(0), (3,), dtype=torch.float64)
    with pytest.raises(ValueError, match="width"):
        prng.random_bits(prng.key(0), (3,), width=64)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 300])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_bitwise(seed, n):
    want = np.asarray(jax.random.key_data(jax.random.split(jax.random.PRNGKey(seed), n)))
    got = prng.split(prng.key(seed), n)
    assert [tuple(int(w) for w in row) for row in want] == got


def test_split_of_key_zero():
    assert prng.split(prng.key(0), 3) == [(1797259609, 2579123966), (928981903, 3453687069),
                                          (4146024105, 2718843009)]


@pytest.mark.parametrize("shape", NORMAL_SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_bitwise(seed, shape):
    want = jax.random.normal(jax.random.PRNGKey(seed), shape)
    got = prng.normal(prng.key(seed), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_bits(got, np.uint32), _bits(want, np.uint32))


def test_normal_of_a_subkey_bitwise():
    """The draws ``init_params`` makes: a subkey of ``split``, not a seed's
    key."""
    k = jax.random.split(jax.random.PRNGKey(3), 4)[2]
    want = jax.random.normal(k, (64, 129))
    got = prng.normal(prng.split(prng.key(3), 4)[2], (64, 129))
    np.testing.assert_array_equal(_bits(got, np.uint32), _bits(want, np.uint32))


def _log1p_cases():
    """float32 values: both sides of the small-|x| threshold and of the
    mantissa split at √½, ±0, the ends of the domain, subnormals, and a
    sample of every bit pattern in [-1, 1]."""
    th = np.float32(prng._LOG1P_SMALL)
    near = [np.nextafter(th, np.float32(0)), th, np.nextafter(th, np.float32(1))]
    sqrt_half = np.float32(prng._SQRT_HALF)
    edges = near + [-v for v in near] + [
        sqrt_half - 1, np.nextafter(sqrt_half, np.float32(0)) - 1, 0.0, -0.0, -1.0, 1.0,
        np.nextafter(np.float32(-1), np.float32(0)), 1e-40, -1e-40, 1e-38, -1e-38, 2.0 ** -126,
        -(2.0 ** -126), 1e-20, -1e-20, np.inf, -2.0, np.nan]
    bits = np.random.default_rng(0).integers(0, 0x3F800001, 1 << 18).astype(np.uint32)
    sample = bits.view(np.float32) * np.where(np.arange(bits.size) % 2, -1, 1).astype(np.float32)
    return np.concatenate([np.asarray(edges, np.float32), sample])


def test_log1p_bitwise():
    x = _log1p_cases()
    want = np.asarray(jax.jit(jnp.log1p)(x))
    got = prng.log1p(torch.from_numpy(x).double()).float().numpy()
    small = np.abs(x) < np.float32(prng._LOG1P_SMALL)
    assert small.sum() > 1000 and (~small & np.isfinite(want)).sum() > 1000
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))


def test_chunked_normal_equals_the_whole_draw(monkeypatch):
    whole = prng.normal(prng.key(5), (1000, 3))
    bits = prng.random_bits(prng.key(5), (3000,))
    np.testing.assert_array_equal(prng.random_bits(prng.key(5), (7, 100), start=1234).numpy(),
                                  bits[1234:1934].reshape(7, 100).numpy())
    np.testing.assert_array_equal(
        _bits(prng.uniform(prng.key(5), (500,), -2.0, 3.0, start=2000), np.uint32),
        _bits(prng.uniform(prng.key(5), (3000,), -2.0, 3.0)[2000:2500], np.uint32))
    monkeypatch.setattr(prng, "CHUNK", 701)
    chunked = prng.normal(prng.key(5), (1000, 3))
    np.testing.assert_array_equal(_bits(chunked, np.uint32), _bits(whole, np.uint32))


def test_normal_rejects_other_types():
    with pytest.raises(ValueError, match="float32"):
        prng.normal(prng.key(0), (3,), dtype=torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("n", [150, 3000])
def test_random_init_bitwise(n, seed, dtype):
    """The default init, through both packages' dispatch and the reference's
    compiled instance that ``layout`` starts from."""
    edges, mass = _graph(n, 4 * n, seed)
    jcfg = jfa2.FA2Config(seed=seed, dtype=dtype)
    _, tdt, view = DTYPES[dtype]
    got = fa2.initial_positions(torch.as_tensor(edges), torch.as_tensor(mass), n,
                                config_from_reference(jcfg))
    assert got.dtype == tdt and tuple(got.shape) == (n, 2)
    for want in (jfa2.initial_positions(jnp.asarray(edges), jnp.asarray(mass), n, jcfg),
                 jfa2._initial_positions_jit(jnp.asarray(edges), jnp.asarray(mass), n,
                                             jcfg)):
        np.testing.assert_array_equal(_bits(got, view), _bits(want, view))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,e,seed", [(150, 600, 0), (701, 2000, 1), (5000, 3000, 4),
                                      (1000, 20000, 5)])
def test_bfs_init_against_the_reference(n, e, seed, dtype):
    edges, mass = _graph(n, e, seed)
    jcfg = jfa2.FA2Config(init="bfs", seed=seed, dtype=dtype)
    want = jfa2._initial_positions_jit(jnp.asarray(edges), jnp.asarray(mass), n, jcfg)
    got = fa2.initial_positions(torch.as_tensor(edges), torch.as_tensor(mass), n,
                                config_from_reference(jcfg))
    _, tdt, view = DTYPES[dtype]
    assert got.dtype == tdt and tuple(got.shape) == (n, 2)
    if dtype == "bfloat16":
        want = np.asarray(want.astype(jnp.float32))
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)  # bfloat16's
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=ulp)
        return
    want = np.asarray(want)
    ulp = np.spacing(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BFS_ULP * ulp)
    # The jitter is the reference's draw: the radii before the azimuth and
    # the smoothing are bitwise.
    jitter = jax.random.uniform(jax.random.PRNGKey(seed), (n,), jnp.float32)
    np.testing.assert_array_equal(
        prng.uniform(prng.key(seed), (n,)).numpy(), np.asarray(jitter))


def test_layout_from_the_default_init_matches():
    """``layout`` with no ``pos0`` starts from the reference's start: the
    positions after a few iterations agree as from a shared ``pos0``
    (test_torch_fa2.py)."""
    n = 150
    edges, mass = _graph(n, 600, 2)
    w = np.ones(len(edges), np.float32)
    jcfg = jfa2.FA2Config(iterations=3, seed=5)
    want, _, _ = jfa2.layout(jnp.asarray(edges), jnp.asarray(w), jnp.asarray(mass), n, jcfg)
    got, _, _ = fa2.layout(edges, w, mass, n, config_from_reference(jcfg), device="cpu")
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
