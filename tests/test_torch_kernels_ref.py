"""Plain PyTorch versions of the port's CUDA kernels K1–K4, K7 and K8
against the reference package: its plain version and its Pallas kernel in
interpret mode, on the CPU. Inputs are made with numpy from a seed and
handed to both. (K5 and K6, the grid fields, are in test_torch_grid.py.)

K1 (merge scatter), K3 (count scatter) and K4 (disk coverage) are integer
or exactly-placed results and must match bitwise. K2 (n-body repulsion)
sums in another order than the reference, so it is held to
``|f − f_ref| ≤ 1e-5·|f_ref| + 1e-5·max|f_ref|``: float32 rounding of
sums over at most 1024 terms, with the reference's own Pallas/dense
disagreement (tests/test_kernels.py) about ten times larger.

K7 (segment sum) adds each row into its segment in row order, as the
reference's scatter does on the CPU: bitwise against its plain version.
Against the Pallas kernel, whose one-hot product sums in another order,
``|Δ| ≤ 1e-5·Σ|data|`` per segment (float32 rounding of sums of ≤ 2,048
rows), and bf16 data within 2e-2 relative (one bf16 rounding of the sum).
K8 (CMS update) on integer-valued weights is exact in any order, so
bitwise; on float weights within 1e-5·Σ|w| per bucket. ``core.cms.update``
and the keys-in wrapper ``kernels.cms.ops.update`` (on CPU tensors, the
plain versions of the kernel that hashes the keys itself) are held bitwise
against the reference's ``core.cms.update``.

K3's small-disk entry (``count_disks_into``) is held bitwise against the
reference's ``render.raster._small_disk_splat`` on adversarial disks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.merge.ref import merge_combine_ref as jax_merge_ref  # noqa: E402
from repro.kernels.merge.sorted_merge import merge_combine_pallas  # noqa: E402
from repro.kernels.raster.ref import count_scatter_ref as jax_count_ref  # noqa: E402
from repro.kernels.raster.ref import disk_accum_ref as jax_disk_ref  # noqa: E402
from repro.kernels.raster.splat import (  # noqa: E402
    count_scatter_pallas,
    disk_accum_pallas,
)
from repro.core import cms as jax_cms  # noqa: E402
from repro.render import raster as jax_raster  # noqa: E402
from repro.kernels.cms import ops as jax_cms_ops  # noqa: E402
from repro.kernels.cms.cms_update import cms_update_pallas  # noqa: E402
from repro.kernels.cms.ref import cms_update_ref as jax_cms_ref  # noqa: E402
from repro.kernels.repulsion.nbody import repulsion_pallas  # noqa: E402
from repro.kernels.repulsion.ref import repulsion_ref as jax_rep_ref  # noqa: E402
from repro.kernels.segment.ref import segment_sum_ref as jax_seg_ref  # noqa: E402
from repro.kernels.segment.seg_matmul import segment_sum_pallas  # noqa: E402

from repro_torch.convert import config_from_reference  # noqa: E402
from repro_torch.core import cms as cms_lib  # noqa: E402
from repro_torch.kernels.cms import ops as cms_ops  # noqa: E402
from repro_torch.kernels.cms.ref import cms_update_ref  # noqa: E402

from repro_torch.kernels.merge import ops as merge_ops  # noqa: E402
from repro_torch.kernels.merge.ref import (  # noqa: E402
    SENTINEL,
    merge_combine_ref,
    merge_positions,
    pack_keys,
    scatter_combine_ref,
)
from repro_torch.kernels.raster import ops as raster_ops  # noqa: E402
from repro_torch.kernels.raster.ref import (  # noqa: E402
    BBOX,
    count_disks_into_ref,
    count_scatter_into_ref,
    disk_accum_into_ref,
    disk_accum_ref,
)
from repro_torch.kernels.repulsion import ops as rep_ops  # noqa: E402
from repro_torch.kernels.repulsion.ref import (  # noqa: E402
    repulsion_chunked,
    repulsion_ref,
)
from repro_torch.kernels.segment import ops as seg_ops  # noqa: E402
from repro_torch.kernels.segment.ref import segment_sum_ref  # noqa: E402

INT32_MAX = np.iinfo(np.int32).max


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(
        np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), err_msg=msg,
    )


# ------------------------------------------------------------ K1: merge
def _sorted_run(pairs: dict, size: int, s_cap: int):
    items = sorted(pairs.items())
    a = np.full(size, s_cap, np.int32)
    b = np.full(size, s_cap, np.int32)
    w = np.zeros(size, np.float32)
    for i, ((x, y), ww) in enumerate(items):
        a[i], b[i], w[i] = x, y, ww
    return a, b, w


def _rand_pairs(rng, k: int, s_cap: int, max_w: int = 5) -> dict:
    pairs = {}
    while len(pairs) < k:
        x, y = sorted(rng.choice(s_cap, size=2, replace=False))
        pairs[(int(x), int(y))] = float(rng.integers(1, max_w + 1))
    return pairs


def _merge_case(case):
    rng = np.random.default_rng(7)
    s_cap, cap, c = 16, 32, 16
    state = _rand_pairs(rng, 12, s_cap)
    if case == "random":
        s_cap, cap, c = 32, 100, 24
        state, chunk = _rand_pairs(rng, 77, s_cap), _rand_pairs(rng, 20, s_cap)
    elif case == "empty_chunk":
        chunk = {}
    elif case == "all_duplicate":
        chunk = {p: 1.0 for p in list(state)[:c]}
    elif case == "all_padding_state_too":
        state, chunk = {}, {}
    elif case == "state_at_capacity":
        state = _rand_pairs(rng, cap, s_cap)
        chunk = _rand_pairs(rng, c, s_cap)
    elif case == "chunk_below_state":
        state = {(8, j): 1.0 for j in range(9, 16)}
        chunk = {(0, j): 2.0 for j in range(1, 8)}
    elif case == "chunk_above_state":
        state = {(0, j): 1.0 for j in range(1, 8)}
        chunk = {(8, j): 2.0 for j in range(9, 16)}
    elif case == "neg_zero_weight":  # −0.0 alone, against +0.0, and with a partner
        s_cap, cap, c = 32, 40, 16
        state = _rand_pairs(rng, 20, s_cap)
        chunk = {p: 2.0 for p in list(state)[:6]}
        chunk.update(_rand_pairs(rng, 8, s_cap))
        for i, p in enumerate(sorted(state)):
            if i % 2 == 0:
                state[p] = -0.0
        for i, p in enumerate(sorted(chunk)):
            if i % 3 == 0:
                chunk[p] = -0.0
    elif case == "cap_1":  # one slot: the smallest pair of the union
        s_cap, cap, c = 16, 1, 8
        state = {(3, 9): 2.0}
        chunk = {(3, 9): 1.0, (0, 5): 4.0, (7, 8): 1.0}
    else:  # s_cap at the packing limit: keys brush the sentinel
        s_cap, cap, c = 1 << 16, 16, 8
        top = s_cap - 1
        state = {(0, 1): 1.0, (top - 1, top): 2.0}
        chunk = {(0, 1): 1.0, (top - 2, top): 3.0, (top - 1, top): 1.0}
    return _sorted_run(state, cap, s_cap) + _sorted_run(chunk, c, s_cap) + (s_cap,)


MERGE_CASES = [
    "random", "empty_chunk", "all_duplicate", "all_padding_state_too",
    "state_at_capacity", "chunk_below_state", "chunk_above_state",
    "s_cap_packing_limit", "neg_zero_weight", "cap_1",
]


def _bits(x):
    """Array whose equality is bitwise (−0.0 differs from +0.0)."""
    x = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("case", MERGE_CASES)
def test_merge_plain_matches_reference_ref_and_pallas(case):
    """The plain version and the wrapper on CPU tensors (``merge_place``'s
    plain path) against the reference's plain version and its Pallas
    kernel in interpret mode, bitwise."""
    sa, sb, sw, ca, cb, cw, s_cap = _merge_case(case)
    args = [jnp.asarray(x) for x in (sa, sb, sw, ca, cb, cw)]
    want = jax_merge_ref(*args, s_cap)
    pallas = merge_combine_pallas(*args, s_cap, tn=32, blk=32, interpret=True)
    targs = [_t(x) for x in (sa, sb, sw, ca, cb, cw)]
    for got in (merge_combine_ref(*targs, s_cap), merge_ops.merge_combine(*targs, s_cap)):
        for g, w_, p in zip(got, want, pallas):
            _eq(_bits(g), _bits(w_), case)
            _eq(_bits(g), _bits(p), case)
    if case == "neg_zero_weight":
        ow = merge_ops.merge_combine(*targs, s_cap)[2].numpy()
        assert (ow == 0).any() and not np.signbit(ow).any()


@pytest.mark.parametrize("case", MERGE_CASES)
def test_merge_positions_meet_the_placement_precondition(case):
    """What kernel K1's merge_place relies on: in each run ranks are
    nondecreasing, strictly increasing below cap (so each slot is hit by at
    most one row of each run), and ranks ≥ cap only in the tail; the ranks
    below cap fill the slots 0 .. min(union, cap) − 1."""
    sa, sb, sw, ca, cb, cw, s_cap = _merge_case(case)
    cap = sa.shape[0]
    sk, ck = pack_keys(_t(sa), _t(sb), s_cap), pack_keys(_t(ca), _t(cb), s_cap)
    pos_s, pos_c, new_c = (x.numpy() for x in merge_positions(sk, ck))
    for pos in (pos_s, pos_c):
        assert (np.diff(pos.astype(np.int64)) >= 0).all()
        kept = pos[pos < cap]
        assert (np.diff(kept) > 0).all() and (pos[: len(kept)] < cap).all()
    union = int((sk.numpy() != SENTINEL).sum() + new_c.sum())
    hit = np.union1d(pos_s[pos_s < cap], pos_c[pos_c < cap])
    np.testing.assert_array_equal(hit, np.arange(min(union, cap)))


def test_merge_scatter_plain_drops_out_of_range_rows():
    """K1's plain version on unsorted rows with negative and overflowing
    positions: keys by max, weights by +, unhit slots (-1, -1, 0)."""
    rng = np.random.default_rng(5)
    n, cap = 400, 64
    pos = rng.integers(-8, cap + 8, n).astype(np.int32)
    pos[::5] = INT32_MAX
    a =rng.integers(0, 50, n).astype(np.int32)
    b = rng.integers(0, 50, n).astype(np.int32)
    w = rng.integers(1, 5, n).astype(np.float32)
    oa, ob, ow = scatter_combine_ref(_t(pos), _t(a), _t(b), _t(w), cap)
    ea = np.full(cap, -1, np.int32)
    eb = np.full(cap, -1, np.int32)
    ew = np.zeros(cap, np.float32)
    for p, x, y, z in zip(pos, a, b, w):
        if 0 <= p < cap:
            ea[p], eb[p] = max(ea[p], x), max(eb[p], y)
            ew[p] += z
    _eq(oa, ea)
    _eq(ob, eb)
    _eq(ow, ew)


def test_merge_rejects_oversized_s_cap():
    z = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="s_cap"):
        merge_combine_ref(z, z, z.float(), z, z, z.float(), (1 << 16) + 1)


# -------------------------------------------------------- K2: repulsion
def _assert_forces_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("n,tile", [(128, 128), (300, 128), (1024, 512)])
@pytest.mark.parametrize("use_radii", [True, False])
def test_repulsion_plain_matches_reference(n, tile, use_radii):
    rng = np.random.default_rng(n + use_radii)
    pos = rng.uniform(-100, 100, (n, 2)).astype(np.float32)
    mass = rng.uniform(0.5, 4.0, n).astype(np.float32)
    radii = rng.uniform(0.0, 2.0, n).astype(np.float32)
    r = radii if use_radii else None
    want = jax_rep_ref(jnp.asarray(pos), jnp.asarray(mass), 80.0,
                       radii=jnp.asarray(r) if use_radii else None)
    tr = _t(r) if use_radii else None
    dense = repulsion_ref(_t(pos), _t(mass), 80.0, radii=tr)
    chunked = repulsion_chunked(_t(pos), _t(mass), 80.0, radii=tr, chunk=96)
    _assert_forces_close(dense, want)
    _assert_forces_close(chunked, want)
    _assert_forces_close(rep_ops.repulsion(_t(pos), _t(mass), 80.0, radii=tr), want)
    if n % tile == 0:
        pallas = repulsion_pallas(
            jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(radii), kr=80.0,
            ti=tile, tj=tile, use_radii=use_radii, interpret=True,
        )
        _assert_forces_close(dense, pallas)


def test_repulsion_padding_neutral_and_cpu_dispatch_above_2048():
    """Mass-0 padding exerts and receives no force; above 2048 nodes the CPU
    wrapper takes the j-chunked plain version, equal to the dense one."""
    rng = np.random.default_rng(4)
    n = 2100
    pos = _t(rng.uniform(-50, 50, (n, 2)).astype(np.float32))
    mass = _t(rng.uniform(0.5, 2.0, n).astype(np.float32))
    mass[n - 52:] = 0.0
    got = rep_ops.repulsion(pos, mass, 80.0)
    _assert_forces_close(got[: n - 52], repulsion_ref(pos[: n - 52], mass[: n - 52], 80.0))
    assert float(got[n - 52:].abs().max()) == 0.0


@pytest.mark.parametrize("n", [1, 255, 256, 257, 16_384, 65_536])
def test_repulsion_source_slices_cover_every_source_once(n):
    """K2's split of the source axis on a 132-SM card: S ≥ 1 slices, in
    order, each a run of whole source tiles, that together hold every
    source index exactly once; enough blocks to fill the card where n
    allows it, and at most MAX_SLICES."""
    s = rep_ops.source_slices(n, 132)
    assert 1 <= s <= rep_ops.MAX_SLICES
    bounds = rep_ops.slice_bounds(n, s)
    assert len(bounds) == s
    hits = np.zeros(n, np.int64)
    prev_end = 0
    for j0, j1 in bounds:
        assert j0 == prev_end and j0 < j1 and j0 % rep_ops.SOURCE_TILE == 0
        hits[j0:j1] += 1
        prev_end = j1
    assert prev_end == n and (hits == 1).all()
    node_blocks = -(-n // rep_ops.NODES_PER_BLOCK)
    tiles = -(-n // rep_ops.SOURCE_TILE)
    assert (node_blocks * s >= 4 * 132 or s == min(rep_ops.MAX_SLICES, tiles))


def _half_layout_entries():
    """K2's and K7's attraction entries, each a call on (pos, mass, radii,
    w) of one layout type: the plain versions and the wrappers on CPU
    tensors. n = 2,100 puts the wrappers on the chunked form."""
    from repro_torch.kernels.repulsion.ref import repulsion_chunked_rows
    from repro_torch.kernels.segment.ref import attraction_sum_ref

    rng = np.random.default_rng(11)
    n, e = 2100, 9000
    src = np.sort(rng.integers(0, n + 1, e)).astype(np.int32)  # n: trash rows
    dst = _t(rng.integers(0, n + 1, e).astype(np.int32))
    lay = seg_ops.segment_layout(_t(src), n, sorted=True)
    return n, {
        "repulsion_ref": lambda p, m, r, w: repulsion_ref(p[:300], m[:300], 80.0, radii=r[:300]),
        "repulsion_ref_no_radii": lambda p, m, r, w: repulsion_ref(p[:300], m[:300], 80.0),
        "repulsion_chunked": lambda p, m, r, w: repulsion_chunked(p, m, 80.0, radii=r,
                                                                  chunk=512),
        "repulsion_chunked_rows": lambda p, m, r, w: repulsion_chunked_rows(
            p, m, 700, 900, 80.0, radii=r, chunk=512),
        "repulsion": lambda p, m, r, w: rep_ops.repulsion(p, m, 80.0, radii=r),
        "repulsion_rows": lambda p, m, r, w: rep_ops.repulsion_rows(p, m, 1050, 1050, 80.0,
                                                                    radii=r),
        "attraction_sum_ref": lambda p, m, r, w: attraction_sum_ref(p, dst, w, lay.offsets),
        "attraction_sum": lambda p, m, r, w: seg_ops.attraction_sum(p, dst, w, lay),
    }


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("entry", ["repulsion_ref", "repulsion_ref_no_radii",
                                   "repulsion_chunked", "repulsion_chunked_rows", "repulsion",
                                   "repulsion_rows", "attraction_sum_ref", "attraction_sum"])
def test_half_layout_plain_is_float32_rounded_once(dtype, entry):
    """A bfloat16 or float16 layout through K2's and K7's attraction plain
    versions: bitwise the float32 computation on the same (half-width)
    values, rounded once to the layout's type, as the kernels compute."""
    n, entries = _half_layout_entries()
    fn = entries[entry]
    rng = np.random.default_rng(12)
    t = getattr(torch, dtype)
    # Spread and radii that keep float16's forces finite (below 65,504).
    pos = _t(rng.uniform(-2000, 2000, (n, 2)).astype(np.float32)).to(t)
    mass = _t(rng.uniform(0.5, 2.0, n).astype(np.float32)).to(t)
    radii = _t(rng.uniform(0.0, 0.5, n).astype(np.float32)).to(t)
    w = _t(rng.uniform(0.05, 0.5, 9000).astype(np.float32)).to(t)
    got = fn(pos, mass, radii, w)
    assert got.dtype == t
    want = fn(pos.float(), mass.float(), radii.float(), w.float()).to(t)
    assert torch.isfinite(got).all()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


# ----------------------------------------------------- K3: count scatter
def _count_case(case):
    rng = np.random.default_rng(3)
    if case == "random":
        n, size = 777, 1000
        pos = rng.integers(0, size, n).astype(np.int32)
        pos[::7] = INT32_MAX
        pos[::11] = size + 3
    else:
        n, size = 640, 256
        if case == "one_pixel":
            pos = np.full(n, 77, np.int32)
        elif case == "all_padding":
            pos = np.full(n, INT32_MAX, np.int32)
        else:  # negatives must drop, not wrap
            pos = rng.integers(-5, size, n).astype(np.int32)
    inc = rng.integers(1, 6, n).astype(np.int32)
    return pos, inc, size


@pytest.mark.parametrize("case", ["random", "one_pixel", "all_padding", "negatives"])
def test_count_scatter_plain_matches_reference(case):
    pos, inc, size = _count_case(case)
    want = jax_count_ref(jnp.asarray(pos), jnp.asarray(inc), size)
    pallas = count_scatter_pallas(
        jnp.asarray(pos), jnp.asarray(inc), size, tn=64, blk=128, interpret=True
    )
    got = raster_ops.count_scatter(_t(pos), _t(inc), size)
    _eq(got, want, case)
    _eq(got, pallas, case)
    # Accumulating form with unit increments == reference with ones.
    base = np.random.default_rng(9).integers(0, 3, size).astype(np.int32)
    acc = _t(base.copy())
    count_scatter_into_ref(acc, _t(pos), None)
    want1 = base + np.asarray(
        jax_count_ref(jnp.asarray(pos), jnp.ones(len(pos), jnp.int32), size)
    )
    _eq(acc, want1, case)


# ---------------------------------------------- K3: the small-disk entry
def _small_disk_case(case):
    """Disks of radius ≤ 8 px (the node pass's small disks) and worse."""
    rng = np.random.default_rng(31)
    hs, ws, g = 40, 56, 11
    if case == "random":
        # The reference's compiler contracts dy² + dx² into a fused
        # multiply-add for some elements (one pixel differed over 400,000
        # random disks off the grid). On a 1/64 grid every value is exact,
        # so the pixels are the reference's whichever way it rounds.
        m = 400
        px = np.round(rng.uniform(-12, ws + 12, m) * 64) / 64
        py = np.round(rng.uniform(-12, hs + 12, m) * 64) / 64
        r = np.round(rng.uniform(-1, 8, m) * 64) / 64
        grp = rng.integers(-2, g + 2, m)
    elif case == "specials":
        # NaN centres, far centres (1e30, ±2^30 and just inside), r = 0,
        # r = 8 exactly, integer and half-pixel centres, disks across every
        # image edge, groups out of range.
        px = [np.nan, 5.0, 1e30, -1e30, 2.0**30, -(2.0**30), 2.0**30 - 64, 20.0,
              20.0, 20.5, 0.0, ws - 0.5, 30.0, 30.0, 7.25, 7.25, 30.5, 12.0]
        py = [5.0, np.nan, 10.0, 10.0, 10.0, 10.0, 10.0, 20.0, 20.0, 20.5, 0.0,
              hs - 0.5, -3.0, hs + 2.0, 9.75, 9.75, 20.0, 20.0]
        r = [3.0, 3.0, 5.0, 5.0, 5.0, 5.0, 5.0, 0.0, 8.0, 8.0, 8.0, 8.0, 6.0,
             6.0, 4.5, 4.5, -1.0, np.nan]
        grp = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 8, 9, 10, -1, g, 3, 4]
        m = len(px)
    elif case == "odd_image":  # 1023 × 769, integer centres
        hs, ws, m = 769, 1023, 300
        px = rng.integers(-8, ws + 8, m).astype(np.float64)
        py = rng.integers(-8, hs + 8, m).astype(np.float64)
        r = rng.integers(1, 9, m).astype(np.float64)
        grp = rng.integers(0, g, m)
    else:  # no disk
        m, px, py, r, grp = 0, [], [], [], []
    f32 = [np.asarray(x, np.float32).reshape(m) for x in (px, py, r)]
    return (*f32, np.asarray(grp, np.int32).reshape(m), g, hs, ws)


@pytest.mark.parametrize("case", ["random", "specials", "odd_image", "empty"])
def test_count_disks_plain_matches_reference_small_disk_splat(case):
    px, py, r, grp, g, hs, ws = _small_disk_case(case)
    if len(px):
        want = np.asarray(jax_raster._small_disk_splat(
            *(jnp.asarray(x) for x in (px, py, r, grp)), g, hs, ws, "ref"))
    else:
        want = np.zeros(g * hs * ws, np.int32)
    base = np.random.default_rng(5).integers(0, 4, (g, hs, ws)).astype(np.int32)
    for into in (count_disks_into_ref, raster_ops.count_disks_into):
        acc = _t(base.copy())
        assert into(acc, *(_t(x) for x in (px, py, r, grp)), g) is acc
        _eq(acc.reshape(-1), base.reshape(-1) + want, case)
    if case == "specials":
        # Only the live disks (groups 8–10: r = 8, across the edges) draw.
        counts = want.reshape(g, hs, ws).sum(axis=(1, 2))
        assert not counts[:8].any() and counts[8:].all()
    if case == "random":
        # Hybrid == all-dense: a small disk's box holds every pixel it covers.
        dense = disk_accum_ref(*(_t(x) for x in (px, py, r, grp)), g, hs, ws)
        _eq(dense.reshape(-1), want, case)


def test_small_disk_box_is_the_kernels():
    """csrc/count_scatter.cu compiles the same box as the plain version."""
    from pathlib import Path

    src = (Path(raster_ops.__file__).parents[2] / "csrc" / "count_scatter.cu").read_text()
    assert f"constexpr int BBOX = {BBOX};" in src and BBOX == 18


# ------------------------------------------------------ K4: disk coverage
def _disk_case(case):
    rng = np.random.default_rng(11)
    n, h, w = 96, 24, 40
    g = rng.integers(0, 11, n).astype(np.int32)
    if case == "random":
        n, h, w = 300, 60, 100
        cx = rng.uniform(-10, w + 10, n).astype(np.float32)
        cy = rng.uniform(-10, h + 10, n).astype(np.float32)
        r = rng.uniform(-2, 12, n).astype(np.float32)
        g = rng.integers(-2, 13, n).astype(np.int32)  # dead / out-of-range groups
    elif case == "one_pixel":
        cx = np.full(n, 13.4, np.float32)
        cy = np.full(n, 7.2, np.float32)
        r = rng.uniform(0.5, 0.6, n).astype(np.float32)
    elif case == "zero_extent":
        cx = np.full(n, 20.0, np.float32)
        cy = np.full(n, 12.0, np.float32)
        r = rng.uniform(0.0, 6.0, n).astype(np.float32)
    else:  # all dead
        cx = rng.uniform(0, w, n).astype(np.float32)
        cy = rng.uniform(0, h, n).astype(np.float32)
        r = -rng.uniform(0, 2, n).astype(np.float32)
    return cx, cy, r, g, h, w


@pytest.mark.parametrize("case", ["random", "one_pixel", "zero_extent", "all_dead"])
def test_disk_accum_plain_matches_reference(case):
    cx, cy, r, g, h, w = _disk_case(case)
    jargs = [jnp.asarray(x) for x in (cx, cy, r, g)]
    want = jax_disk_ref(*jargs, 11, h, w)
    pallas = disk_accum_pallas(*jargs, 11, h, w, tp=128, blk=64, interpret=True)
    targs = [_t(x) for x in (cx, cy, r, g)]
    for got in (disk_accum_ref(*targs, 11, h, w), raster_ops.disk_accum(*targs, 11, h, w)):
        _eq(got, want, case)
        _eq(got, pallas, case)


@pytest.mark.parametrize("case", ["random", "one_pixel", "zero_extent", "all_dead"])
def test_disk_accum_into_plain_matches_base_plus_reference(case):
    """The accumulating form (the node pass adds the large disks onto the
    small-disk counts) on a nonzero base: base + the reference's counts."""
    cx, cy, r, g, h, w = _disk_case(case)
    base = np.random.default_rng(17).integers(0, 9, (11, h, w)).astype(np.int32)
    want = base + np.asarray(jax_disk_ref(*[jnp.asarray(x) for x in (cx, cy, r, g)], 11, h, w))
    targs = [_t(x) for x in (cx, cy, r, g)]
    for into in (disk_accum_into_ref, raster_ops.disk_accum_into):
        acc = _t(base.copy())
        assert into(acc, *targs, 11) is acc
        _eq(acc, want, case)


def test_disk_accum_takes_any_group_count():
    """40 color groups (the kernel once kept 16 per-group registers): the
    plain versions and the wrappers on CPU tensors against the reference's
    plain version and its Pallas kernel in interpret mode."""
    rng = np.random.default_rng(40)
    n, h, w, ng = 200, 30, 50, 40
    cx = rng.uniform(-5, w + 5, n).astype(np.float32)
    cy = rng.uniform(-5, h + 5, n).astype(np.float32)
    r = rng.uniform(-1, 14, n).astype(np.float32)
    g = rng.integers(-2, ng + 2, n).astype(np.int32)
    jargs = [jnp.asarray(x) for x in (cx, cy, r, g)]
    want = np.asarray(jax_disk_ref(*jargs, ng, h, w))
    _eq(disk_accum_pallas(*jargs, ng, h, w, tp=128, blk=64, interpret=True), want)
    assert want[32:].any()  # groups past 16 are drawn
    targs = [_t(x) for x in (cx, cy, r, g)]
    _eq(disk_accum_ref(*targs, ng, h, w), want)
    _eq(raster_ops.disk_accum(*targs, ng, h, w), want)
    for into in (disk_accum_into_ref, raster_ops.disk_accum_into):
        _eq(into(torch.zeros((ng, h, w), dtype=torch.int32), *targs, ng), want)


# ------------------------------------------------------- K7: segment sum
def _seg_case(case):
    rng = np.random.default_rng(13)
    e, d, n = 2048, 3, 80
    data = rng.standard_normal((e, d)).astype(np.float32)
    if case == "random":
        seg = rng.integers(0, n, e)
    elif case == "out_of_range_and_negative":
        seg = rng.integers(-6, n + 6, e)
        seg[::9] = np.iinfo(np.int32).min
    elif case == "sorted_with_trash_tail":
        seg = np.sort(rng.integers(0, n, e))
        seg[-40:] = n  # the edge-padding trash id sorts last and drops
    elif case == "one_segment":
        seg = np.full(e, 7)
    elif case == "all_dropped":
        seg = np.full(e, n)
    elif case == "long_segment":  # segment 9 holds 1,500 of the rows
        seg = rng.integers(0, n, e)
        seg[:1500] = 9
        seg = np.sort(seg)
    elif case == "empty_ends":  # segments 0-4 and n-5 .. n-1 empty, gaps between
        seg = np.sort(rng.choice(np.arange(5, n - 5, 3), e))
    else:  # wide rows, few segments
        e, d, n = 500, 64, 5
        data = rng.standard_normal((e, d)).astype(np.float32)
        seg = rng.integers(0, n, e)
    return data, seg.astype(np.int32), n


@pytest.mark.parametrize("case", [
    "random", "out_of_range_and_negative", "sorted_with_trash_tail",
    "one_segment", "all_dropped", "wide_rows", "long_segment", "empty_ends",
])
def test_segment_sum_plain_matches_reference(case):
    data, seg, n = _seg_case(case)
    is_sorted = bool(np.all(np.diff(seg) >= 0))
    want = jax_seg_ref(jnp.asarray(data), jnp.asarray(seg), n,
                       indices_are_sorted=is_sorted)
    for got in (segment_sum_ref(_t(data), _t(seg), n, is_sorted),
                seg_ops.segment_sum(_t(data), _t(seg), n, indices_are_sorted=is_sorted),
                seg_ops.segment_sum(_t(data), _t(seg), n)):
        _eq(got, want, case)
    # The Pallas kernel sums each segment in another order.
    pallas = np.asarray(segment_sum_pallas(jnp.asarray(data), jnp.asarray(seg), n,
                                           tn=128, blk=256, interpret=True))
    keep = (seg >= 0) & (seg < n)
    scale = np.zeros((n, data.shape[1]), np.float64)
    np.add.at(scale, seg[keep], np.abs(data[keep]).astype(np.float64))
    got = segment_sum_ref(_t(data), _t(seg), n).numpy()
    assert np.all(np.abs(got.astype(np.float64) - pallas) <= 1e-5 * scale), case


def test_segment_sum_bf16_accumulates_in_float32():
    rng = np.random.default_rng(21)
    data = rng.standard_normal((1000, 8)).astype(np.float32)
    seg = rng.integers(0, 100, 1000).astype(np.int32)
    jdata = jnp.asarray(data).astype(jnp.bfloat16)
    want = segment_sum_pallas(jdata, jnp.asarray(seg), 100, tn=128, blk=256,
                              interpret=True)
    got = segment_sum_ref(torch.as_tensor(np.array(jdata.astype(jnp.float32)))
                          .to(torch.bfloat16), _t(seg), 100)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=1e-2)


# -------------------------------------------------------- K8: CMS update
@pytest.mark.parametrize("rows,cols,n", [(1, 128, 700), (4, 512, 2000), (4, 5000, 4096)])
def test_cms_update_plain_matches_reference(rows, cols, n):
    rng = np.random.default_rng(rows * cols)
    h = rng.integers(0, cols, (rows, n)).astype(np.int32)
    h[:, ::7] = -1  # padding, in every row, as ops.update produces it
    sketch = rng.integers(0, 50, (rows, cols)).astype(np.float32)
    wi = rng.integers(0, 9, n).astype(np.float32)
    args = [jnp.asarray(x) for x in (sketch, h, wi)]
    want = jax_cms_ref(*args)
    pallas = cms_update_pallas(*args, cols, blk=256, interpret=True)
    for got in (cms_update_ref(_t(sketch), _t(h), _t(wi)),
                cms_ops.update_hashed(_t(sketch), _t(h), _t(wi))):
        _eq(got, want)
        _eq(got, pallas)
    # Float weights: any order, rounded.
    wf = rng.uniform(0, 3, n).astype(np.float32)
    want = np.asarray(jax_cms_ref(jnp.asarray(sketch), jnp.asarray(h), jnp.asarray(wf)))
    got = cms_update_ref(_t(sketch), _t(h), _t(wf)).numpy()
    assert np.all(np.abs(got - want) <= 1e-5 * (sketch + wf.sum()))


@pytest.mark.parametrize("case", ["mixed", "all_padding", "one_key"])
def test_cms_ops_update_matches_reference_ops(case):
    rng = np.random.default_rng(11)
    cfg = jax_cms.CMSConfig(rows=4, cols=256, seed=3)
    keys = rng.integers(0, 100, 500).astype(np.int32)
    if case == "mixed":
        keys[::5] = -1
    elif case == "all_padding":
        keys[:] = -1
    else:
        keys[:] = 42
    w = rng.integers(1, 6, 500).astype(np.float32)
    s0 = jax_cms.init_sketch(cfg)
    want_ref = jax_cms_ops.update(s0, jnp.asarray(keys), jnp.asarray(w), cfg, backend="ref")
    want_pal = jax_cms_ops.update(s0, jnp.asarray(keys), jnp.asarray(w), cfg,
                                  backend="interpret")
    tcfg = config_from_reference(cfg)
    got = cms_ops.update(cms_lib.init_sketch(tcfg), _t(keys), _t(w), tcfg)
    _eq(got, want_ref, case)
    _eq(got, want_pal, case)
    # The pipeline's own update (index_put_) gives the same counts.
    _eq(got, cms_lib.update(cms_lib.init_sketch(tcfg), _t(keys), _t(w), tcfg), case)
    if case == "all_padding":
        assert not got.any()


@pytest.mark.parametrize("case", ["mixed", "repeated", "wide", "empty"])
def test_cms_update_keys_plain_matches_reference_update(case):
    """``core.cms.update`` and the keys-in wrapper, on CPU tensors, against
    the reference's ``core.cms.update``: keys with −1, repeated keys, 256
    and 34,000 columns (the paper's 34 M-edge graph), no key at all."""
    rng = np.random.default_rng(23)
    cols, n = (34_000, 5000) if case == "wide" else (256, 3000)
    if case == "empty":
        n = 0
    cfg = jax_cms.CMSConfig(rows=4, cols=cols, seed=0x5EED)
    keys = rng.integers(0, 700, n).astype(np.int32)
    if case == "repeated":
        keys = rng.choice(np.array([3, 3, 3, 17, 2**31 - 1], np.int32), n)
    keys[::6] = -1
    w = rng.integers(0, 300, n).astype(np.float32)
    s0 = rng.integers(0, 20, (4, cols)).astype(np.float32)
    want = jax_cms.update(jnp.asarray(s0), jnp.asarray(keys), jnp.asarray(w), cfg)
    tcfg = config_from_reference(cfg)
    for fn in (cms_lib.update, cms_ops.update):
        _eq(fn(_t(s0), _t(keys), _t(w), tcfg), want, f"{case} {fn.__module__}")
