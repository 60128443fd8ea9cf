"""The model substrate on the CPU against the reference package: the
cases of ``tests/test_arch_smoke.py`` (reduced configs of each family),
with the reference's parameters carried over (``params_from_reference``)
and the inputs made with numpy.

The port has no training step yet, so where the reference's test takes two
train steps this one holds the forward pass and the loss's value.

``init_params`` from the same key gives the reference's parameters bit
for bit, for every smoke tree (``test_init_params_are_the_reference_s``).

Tolerances (float32 on both sides): the two libraries' matrix products
and reductions sum in different orders, so outputs agree within 2e-4 of
their largest magnitude (measured ≤ 5e-5 on the LM logits) and losses
within 1e-5 relative.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import REGISTRY as JREGISTRY  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.gnn_archs import smoke_gnn as jsmoke_gnn  # noqa: E402
from repro.configs.lm_archs import smoke_lm as jsmoke_lm  # noqa: E402
from repro.configs.sasrec import smoke_sasrec as jsmoke_sasrec  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import sasrec as jsas  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.param import init_params as jinit_params  # noqa: E402

from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.configs.gnn_archs import smoke_gnn  # noqa: E402
from repro_torch.configs.lm_archs import smoke_lm  # noqa: E402
from repro_torch.configs.sasrec import smoke_sasrec  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import gnn as gnn_lib  # noqa: E402
from repro_torch.models import sasrec as sas_lib  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.param import init_params, tree_leaves  # noqa: E402

KEY = jax.random.PRNGKey(0)
TOL = 2e-4  # of the largest magnitude, float32
LOSS_RTOL = 1e-5


def _params(specs_fn, jcfg):
    jp = jinit_params(KEY, specs_fn(jcfg))
    return jp, params_from_reference(jax.tree_util.tree_map(np.asarray, jp))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _lm_case(jcfg, cfg, seed=0):
    jp, tp = _params(jtfm.param_specs, jcfg)
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab, (2, 16)).astype(np.int32),
             "loss_mask": np.ones((2, 16), np.float32)}
    want = jax.jit(jtfm.make_prefill(jcfg))(jp, {"tokens": jnp.asarray(batch["tokens"])})
    got = tfm.make_prefill(cfg)(tp, {"tokens": torch.as_tensor(batch["tokens"])})
    assert got.shape == (2, 16, cfg.vocab_padded)
    _close(got, want)
    jloss = float(jtfm.lm_loss(jcfg, jtfm.Constraints(), jp, _j(batch)))
    tloss = float(tfm.lm_loss(cfg, tp, _t(batch)))
    assert np.isfinite(tloss)
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    return jp, tp


# --------------------------------------------------------------- LM family
@pytest.mark.parametrize("arch", ["yi-6b", "mistral-large-123b"])
def test_smoke_dense_lm(arch):
    assert get_config(arch).model.moe is None
    _lm_case(jsmoke_lm(moe=False), smoke_lm(moe=False))


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "granite-moe-1b-a400m"])
def test_smoke_moe_lm(arch):
    assert get_config(arch).model.moe is not None
    _lm_case(jsmoke_lm(moe=True), smoke_lm(moe=True), seed=1)


def test_smoke_gemma3_sliding():
    """Sliding-window prefill, then the decode step against a KV cache at
    cur_len 3 (the reference's scalar form)."""
    jcfg, cfg = jsmoke_lm(moe=False, sliding=True), smoke_lm(moe=False, sliding=True)
    jp, tp = _lm_case(jcfg, cfg, seed=2)
    tokens = np.random.default_rng(3).integers(1, cfg.vocab, (2, 1)).astype(np.int32)
    jcache = {k: jnp.zeros(v.shape, v.dtype)
              for k, v in jtfm.abstract_kv_cache(jcfg, 2, 32).items()}
    want, jcache = jax.jit(jtfm.make_decode_step(jcfg))(
        jp, jcache, {"tokens": jnp.asarray(tokens), "cur_len": jnp.int32(3)})
    cache = tfm.init_kv_cache(cfg, 2, 32, "cpu")
    got, cache = tfm.make_decode_step(cfg)(
        tp, cache, {"tokens": torch.as_tensor(tokens), "cur_len": torch.tensor(3)})
    assert got.shape == (2, 1, cfg.vocab_padded)
    _close(got, want)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


def test_sliding_window_masks_old_tokens():
    """A local-only arch ignores context beyond the window, as the
    reference does."""
    jcfg = dataclasses.replace(jsmoke_lm(moe=False, sliding=True), global_every=1000,
                               sliding_window=4)
    cfg = dataclasses.replace(smoke_lm(moe=False, sliding=True), global_every=1000,
                              sliding_window=4)
    jp, tp = _params(jtfm.param_specs, jcfg)
    t1 = np.random.default_rng(4).integers(1, cfg.vocab, (1, 16)).astype(np.int32)
    t2 = t1.copy()
    t2[:, 0:4] = (t1[:, 0:4] % (cfg.vocab - 1)) + 1  # perturb far past
    prefill = tfm.make_prefill(cfg)
    l1 = prefill(tp, {"tokens": torch.as_tensor(t1)})
    l2 = prefill(tp, {"tokens": torch.as_tensor(t2)})
    np.testing.assert_allclose(l1[:, -1].numpy(), l2[:, -1].numpy(), rtol=1e-4, atol=1e-4)
    want = jtfm.make_prefill(jcfg)(jp, {"tokens": jnp.asarray(t1)})
    _close(l1, want)


# -------------------------------------------------------------- GNN family
def _gnn_batch(rng, cfg, n, e, task=None, b=0):
    edges = rng.integers(0, n, (e, 2)).astype(np.int32)
    edges[-5:] = n  # trash-padded slots
    batch = {"feats": rng.standard_normal((n, cfg.d_feat)).astype(np.float32),
             "edges": edges, "mask": np.ones(n, np.float32)}
    if task == "node_reg":
        batch["labels"] = rng.standard_normal((n, cfg.n_out)).astype(np.float32)
    elif task == "graph_class":
        batch["graph_ids"] = np.repeat(np.arange(b), n // b).astype(np.int32)
        batch["labels"] = rng.integers(0, cfg.n_out, b).astype(np.int32)
        batch["mask"] = np.ones(b, np.float32)
    else:
        batch["labels"] = rng.integers(0, cfg.n_out, n).astype(np.int32)
    return batch


def _gnn_case(jcfg, cfg, batch):
    jp, tp = _params(jgnn.param_specs, jcfg)
    want = jax.jit(functools.partial(jgnn.forward, jcfg))(jp, _j(batch))
    got = gnn_lib.forward(cfg, tp, _t(batch))
    _close(got, want)
    jloss = float(jax.jit(functools.partial(jgnn.gnn_loss, jcfg))(jp, _j(batch)))
    np.testing.assert_allclose(float(gnn_lib.gnn_loss(cfg, tp, _t(batch))), jloss,
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ["gin-tu", "gat-cora", "meshgraphnet", "graphcast"])
def test_smoke_gnn(arch):
    full = jget_config(arch)
    assert get_config(arch).model.arch == full.model.arch
    jcfg, cfg = jsmoke_gnn(full.model.arch), smoke_gnn(full.model.arch)
    batch = _gnn_batch(np.random.default_rng(1), cfg, 64, 128)
    _gnn_case(jcfg, cfg, batch)


def test_smoke_gnn_regression_and_graph_tasks():
    rng = np.random.default_rng(2)
    n, e, b = 60, 100, 6
    jcfg = dataclasses.replace(jsmoke_gnn("meshgraphnet"), task="node_reg", n_out=3)
    cfg = dataclasses.replace(smoke_gnn("meshgraphnet"), task="node_reg", n_out=3)
    _gnn_case(jcfg, cfg, _gnn_batch(rng, cfg, n, e, "node_reg"))
    jcfg = dataclasses.replace(jsmoke_gnn("gin"), task="graph_class", n_out=2)
    cfg = dataclasses.replace(smoke_gnn("gin"), task="graph_class", n_out=2)
    _gnn_case(jcfg, cfg, _gnn_batch(rng, cfg, n, e, "graph_class", b))


def test_smoke_minibatch_sampler_feeds_model():
    """The port's CSR fanout sampler → padded subgraph → GIN, against the
    reference's sampler and model."""
    from repro.graph import NeighborSampler as JSampler
    from repro.graph import planted_partition as jplanted
    from repro.graph.utils import to_csr as jto_csr

    from repro_torch.graph import NeighborSampler, planted_partition, to_csr

    edges, _ = planted_partition(500, 10, 0.2, 0.01, seed=3)
    assert np.array_equal(edges, jplanted(500, 10, 0.2, 0.01, seed=3)[0])
    indptr, indices = to_csr(edges, 500)
    jindptr, jindices = jto_csr(edges, 500)
    assert np.array_equal(indptr, jindptr) and np.array_equal(indices, jindices)
    sub = NeighborSampler(indptr, indices, fanouts=(5, 3)).sample(
        np.arange(32), np.random.default_rng(0))
    jsub = JSampler(jindptr, jindices, fanouts=(5, 3)).sample(
        np.arange(32), np.random.default_rng(0))
    for f in ("nodes", "edges", "seed_mask"):
        assert np.array_equal(getattr(sub, f), getattr(jsub, f))
    assert (sub.n_nodes, sub.n_edges) == (jsub.n_nodes, jsub.n_edges)
    assert (sub.edges[: sub.n_edges] < sub.n_nodes).all()

    cfg, jcfg = smoke_gnn("gin"), jsmoke_gnn("gin")
    rng = np.random.default_rng(0)
    n_cap = sub.nodes.shape[0]
    batch = {"feats": rng.standard_normal((n_cap, cfg.d_feat)).astype(np.float32),
             "edges": sub.edges,
             "labels": rng.integers(0, cfg.n_out, n_cap).astype(np.int32),
             "mask": sub.seed_mask.astype(np.float32)}
    _gnn_case(jcfg, cfg, batch)


# ------------------------------------------------------------------- recsys
def test_smoke_sasrec():
    jcfg, cfg = jsmoke_sasrec(), smoke_sasrec()
    jp, tp = _params(jsas.param_specs, jcfg)
    rng = np.random.default_rng(4)
    b, s = 8, cfg.seq_len
    batch = {k: rng.integers(1, cfg.n_items, (b, s)).astype(np.int32)
             for k in ("seq", "pos", "neg")}
    batch["seq"][:, :3] = 0  # padding items
    jloss = float(jsas.sasrec_loss(jcfg, jp, _j(batch)))
    np.testing.assert_allclose(float(sas_lib.sasrec_loss(cfg, tp, _t(batch))), jloss,
                               rtol=LOSS_RTOL)

    seq = {"seq": batch["seq"]}
    scores = sas_lib.make_serve_step(cfg)(tp, _t(seq))
    assert scores.shape == (b, cfg.n_items)
    _close(scores, jax.jit(jsas.make_serve_step(jcfg))(jp, _j(seq)))

    cand = rng.integers(1, cfg.n_items, 100).astype(np.int32)
    rb = {"seq": batch["seq"][:1], "candidates": cand}
    sc = sas_lib.make_retrieval_step(cfg)(tp, _t(rb))
    assert sc.shape == (100,)
    _close(sc, jax.jit(jsas.make_retrieval_step(jcfg))(jp, _j(rb)))
    # retrieval scores equal the serve scores at those candidates
    np.testing.assert_allclose(sc.numpy(), scores[0][torch.as_tensor(cand).long()].numpy(),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------- seeded weights
SMOKE_TREES = ["dense-lm", "moe-lm", "sliding-lm", "dense-lm-bf16", "gin-tu", "gat-cora",
               "graphcast", "meshgraphnet", "sasrec"]


def _smoke_specs(tree, ref):
    """The spec tree of a smoke config: the reference's (``ref``) or the
    port's."""
    if tree.endswith("-lm") or tree == "dense-lm-bf16":
        cfg = (jsmoke_lm if ref else smoke_lm)(moe=tree == "moe-lm", sliding=tree == "sliding-lm")
        if tree == "dense-lm-bf16":
            cfg = dataclasses.replace(cfg, param_dtype=jnp.bfloat16 if ref else torch.bfloat16)
        return (jtfm if ref else tfm).param_specs(cfg)
    if tree == "sasrec":
        return (jsas if ref else sas_lib).param_specs((jsmoke_sasrec if ref else smoke_sasrec)())
    arch = (jget_config if ref else get_config)(tree).model.arch
    return (jgnn if ref else gnn_lib).param_specs((jsmoke_gnn if ref else smoke_gnn)(arch))


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("tree", SMOKE_TREES)
def test_init_params_are_the_reference_s(tree, seed):
    """The same key gives the reference's parameters bit for bit: every leaf
    (zeros and ones included) in the reference's flattening order."""
    want = jax.tree_util.tree_leaves_with_path(jinit_params(jax.random.PRNGKey(seed),
                                                            _smoke_specs(tree, True)))
    got = init_params(prng.key(seed), _smoke_specs(tree, False), device="cpu")
    got_l = tree_leaves(got)
    assert len(got_l) == len(want) > 3
    for g, (path, w) in zip(got_l, want):
        w = np.asarray(w)
        assert g.device.type == "cpu" and tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        if g.dtype == torch.bfloat16:
            g, w = g.view(torch.int16), w.view(np.int16)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))


# --------------------------------------------------------------- registry
def test_registry_covers_assignment():
    from repro.configs.base import input_specs as jinput_specs

    from repro_torch.configs.base import input_specs

    assert set(REGISTRY) == set(JREGISTRY)
    for name in REGISTRY:
        arch, jarch = get_config(name), jget_config(name)
        assert (arch.name, arch.family, arch.profile) == (jarch.name, jarch.family, jarch.profile)
        assert (arch.opt_state_bits, arch.microbatch_train) == \
            (jarch.opt_state_bits, jarch.microbatch_train)
        # names, kinds and padded sizes
        assert {k: dataclasses.asdict(v) for k, v in arch.shapes.items()} == \
            {k: dataclasses.asdict(v) for k, v in jarch.shapes.items()}
        for shape in arch.shapes.values():
            if shape.skip or arch.family == "bgv":
                continue
            specs, jspecs = input_specs(arch, shape), jinput_specs(jarch, shape)
            assert list(specs) == list(jspecs)
            for k, v in specs.items():
                assert v.device.type == "meta"
                assert tuple(v.shape) == tuple(jspecs[k].shape)
                assert str(v.dtype).removeprefix("torch.") == str(jspecs[k].dtype)


def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        elif hasattr(v, "dtype") or isinstance(v, torch.dtype) or "dtype" in f.name:
            v = str(np.dtype(v)) if not isinstance(v, torch.dtype) else \
                str(v).removeprefix("torch.")
        out[f.name] = v
    return out


def test_exact_configs_match_assignment():
    """Every model config equals the reference's, field for field."""
    for name in REGISTRY:
        assert _fields(get_config(name).model) == _fields(jget_config(name).model), name
    assert _fields(smoke_lm(moe=True, sliding=True)) == _fields(jsmoke_lm(moe=True, sliding=True))
    assert _fields(smoke_sasrec()) == _fields(jsmoke_sasrec())
    for a in ("gin", "gat", "meshgraphnet", "graphcast"):
        assert _fields(smoke_gnn(a)) == _fields(jsmoke_gnn(a))
    y = get_config("yi-6b").model
    assert (y.n_layers, y.d_model, y.n_heads, y.n_kv_heads, y.d_ff, y.vocab) == \
        (32, 4096, 32, 4, 11008, 64000)
