"""The training substrate on the CPU against the reference package: AdamW
(float32 and 8-bit states), gradient compression, the train step
(microbatches, watchdog, elastic plan), the gradients of the segment sum
and the row gather, remat, one train step of every smoke model from the
reference's parameters, the training cells of ``build_step``, a
checkpoint written by the reference, and the train launcher.

Tolerances (float32 on both sides): the int8 quantizer and the int8 round
trip are bitwise; AdamW from the same gradients agrees within ``OPT_TOL``
of max|p| (the two libraries round the same arithmetic slightly apart).
A whole train step's gradients sum in different orders: the LMs' differ
by ≈ 2e-5 of their max (their attention logits are sharp at the
reference's fan-in, fault R6), the GNNs' and SASRec's by ≈ 2e-7. AdamW
divides each gradient by its own root mean square, so an element whose
gradient is near zero moves by up to lr whatever the gradient's size,
and there a rounding-level difference in the gradient moves the step by a
fraction of lr. So a step's parameters are held within ``STEP_TOL`` of
each tensor's max|p| plus ``LR_TOL`` (``LM_LR_TOL``) × lr; measured worst
6.3e-4 × lr (SASRec) and 0.028 × lr (the dense LM's zero-initialised
norms), with everything else within 2.3e-7 of max|p|.
"""
import dataclasses
import functools
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import all_cells as jall_cells  # noqa: E402
from repro.configs.gnn_archs import smoke_gnn as jsmoke_gnn  # noqa: E402
from repro.configs.lm_archs import smoke_lm as jsmoke_lm  # noqa: E402
from repro.configs.sasrec import smoke_sasrec as jsmoke_sasrec  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import sasrec as jsas  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.param import init_params as jinit_params  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.compression import compress_decompress as jcompress  # noqa: E402
from repro.train.compression import topk_sparsify as jtopk  # noqa: E402
from repro.train import checkpoint as _jckpt  # noqa: E402,F401  (imports before the manager)
from repro.train.fault_tolerance import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.train.train_loop import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.train_loop import make_train_step as jmake_train_step  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.gnn_archs import smoke_gnn  # noqa: E402
from repro_torch.configs.lm_archs import smoke_lm  # noqa: E402
from repro_torch.configs.sasrec import smoke_sasrec  # noqa: E402
from repro_torch.convert import opt_state_from_reference, params_from_reference  # noqa: E402
from repro_torch.kernels.segment import ops as seg_ops  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.steps import BuiltStep, build_step  # noqa: E402
from repro_torch.models import gnn as gnn_lib  # noqa: E402
from repro_torch.models import sasrec as sas_lib  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.param import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.compression import compress_decompress, topk_sparsify  # noqa: E402
from repro_torch.train.fault_tolerance import CheckpointManager, ElasticPlan  # noqa: E402
from repro_torch.train.train_loop import StepWatchdog, TrainConfig, make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(0)
OPT_TOL = 1e-6  # AdamW from the same gradients, of max|p|
STEP_TOL = 1e-6  # a whole train step, of each tensor's max|p| ...
LR_TOL, LM_LR_TOL = 2e-3, 0.1  # ... plus this many lr (measured 6.3e-4, 0.028)
LOSS_RTOL = 1e-5
# grad_norm, relative: measured 1.3e-5 (LMs), 5.9e-5 (SASRec's full
# config), 2.1e-7 (the rest).
GNORM_RTOL = {"lm": 5e-5, "sasrec-full": 2e-4, "other": 1e-6}
FLIP_FRAC = 1e-6  # of the elements (measured 3.1e-7)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want, tol, atol=0.0):
    """Every leaf of ``got`` (port) within tol · max|want| + atol of ``want``."""
    want_l = jax.tree_util.tree_leaves(_np(want))
    got_l = tree_leaves(got)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        g = g.detach().float().numpy() if g.is_floating_point() else g.numpy()
        w = np.asarray(w, dtype=np.float32) if w.dtype.kind == "f" else w
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol * max(np.abs(w).max(), 1e-30) + atol)


# ------------------------------------------------------- quantizer, compression
def test_q8_and_compress_decompress_are_bitwise():
    rng = np.random.default_rng(0)
    for shape in ((3, 512), (2, 4, 33), (7,)):
        x = (rng.standard_normal(shape) * 10).astype(np.float32)
        x.reshape(-1)[::5] = 0.0
        jq, js = jopt._q8(jnp.asarray(x))
        q, s = opt._q8(torch.as_tensor(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(opt._dq8(q, s, shape).numpy(),
                                      np.asarray(jopt._dq8(jq, js, shape)))
        np.testing.assert_array_equal(compress_decompress(torch.as_tensor(x)).numpy(),
                                      np.asarray(jcompress(jnp.asarray(x))))
    ints = torch.arange(6)
    assert compress_decompress(ints) is ints


def test_q8_rounds_half_to_even():
    # x / scale lands on k + 0.5 exactly: 127 · (k + 0.5) / 127.5 with max 127.5.
    x = np.array([[127.5, 0.5 * 127.5 / 127, 1.5 * 127.5 / 127, 2.5 * 127.5 / 127]],
                 np.float32)
    q, _ = opt._q8(torch.as_tensor(x))
    jq, _ = jopt._q8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_int8_roundtrip_error_bounded(seed):
    """Row-wise int8: |err| ≤ half a quantization step (row_max/127/2)."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((3, 512)) * 10).astype(np.float32)
    err = np.abs(compress_decompress(torch.as_tensor(g)).numpy() - g)
    scale = np.abs(g).max(-1, keepdims=True) / 127.0
    assert (err <= scale * 0.51 + 1e-6).all()


@pytest.mark.parametrize("ties", [False, True])
def test_topk_sparsify_matches_the_reference(ties):
    """Tie-free data: equal. With ties both keep the lower indices."""
    rng = np.random.default_rng(4)
    g = rng.standard_normal(1000).astype(np.float32)
    if ties:
        g = np.round(g * 4) / 4
    err = (rng.standard_normal(1000) * 0.01).astype(np.float32) if not ties else np.zeros_like(g)
    kept, err2 = topk_sparsify(torch.as_tensor(g), torch.as_tensor(err), k_frac=0.1)
    jkept, jerr2 = jtopk(jnp.asarray(g), jnp.asarray(err), k_frac=0.1)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))
    np.testing.assert_array_equal(err2.numpy(), np.asarray(jerr2))


def test_topk_error_feedback_preserves_mass():
    g = torch.as_tensor(np.random.default_rng(5).standard_normal(1000).astype(np.float32))
    kept, err2 = topk_sparsify(g, torch.zeros_like(g), k_frac=0.1)
    np.testing.assert_allclose((kept + err2).numpy(), g.numpy(), rtol=1e-6)
    assert float((kept != 0).float().mean()) <= 0.11


# --------------------------------------------------------------------- AdamW
def _tree_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 512)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "stack": {"k": rng.standard_normal((3, 6, 10)).astype(np.float32)}}


@pytest.mark.parametrize("bits", [32, 8])
def test_opt_state_layout_matches_the_reference(bits):
    cfg, jcfg = opt.AdamWConfig(state_bits=bits), jopt.AdamWConfig(state_bits=bits)
    p = _tree_params()
    jreal = jopt.init_opt_state(jax.tree_util.tree_map(jnp.asarray, p), jcfg)
    want = jax.tree_util.tree_map(lambda x: (tuple(x.shape), str(x.dtype)), jreal)
    real = opt.init_opt_state(tree_map(torch.as_tensor, p), cfg)
    abstract = opt.abstract_opt_state(
        tree_map(lambda x: torch.empty(x.shape, device="meta"), p), cfg)
    for tree in (real, abstract):
        got = tree_map(lambda x: (tuple(x.shape), str(x.dtype).removeprefix("torch.")), tree)
        assert got == want
    _close(real, jreal, 0)  # the same zeros, and s = 1e-12
    axes = {"w": ("embed", "mlp"), "b": ("mlp",), "stack": {"k": ("layer", "embed", "mlp")}}
    assert opt.opt_logical_axes(axes, cfg) == jopt.opt_logical_axes(axes, jcfg)


@pytest.mark.parametrize("bits", [32, 8])
def test_apply_updates_matches_the_reference(bits):
    """Three steps from the same gradients; the port updates in place and
    returns the same tensors."""
    cfg, jcfg = opt.AdamWConfig(state_bits=bits), jopt.AdamWConfig(state_bits=bits)
    p = _tree_params()
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jstate = jopt.init_opt_state(jp, jcfg)
    tp = tree_map(torch.as_tensor, p)
    state = opt.init_opt_state(tp, cfg)
    ids = [id(x) for x in tree_leaves(tp)]
    for step in range(3):
        g = _tree_params(10 + step)
        jp, jstate, jm = jopt.apply_updates(jp, jax.tree_util.tree_map(jnp.asarray, g),
                                            jstate, jcfg)
        tp, state, m = opt.apply_updates(tp, tree_map(torch.as_tensor, g), state, cfg)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        _close(tp, jp, OPT_TOL)
    assert [id(x) for x in tree_leaves(tp)] == ids
    assert int(state["count"]) == int(jstate["count"]) == 3
    _close(state["mv"], jstate["mv"], OPT_TOL)


def quad_loss(params, batch):
    err = params["w"] - batch["target"]
    return torch.sum(err * err)


def _quad_params():
    return {"w": torch.as_tensor(np.random.default_rng(0).standard_normal((8, 512)),
                                 dtype=torch.float32)}


def test_adamw_converges_quadratic():
    params = _quad_params()
    batch = {"target": torch.zeros((8, 512))}
    tcfg = TrainConfig(adamw=opt.AdamWConfig(lr=0.05))
    step = make_train_step(quad_loss, tcfg)
    state = opt.init_opt_state(params, tcfg.adamw)
    for _ in range(200):
        params, state, m = step(params, state, batch)
    assert float(m["loss"]) < 1e-2


def test_adamw_int8_tracks_fp32():
    """8-bit momentum + factored v converges like float32 on a quadratic."""
    batch = {"target": torch.zeros((8, 512))}
    trajs = {}
    for bits in (32, 8):
        params = _quad_params()
        tcfg = TrainConfig(adamw=opt.AdamWConfig(lr=0.05, state_bits=bits))
        step = make_train_step(quad_loss, tcfg)
        state = opt.init_opt_state(params, tcfg.adamw)
        losses = []
        for _ in range(150):
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
        trajs[bits] = losses
    assert trajs[8][-1] < 0.05 * trajs[8][0], trajs[8][-1]
    assert trajs[32][-1] < 0.05 * trajs[32][0]


def test_microbatch_accumulation_matches_full_batch_and_the_reference():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((64, 8)).astype(np.float32)
    batch = {"x": rng.standard_normal((4, 64)).astype(np.float32),
             "y": rng.standard_normal((4, 8)).astype(np.float32)}

    def loss(params, b):
        return torch.mean((b["x"] @ params["w"] - b["y"]) ** 2)

    def jloss(params, b):
        return jnp.mean((b["x"] @ params["w"] - b["y"]) ** 2)

    outs = {}
    for mb in (0, 2):
        tcfg = TrainConfig(adamw=opt.AdamWConfig(lr=0.1), microbatch=mb)
        params = {"w": torch.as_tensor(w.copy())}
        p2, _, m = make_train_step(loss, tcfg)(params, opt.init_opt_state(params, tcfg.adamw),
                                               _t(batch))
        outs[mb] = p2["w"].numpy().copy()
        jtcfg = JTrainConfig(adamw=jopt.AdamWConfig(lr=0.1), microbatch=mb)
        jp = {"w": jnp.asarray(w)}
        jp2, _, jm = jax.jit(jmake_train_step(jloss, jtcfg))(
            jp, jopt.init_opt_state(jp, jtcfg.adamw), _j(batch))
        np.testing.assert_allclose(outs[mb], np.asarray(jp2["w"]), rtol=0, atol=OPT_TOL * 4)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(outs[0], outs[2], rtol=1e-4, atol=1e-5)


def test_compressed_grads_step_matches_the_reference():
    p = _tree_params()
    batch = {"t": np.random.default_rng(8).standard_normal((8, 512)).astype(np.float32)}

    def loss(params, b):
        return torch.sum((params["w"] - b["t"]) ** 2) + torch.sum(params["stack"]["k"] ** 3)

    def jloss(params, b):
        return jnp.sum((params["w"] - b["t"]) ** 2) + jnp.sum(params["stack"]["k"] ** 3)

    tp = tree_map(torch.tensor, p)  # a copy: the step updates it in place
    tcfg = TrainConfig(compress_grads=True)
    tp, _, m = make_train_step(loss, tcfg)(tp, opt.init_opt_state(tp, tcfg.adamw), _t(batch))
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jtcfg = JTrainConfig(compress_grads=True)
    jp, _, jm = jax.jit(jmake_train_step(jloss, jtcfg))(
        jp, jopt.init_opt_state(jp, jtcfg.adamw), _j(batch))
    _close(tp, jp, OPT_TOL)
    assert not any(x.requires_grad for x in tree_leaves(tp))


def test_watchdog_flags_straggler():
    import time

    wd = StepWatchdog(threshold=3.0, warmup=2)
    for _ in range(3):
        wd.start()
        time.sleep(0.01)
        assert not wd.stop()
    wd.start()
    time.sleep(0.08)
    assert wd.stop()


def test_elastic_plan_batch_schedule():
    plan = ElasticPlan(global_batch=256, n_pods=2)
    assert plan.batch_per_pod() == 128
    assert plan.data_shard_for(0, step=3) == (0, 128)
    assert plan.data_shard_for(1, step=3) == (128, 128)
    with pytest.raises(ValueError):
        ElasticPlan(global_batch=255, n_pods=2).batch_per_pod()


# ------------------------------------------------- K7's autograd Functions
def test_segment_sum_edges_gradient_matches_jax():
    """Trash ids (= n) and negatives are dropped: their gradient is 0."""
    rng = np.random.default_rng(1)
    n, e = 9, 40
    data = rng.standard_normal((e, 3)).astype(np.float32)
    seg = rng.integers(0, n, e).astype(np.int32)
    seg[::7] = n
    seg[3] = -2
    w = rng.standard_normal((n, 3)).astype(np.float32)

    def jf(d):
        return jnp.sum(jax.ops.segment_sum(d, jnp.asarray(seg), num_segments=n) * w)

    want = jax.grad(jf)(jnp.asarray(data))
    d = torch.as_tensor(data).requires_grad_(True)
    out = seg_ops.segment_sum_edges(d, torch.as_tensor(seg), n)
    (got,) = torch.autograd.grad(torch.sum(out * torch.as_tensor(w)), d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jax.ops.segment_sum(data, seg, num_segments=n)),
                               rtol=1e-6, atol=1e-6)


def test_gather_rows_gradient_matches_jax():
    """Ids ≥ n read the last row, as the reference's clamped gather does,
    but their gradient is dropped, as in ``jax.grad`` of that gather."""
    rng = np.random.default_rng(2)
    n, e = 7, 50
    x = rng.standard_normal((n, 2, 3)).astype(np.float32)
    idx = rng.integers(0, n, e).astype(np.int64)
    idx[::5] = n
    w = rng.standard_normal((e, 2, 3)).astype(np.float32)

    def jf(xx):
        return jnp.sum(xx[jnp.asarray(idx)] * w)

    want = jax.grad(jf)(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    out = seg_ops.gather_rows(xt, torch.as_tensor(idx))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jnp.asarray(x)[idx]))
    (got,) = torch.autograd.grad(torch.sum(out * torch.as_tensor(w)), xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------- remat
def _grads(loss_fn, params, batch):
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    grads = torch.autograd.grad(loss_fn(params, batch), leaves)
    for p in leaves:
        p.requires_grad_(False)
    return grads


@pytest.mark.parametrize("arch", ["gin", "gat", "meshgraphnet"])
def test_gnn_remat_is_bitwise(arch):
    cfg = smoke_gnn(arch)
    params, batch = _gnn_case(jsmoke_gnn(arch), cfg, 0)[2:]
    off = _grads(functools.partial(gnn_lib.gnn_loss, cfg), params, batch)
    on = _grads(functools.partial(gnn_lib.gnn_loss, dataclasses.replace(cfg, remat=True)),
                params, batch)
    assert all(torch.equal(a, b) for a, b in zip(on, off))


@pytest.mark.parametrize("moe", [False, True])
def test_lm_remat_is_bitwise(moe, monkeypatch):
    """The LM recomputes every layer (as the reference always does); with
    the recompute taken out, the gradients are the same bits."""
    cfg = smoke_lm(moe=moe)
    params, batch = _lm_case(jsmoke_lm(moe=moe), cfg, 0)[2:]
    calls = []

    def counting(fn, *args, **kw):
        calls.append(fn)
        return tfm.checkpoint.__wrapped__(fn, *args, **kw)

    counting.__wrapped__ = tfm.checkpoint
    monkeypatch.setattr(tfm, "checkpoint", counting)
    on = _grads(functools.partial(tfm.lm_loss, cfg), params, batch)
    assert len(calls) == cfg.n_layers
    monkeypatch.setattr(tfm, "checkpoint", lambda fn, *a, use_reentrant, **kw: fn(*a, **kw))
    off = _grads(functools.partial(tfm.lm_loss, cfg), params, batch)
    assert all(torch.equal(a, b) for a, b in zip(on, off))


# -------------------------------------------------- one step of every model
def _lm_case(jcfg, cfg, seed):
    jp = jinit_params(KEY, jtfm.param_specs(jcfg))
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab, (2, 16)).astype(np.int32),
             "loss_mask": np.ones((2, 16), np.float32)}
    return jp, batch, params_from_reference(_np(jp)), _t(batch)


def _gnn_case(jcfg, cfg, seed):
    jp = jinit_params(KEY, jgnn.param_specs(jcfg))
    rng = np.random.default_rng(seed)
    n, e = 40, 96
    edges = rng.integers(0, n, (e, 2)).astype(np.int32)
    edges[-6:] = n  # trash padding
    batch = {"feats": rng.standard_normal((n, cfg.d_feat)).astype(np.float32), "edges": edges}
    if cfg.task == "node_reg":
        batch["labels"] = rng.standard_normal((n, cfg.n_out)).astype(np.float32)
    else:
        batch["labels"] = rng.integers(0, cfg.n_out, n).astype(np.int32)
    batch["mask"] = (rng.random(n) < 0.7).astype(np.float32)
    return jp, batch, params_from_reference(_np(jp)), _t(batch)


def _sas_case(jcfg, cfg, seed):
    jp = jinit_params(KEY, jsas.param_specs(jcfg))
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, cfg.n_items, (4, cfg.seq_len)).astype(np.int32)
    seq[:, :3] = 0  # left padding
    batch = {"seq": seq, "pos": np.roll(seq, -1, 1),
             "neg": rng.integers(1, cfg.n_items, (4, cfg.seq_len)).astype(np.int32)}
    return jp, batch, params_from_reference(_np(jp)), _t(batch)


def _step_close(m, jm, tp, jp, family, lr=1e-3):
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GNORM_RTOL[family if family in GNORM_RTOL else "other"])
    if family == "sasrec-full":
        _close_but_flips(tp, jp, lr)
    else:
        _close(tp, jp, STEP_TOL, (LM_LR_TOL if family == "lm" else LR_TOL) * lr)


def _close_but_flips(got, want, lr):
    """One step at SASRec's full config: every element within the 2·lr
    (plus decay) an AdamW step can move it by, and all but FLIP_FRAC of
    them within STEP_TOL·max|p| + LR_TOL·lr. Its attention logits are as
    sharp as the LMs' (the reference's fan-in for [L, d, 1, hd] is 1, R6),
    so its gradients differ by ≈ 6e-5 of their norm, and measured 16 of
    52,458,950 elements moved by up to 1.3·lr apart (gradients near zero
    of opposite signs on the two sides)."""
    n_out, n_all = 0, 0
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(_np(want))):
        g, w = g.numpy(), np.asarray(w)
        d = np.abs(g - w)
        assert np.isfinite(g).all() and (d <= 2.02 * lr * (1 + 0.01 * np.abs(w))).all()
        n_out += int((d > STEP_TOL * np.abs(w).max() + LR_TOL * lr).sum())
        n_all += d.size
    assert n_out <= FLIP_FRAC * n_all, (n_out, n_all)


def _one_step(jloss, loss, case, family, bits=32):
    jp, jbatch, tp, tbatch = case
    jtcfg = JTrainConfig(adamw=jopt.AdamWConfig(lr=1e-3, state_bits=bits))
    jp2, _, jm = jax.jit(jmake_train_step(jloss, jtcfg))(
        jp, jopt.init_opt_state(jp, jtcfg.adamw), _j(jbatch))
    tcfg = TrainConfig(adamw=opt.AdamWConfig(lr=1e-3, state_bits=bits))
    tp2, _, m = make_train_step(loss, tcfg)(tp, opt.init_opt_state(tp, tcfg.adamw), tbatch)
    _step_close(m, jm, tp2, jp2, family)


@pytest.mark.parametrize("moe,sliding,bits", [(False, False, 32), (True, False, 32),
                                              (True, False, 8), (False, True, 32)])
def test_lm_train_step_matches_the_reference(moe, sliding, bits):
    jcfg, cfg = jsmoke_lm(moe=moe, sliding=sliding), smoke_lm(moe=moe, sliding=sliding)
    _one_step(functools.partial(jtfm.lm_loss, jcfg, jtfm.Constraints()),
              functools.partial(tfm.lm_loss, cfg), _lm_case(jcfg, cfg, 1), "lm", bits)


@pytest.mark.parametrize("arch", ["gin", "gat", "meshgraphnet", "graphcast"])
def test_gnn_train_step_matches_the_reference(arch):
    jcfg, cfg = jsmoke_gnn(arch), smoke_gnn(arch)
    _one_step(functools.partial(jgnn.gnn_loss, jcfg), functools.partial(gnn_lib.gnn_loss, cfg),
              _gnn_case(jcfg, cfg, 2), "gnn")


def test_gnn_graph_class_train_step_matches_the_reference():
    """The launcher's smoke task: molecules pooled per graph (trash graph
    ids dropped)."""
    from repro.data.pipeline import MoleculeStream

    jcfg = dataclasses.replace(jsmoke_gnn("gin"), task="graph_class", n_out=2)
    cfg = dataclasses.replace(smoke_gnn("gin"), task="graph_class", n_out=2)
    b = MoleculeStream(batch=4, n_nodes=12, n_edges=24, d_feat=cfg.d_feat).batch_at(0)
    jp = jinit_params(KEY, jgnn.param_specs(jcfg))
    case = (jp, b, params_from_reference(_np(jp)), _t(b))
    _one_step(functools.partial(jgnn.gnn_loss, jcfg), functools.partial(gnn_lib.gnn_loss, cfg),
              case, "gnn", bits=8)


def test_sasrec_train_step_matches_the_reference():
    jcfg, cfg = jsmoke_sasrec(), smoke_sasrec()
    _one_step(functools.partial(jsas.sasrec_loss, jcfg), functools.partial(sas_lib.sasrec_loss, cfg),
              _sas_case(jcfg, cfg, 3), "sasrec")


# ------------------------------------------------------------ training cells
def _train_cells():
    return [(a.name, s.name) for a, s in jall_cells(include_bgv=False)
            if not s.skip and s.kind in ("train", "graph_train")]


@pytest.mark.parametrize("name,cell", _train_cells())
def test_train_cells_build_as_the_reference(name, cell):
    """Every training cell builds: the reference's roofline metadata, and
    abstract parameters, optimizer state and batch of its shapes and
    dtypes."""
    from repro.configs import get_config as jget_config

    jarch, arch = jget_config(name), get_config(name)
    jbuilt = jsteps.build_step(jarch, jarch.shapes[cell], jax.make_mesh((1, 1), ("data", "model")))
    built = build_step(arch, arch.shapes[cell])
    assert isinstance(built, BuiltStep)
    assert built.meta == jbuilt.meta
    want = jax.tree_util.tree_map(lambda x: (tuple(x.shape), str(x.dtype)), jbuilt.abstract_args)
    got = tuple(tree_map(lambda x: (tuple(x.shape), str(x.dtype).removeprefix("torch.")), a)
                for a in built.abstract_args)
    assert got == want
    assert all(x.device.type == "meta" for a in built.abstract_args for x in tree_leaves(a))


def test_built_gnn_and_sasrec_steps_run_as_the_reference():
    """The built training steps of gin-tu/molecule (the cell's shapes) and
    SASRec's train_batch (batch cut to 8) on the CPU, against the
    reference's unsharded make_train_step (fault R3 breaks its meshed
    step), from the reference's parameters."""
    from repro.configs import get_config as jget_config
    from repro.data.pipeline import MoleculeStream, SASRecStream

    arch, jarch = get_config("gin-tu"), jget_config("gin-tu")
    shape = arch.shapes["molecule"]
    b = MoleculeStream(shape.n_graphs, 30, 64, shape.d_feat, shape.n_out, seed=0).batch_at(0)
    n, e = shape.n_nodes, shape.n_edges
    feats = np.zeros((n, shape.d_feat), np.float32)
    feats[: len(b["feats"])] = b["feats"]
    gids = np.full(n, shape.n_graphs, np.int32)
    gids[: len(b["graph_ids"])] = b["graph_ids"]
    edges = np.full((e, 2), n, np.int32)
    edges[: len(b["edges"])] = b["edges"]
    batch = {"feats": feats, "edges": edges, "graph_ids": gids, "labels": b["labels"],
             "mask": b["mask"]}
    jcfg = jarch.model_for(jarch.shapes["molecule"])
    jp = jinit_params(KEY, jgnn.param_specs(jcfg))
    built = build_step(arch, shape)
    cases = [(built, jp, batch, functools.partial(jgnn.gnn_loss, jcfg), "gnn")]
    sas, jsas_arch = get_config("sasrec"), jget_config("sasrec")
    sb = SASRecStream(sas.model.n_items, 8, sas.model.seq_len, seed=0).batch_at(0)
    jp_s = jinit_params(KEY, jsas.param_specs(jsas_arch.model))
    cases.append((build_step(sas, sas.shapes["train_batch"]), jp_s, sb,
                  functools.partial(jsas.sasrec_loss, jsas_arch.model), "sasrec-full"))
    for built, jp, batch, jloss, family in cases:
        tp = params_from_reference(_np(jp))
        tp2, state, m = built.fn(tp, opt.init_opt_state(tp, opt.AdamWConfig()), _t(batch))
        jp2, jstate, jm = jax.jit(jmake_train_step(jloss, JTrainConfig()))(
            jp, jopt.init_opt_state(jp, jopt.AdamWConfig()), _j(batch))
        _step_close(m, jm, tp2, jp2, family)


# --------------------------------------------------- checkpoints, launcher
def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """(params, opt_state) saved by the reference's CheckpointManager after
    one step restores in the port's, bitwise, and the port's next step
    matches the reference's next step (both state layouts)."""
    for bits in (32, 8):
        jcfg, cfg = jsmoke_lm(moe=True), smoke_lm(moe=True)
        jp, jbatch, _, tbatch = _lm_case(jcfg, cfg, 4)
        jtcfg = JTrainConfig(adamw=jopt.AdamWConfig(lr=1e-3, state_bits=bits))
        jstep = jax.jit(jmake_train_step(functools.partial(jtfm.lm_loss, jcfg,
                                                           jtfm.Constraints()), jtcfg))
        jp, jstate, _ = jstep(jp, jopt.init_opt_state(jp, jtcfg.adamw), _j(jbatch))
        d = str(tmp_path / f"b{bits}")
        JCheckpointManager(d, every_steps=1).save(1, (jp, jstate))
        tcfg = TrainConfig(adamw=opt.AdamWConfig(lr=1e-3, state_bits=bits))
        like_p = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype),
                          tfm.param_specs(cfg))
        like = (like_p, opt.init_opt_state(like_p, tcfg.adamw))
        step, (tp, tstate), _ = CheckpointManager(d).restore_latest(like)
        assert step == 1
        _close(tp, jp, 0)
        _close(tstate, jstate, 0)
        conv = opt_state_from_reference(_np(jstate))
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(conv), tree_leaves(tstate)))
        jp, jstate, jm = jstep(jp, jstate, _j(jbatch))
        tp, tstate, m = make_train_step(functools.partial(tfm.lm_loss, cfg), tcfg)(
            tp, tstate, tbatch)
        _step_close(m, jm, tp, jp, "lm")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


# Fault injection from outside the launcher: ``launch.train.main`` with its
# step function wrapped so that the process SIGKILLs itself right after step
# ``argv[1]`` (counted from a fresh start) and before that step's checkpoint.
KILL_AFTER_STEP = """
import os, signal, sys
import repro_torch.launch.train as launcher
kill_at, make = int(sys.argv[1]), launcher.make_train_step
def make_killed(*args, **kwargs):
    step_fn, calls = make(*args, **kwargs), [0]
    def step(*a):
        out = step_fn(*a)
        if calls[0] == kill_at:
            float(out[2]["loss"])
            print(f"step {kill_at}: killed", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        calls[0] += 1
        return out
    return step
launcher.make_train_step = make_killed
launcher.main(sys.argv[2:])
"""


def _launch(tmp_path, ckpt, kill_at=None):
    entry = (["-m", "repro_torch.launch.train"] if kill_at is None
             else ["-c", KILL_AFTER_STEP, str(kill_at)])
    return subprocess.run(
        [sys.executable, *entry, "--device", "cpu", "--preset",
         "smoke", "--arch", "gin-tu", "--steps", "12", "--ckpt-every", "4",
         "--ckpt-dir", str(tmp_path / ckpt)],
        capture_output=True, text=True, env=_env(), timeout=300)


def test_train_launcher_kill_and_resume_is_bitwise(tmp_path):
    """A run killed (SIGKILL) after step 9 resumes from its step-8
    checkpoint; its final checkpoint equals an uninterrupted run's bit for
    bit."""
    whole = _launch(tmp_path, "whole")
    assert whole.returncode == 0, whole.stderr
    killed = _launch(tmp_path, "killed", kill_at=9)
    assert killed.returncode == -signal.SIGKILL, killed.stderr
    assert "step 9: killed" in killed.stdout
    resumed = _launch(tmp_path, "killed")
    assert resumed.returncode == 0, resumed.stderr
    assert "restored checkpoint @ step 8" in resumed.stdout
    a = np.load(tmp_path / "whole" / "step_00000011.npz")
    b = np.load(tmp_path / "killed" / "step_00000011.npz")
    assert sorted(a.files) == sorted(b.files) and len(a.files) > 10
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-1b-a400m", "sasrec", "gat-cora"])
def test_train_launcher_runs_each_family(tmp_path, capsys, arch):
    out = train_launcher.run(arch, 3, 4, 16, str(tmp_path / "ck"), 2, 3e-3, log_every=1,
                             device="cpu")
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert "done: 3 steps" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "ck"))[-2:] == ["step_00000002.npz",
                                                        "step_00000002.npz.meta.json"]


def _recording(init, record, convert):
    """``init`` that also keeps a copy of what it returns."""
    def init_and_record(*args, **kwargs):
        out = init(*args, **kwargs)
        record.append(convert(out))
        return out
    return init_and_record


@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-1b-a400m", "sasrec", "gat-cora"])
def test_train_launcher_matches_the_reference_s(tmp_path, monkeypatch, arch):
    """The port's launcher against the reference's, from the same seed: the
    starting parameters bitwise (the reference's ``PRNGKey(0)``), every
    step's loss within LOSS_RTOL, and the final checkpoint (parameters
    and AdamW state) within a step's tolerances (``_step_close``) once for
    each step taken: each AdamW step may move an element up to LR_TOL·lr
    (LM_LR_TOL·lr) apart (measured after 3 steps: 1.32 times one step's
    tolerance for the dense LM's wg, 1.56 for SASRec's wq)."""
    from repro.launch import train as jtrain_launcher

    lr, steps = 1e-3, 3
    started, jstarted = [], []
    monkeypatch.setattr(train_launcher, "init_params", _recording(
        train_launcher.init_params, started,
        lambda t: [x.detach().clone().numpy() for x in tree_leaves(t)]))
    monkeypatch.setattr(jtrain_launcher, "init_params", _recording(
        jtrain_launcher.init_params, jstarted,
        lambda t: [np.asarray(x) for x in jax.tree_util.tree_leaves(t)]))
    out = train_launcher.run(arch, steps, 4, 16, str(tmp_path / "port"), 100, lr,
                             device="cpu")
    jout = jtrain_launcher.run(arch, steps, 4, 16, str(tmp_path / "ref"), 100, lr)
    assert len(started) == len(jstarted) == 1 and len(started[0]) == len(jstarted[0])
    for g, w in zip(started[0], jstarted[0]):
        np.testing.assert_array_equal(g, w)
    assert len(out["losses"]) == len(jout["losses"]) == steps
    np.testing.assert_allclose(out["losses"], jout["losses"], rtol=LOSS_RTOL)
    name = f"step_{steps - 1:08d}.npz"
    got, want = np.load(tmp_path / "port" / name), np.load(tmp_path / "ref" / name)
    assert sorted(got.files) == sorted(want.files) and len(got.files) > 10
    family = "lm" if get_config(arch).family == "lm" else "other"
    tol = steps * STEP_TOL, steps * (LM_LR_TOL if family == "lm" else LR_TOL) * lr
    for k in got.files:
        g, w = got[k], want[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if w.dtype.kind != "f":
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, rtol=0, atol=tol[0] * max(np.abs(w).max(), 1e-30)
                                   + tol[1], err_msg=k)


def test_train_launcher_refuses_the_full_preset(tmp_path):
    with pytest.raises(SystemExit, match="more than one card"):
        train_launcher.main(["--preset", "full", "--ckpt-dir", str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()
