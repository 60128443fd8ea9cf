"""The training mesh on the CPU: ``torch.distributed`` ranks under gloo
against the reference's sharded steps.

The port's ranks run every case of a world size once (2 and 4 ranks,
``tests/torch_model_mesh_worker.py``, spawned by a module-scoped fixture);
the reference runs in a process of its own with four host devices
(``tests/torch_model_mesh_ref.py``) on meshes with Auto axes: on Explicit
axes its steps hit fault R3. Inputs are made here from numpy seeds, so the
two sides start from the same parameters and batches.

* (a) ``spec_for``, ``params_shardings`` and ``shardings_for_axes`` equal the
  reference's, entry for entry, for every ``ParamSpec`` of every registry
  arch on five meshes;
* (b) a rank's block is the one ``devices_indices_map`` gives the
  reference's device of the same linear index, and ``shard_tree`` then
  ``gather_tree`` is the input, bitwise;
* (c) ``moe_mlp_shmap`` against the reference's, with a capacity that drops
  tokens and one that does not: output and aux within 1e-6 of max|out|;
* (d) two float32 train steps on (1, 2), (2, 1) and (2, 2) against the
  reference's sharded step, with ``tests/test_torch_train.py``'s
  tolerances: the loss within LOSS_RTOL, the grad norm within GNORM_RTOL,
  every parameter within STEP_TOL·max|p| + LR_TOL·lr (LM_LR_TOL for the
  LMs). The LMs and SASRec train at lr 1e-5 (``W.LR``): their attention
  logits are sharp at the reference's fan-in (fault R6), and at 1e-3 the
  second step's gradient norm moves apart in proportion (5e-4 for SASRec
  between the two packages on one rank each), beyond GNORM_RTOL. A case
  marked "one" is held against the port's one-rank step instead (the
  reference's compiles take ≈ 5 s a case); a MoE layer on a mesh that
  splits the tokens routes each shard apart, so those are held against
  the reference only;
* (e) the BigGraphVis cells on 2 and 4 ranks, bitwise the port's one-rank
  step;
* (f) ``launch/train.py --mesh 1x2`` killed and resumed, bitwise.
"""
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro.configs import REGISTRY as JREGISTRY  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import sasrec as jsas  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.param import abstract_params as jabstract_params  # noqa: E402
from repro.models.param import logical_axes as jlogical_axes  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402

import torch_model_mesh_worker as W  # noqa: E402
from repro_torch.configs import REGISTRY, all_cells, get_config  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    ModelMesh,
    make_host_mesh,
    make_model_mesh,
    make_production_mesh,
    mesh_coords,
    spawn_local,
)
from repro_torch.launch.steps import build_step  # noqa: E402
from repro_torch.models import gnn as gnn_lib  # noqa: E402
from repro_torch.models import sasrec as sas_lib  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.param import abstract_params, logical_axes  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.params import local_block  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 300
MESHES = [(16, 16), (2, 16, 16), (1, 1), (2, 2), (4, 2)]
# tests/test_torch_train.py's tolerances.
STEP_TOL = 1e-6
LR_TOL, LM_LR_TOL = 2e-3, 0.1
LOSS_RTOL = 1e-5
GNORM_RTOL = {"lm": 5e-5, "other": 1e-6}
# The second step starts from parameters that already differ by rounding,
# and its gradients move further apart across discontinuities: an MoE
# token whose top-k is a near tie changes experts. Its grad norm is held
# within test_torch_train.py's widest bucket (2e-4, SASRec's full config);
# measured 7.1e-5 between the two packages' one-rank granite steps.
GNORM2_RTOL = 2e-4
# With compress_grads a rounding-level gradient difference can cross an
# int8 step of the round trip, and AdamW turns that into a move of up to lr:
# each element stays within the 2.02·lr a step can move it by, and all but
# FLIP_FRAC of them within the step tolerance (measured 1 of 261,440).
FLIP_FRAC = 2e-5
MOE_TOL = 1e-6
BLOCK_CASES = {  # (shape, spec, mesh) for devices_indices_map
    f"{s}-{i}": ((8, 12), spec, s)
    for s in ((1, 2), (2, 1), (2, 2), (4, 1))
    for i, spec in enumerate([(None, "model"), ("data", None), (("data", "model"), None),
                              (("model", "data"), None), ("model", "data"), (None, None)])
}


def _axes_names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


# ------------------------------------------------------------------ inputs
def _inputs() -> dict:
    params, batch = {}, {}
    for i, case in enumerate(W.CASES):
        name, family, cfg_name = case[:3]
        _, _, cfg, specs, _ = W.port_case(family, cfg_name)
        params[name] = W.np_params(W.spec_leaves(specs), seed=100 + i)
        batch[name] = W.batch_for(family, cfg, seed=200 + i)
    b, s, d, e, f, _ = W.MOE_SHAPE
    rng = np.random.default_rng(5)
    moe = [rng.standard_normal(sh).astype(np.float32) * sc for sh, sc in (
        ((b, s, d), 1.0), ((d, e), 0.5), ((e, d, f), 0.25), ((e, d, f), 0.25),
        ((e, f, d), 0.35))]
    return {"params": params, "batch": batch, "moe": moe, "blocks": BLOCK_CASES}


def _read_ranks(out_dir, world):
    got = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's process and the port's 2- and 4-rank groups, at once;
    then the port's one-rank runs."""
    d = tmp_path_factory.mktemp("model_mesh")
    inputs = _inputs()
    inp = d / "inputs.pkl"
    with open(inp, "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    refs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_model_mesh_ref.py"),
                              str(inp), str(d / f"ref{i}.pkl"), *names], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i, names in enumerate([["--moe", *W.REF_GROUPS[0]], *W.REF_GROUPS[1:]])]
    errors = []

    def group(world):
        try:
            (d / f"w{world}").mkdir()
            spawn_local(W.run_all, world, device="cpu", init_file=str(d / f"store{world}"),
                        args=(str(inp), str(d / f"w{world}")), timeout=SPAWN_TIMEOUT)
        except Exception as e:  # re-raised below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=group, args=(w,)) for w in (2, 4)]
    for t in threads:
        t.start()
    one = {c[0]: W.port_train(None, c, inputs) for c in W.CASES}
    one_bgv = {}
    for case in W.BGV_CASES:
        built, args = W.bgv_step(case, None)
        one_bgv[case[0]] = [o.numpy() for o in built.fn(*args)]
    for t in threads:
        t.join()
    reference = {"train": {}}
    for i, ref in enumerate(refs):
        out, _ = ref.communicate(timeout=SPAWN_TIMEOUT)
        assert ref.returncode == 0, out[-4000:]
        with open(d / f"ref{i}.pkl", "rb") as f:
            part = pickle.load(f)
        reference["train"].update(part.pop("train", {}))
        reference.update(part)
    if errors:
        raise errors[0]
    return {"ref": reference, "one": one, "one_bgv": one_bgv,
            2: _read_ranks(d / "w2", 2), 4: _read_ranks(d / "w4", 4)}


# --------------------------------------------------------------------- (a)
def _param_specs(arch):
    """Every (name, port specs, reference specs) of an arch's models."""
    if arch.family == "lm":
        return [(arch.name, tfm.param_specs(arch.model),
                 jtfm.param_specs(JREGISTRY[arch.name]().model))]
    if arch.family == "recsys":
        return [(arch.name, sas_lib.param_specs(arch.model),
                 jsas.param_specs(JREGISTRY[arch.name]().model))]
    if arch.family == "gnn":
        jarch = JREGISTRY[arch.name]()
        return [(s, gnn_lib.param_specs(arch.model_for(arch.shapes[s])),
                 jgnn.param_specs(jarch.model_for(jarch.shapes[s]))) for s in arch.shapes]
    return []


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _entries(spec, ndim):
    """One entry a dim, a one-axis tuple as its name (the reference's spec
    normalises them so)."""
    out = list(spec) + [None] * (ndim - len(spec))
    out = [tuple(e) if isinstance(e, (list, tuple)) else e for e in out]
    return [e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in out]


@pytest.mark.parametrize("name", list(REGISTRY))
def test_rules_match_the_reference(name):
    arch = get_config(name)
    if arch.family == "bgv":  # no parameters: its placements are the step's
        for shape in MESHES:
            mesh = rules.AbstractMesh(shape, _axes_names(shape))
            jmesh = JAbstractMesh(shape, _axes_names(shape))
            spec = jrules.filter_spec(jax.sharding.PartitionSpec(("pod", "data"), None), jmesh)
            assert _entries(rules.filter_spec(rules.P(("pod", "data"), None), mesh), 2) \
                == _entries(spec, 2)
        return
    for _, specs, jspecs in _param_specs(arch):
        for shape in MESHES:
            mesh = rules.AbstractMesh(shape, _axes_names(shape))
            jmesh = JAbstractMesh(shape, _axes_names(shape))
            prof = rules.PROFILES[arch.profile]
            assert prof == jrules.PROFILES[arch.profile]
            for s, js in zip(_leaves(specs), jax.tree_util.tree_leaves(
                    jspecs, is_leaf=lambda x: hasattr(x, "logical_axes"))):
                got = rules.spec_for(s.shape, s.logical_axes, prof, mesh)
                want = jrules.spec_for(js.shape, js.logical_axes, prof, jmesh)
                assert _entries(got, len(s.shape)) == _entries(want, len(s.shape))
            got_p = [x.spec for x in _leaves(rules.params_shardings(specs, arch.profile, mesh))]
            want_p = [x.spec for x in jax.tree_util.tree_leaves(
                jrules.params_shardings(jspecs, arch.profile, jmesh))]
            assert [_entries(g, len(s.shape)) for g, s in zip(got_p, _leaves(specs))] \
                == [_entries(w, len(s.shape)) for w, s in zip(want_p, _leaves(specs))]
            for bits in (32, 8):
                acfg, jacfg = opt.AdamWConfig(state_bits=bits), jopt.AdamWConfig(state_bits=bits)
                aopt = opt.abstract_opt_state(abstract_params(specs), acfg)
                jaopt = jopt.abstract_opt_state(jabstract_params(jspecs), jacfg)
                got_o = rules.shardings_for_axes(
                    aopt, opt.opt_logical_axes(logical_axes(specs), acfg), arch.profile, mesh)
                want_o = jrules.shardings_for_axes(
                    jaopt, jopt.opt_logical_axes(jlogical_axes(jspecs), jacfg),
                    arch.profile, jmesh)
                go, wo = _leaves(got_o), jax.tree_util.tree_leaves(want_o)
                shapes = [tuple(x.shape) for x in _leaves(aopt)]
                assert [_entries(g.spec, len(sh)) for g, sh in zip(go, shapes)] \
                    == [_entries(w.spec, len(sh)) for w, sh in zip(wo, shapes)]


def test_filter_spec_and_batch_sharding_match_the_reference():
    for shape in MESHES:
        mesh = rules.AbstractMesh(shape, _axes_names(shape))
        jmesh = JAbstractMesh(shape, _axes_names(shape))
        for spec in [(("pod", "data"), None), ("pod", "model"), (None,), ("data", ("model",))]:
            got = rules.batch_sharding(mesh, rules.P(*spec))[0].spec
            want = jrules.batch_sharding(jmesh, jax.sharding.PartitionSpec(*spec))[0].spec
            assert _entries(got, len(spec)) == _entries(want, len(spec))


# --------------------------------------------------------------------- (b)
def test_blocks_match_devices_indices_map(runs):
    for key, (shape, spec, mesh_shape) in BLOCK_CASES.items():
        mesh = rules.AbstractMesh(mesh_shape, ("data", "model"))
        for r, want in enumerate(runs["ref"]["blocks"][key]):
            coords = mesh_coords(r, ("data", "model"), mesh_shape)
            got = local_block(shape, rules.P(*spec), mesh, coords)
            assert tuple((s.start or 0, s.stop if s.stop is not None else n)
                         for s, n in zip(got, shape)) == want, (key, r)


@pytest.mark.parametrize("world", [2, 4])
def test_shard_then_gather_is_bitwise(runs, world):
    """Every rank's blocks of the dense LM's parameters (and the 8-bit
    state) are its ``local_block`` of the whole, and gathered back they are
    the whole, bitwise."""
    inputs = _inputs()["params"]["dense-8bit-compress-2x2" if world == 4 else "dense-8bit-1x2"]
    shape = (2, 2) if world == 4 else (1, 2)
    mesh = rules.AbstractMesh(shape, ("data", "model"))
    for got in runs[world]:
        rt = got["round_trip"]
        assert rt["same_params"] and rt["same_state"]
        for k, blk in rt["blocks"].items():
            want = inputs[k][local_block(inputs[k].shape, rt["specs"][k], mesh, got["coords"])]
            assert np.array_equal(blk, want), k


# --------------------------------------------------------------------- (c)
@pytest.mark.parametrize("case", W.MOE_CASES, ids=[c[0] for c in W.MOE_CASES])
def test_moe_mlp_shmap_matches_the_reference(runs, case):
    want = runs["ref"]["moe"][case[0]]
    scale = np.abs(want["out"]).max()
    for got in runs[W.world_of(case[1])]:
        res = got["moe"][case[0]]
        assert res["out"].shape == want["out"].shape
        np.testing.assert_allclose(res["out"], want["out"], rtol=0, atol=MOE_TOL * scale)
        assert abs(res["aux"] - want["aux"]) <= MOE_TOL * scale


def test_moe_capacity_cases_drop_and_keep():
    """The drop case really drops (its output differs from the no-drop
    one's), so (c) holds both paths."""
    inputs = _inputs()
    from repro_torch.launch.mesh import ModelMesh as _M
    from repro_torch.models.layers import moe_mlp_shmap

    one = _M(("data", "model"), {"data": 1, "model": 1}, 0, {"data": 0, "model": 0},
             torch.device("cpu"), {})
    x, router, wg, wi, wo = (torch.as_tensor(a) for a in inputs["moe"])
    outs = [moe_mlp_shmap(x, router, wg, wi, wo, top_k=W.MOE_SHAPE[-1], capacity_local=c,
                          mesh=one, expert_axis="model", token_axes=("data",))[0]
            for c in (2, 64)]
    assert not torch.equal(outs[0], outs[1])


# --------------------------------------------------------------------- (d)
def _lr(family):
    return W.LR[family]


@pytest.mark.parametrize("case", W.CASES, ids=[c[0] for c in W.CASES])
def test_train_steps_match_the_reference_sharded_step(runs, case):
    """Against the reference's sharded step (``ref``), or where the case is
    the port's only (``one``), against the port's one-rank step."""
    name, family = case[:2]
    want = runs["ref"]["train"][name] if case[6] == "ref" else runs["one"][name]
    lr = _lr(family)
    gtol = GNORM_RTOL["lm" if family == "lm" else "other"]
    ltol = LM_LR_TOL if family == "lm" else LR_TOL
    ranks = runs[W.world_of(case[3])]
    for got in ranks:
        res = got["train"][name]
        for i, ((l, g), (jl, jg)) in enumerate(zip(res["metrics"], want["metrics"])):
            np.testing.assert_allclose(l, jl, rtol=LOSS_RTOL)
            np.testing.assert_allclose(g, jg, rtol=gtol if i == 0 else GNORM2_RTOL)
        n_out = n_all = 0
        for k, w in want["params"].items():
            p = res["params"][k]
            assert p.shape == w.shape and np.isfinite(p).all(), k
            d = np.abs(p - w)
            tol = STEP_TOL * np.abs(w).max() + ltol * lr
            if not case[5]:
                assert (d <= tol).all(), (k, float(d.max()) / lr)
            assert (d <= 2.02 * lr * W.STEPS * (1 + 0.01 * np.abs(w))).all(), k
            n_out += int((d > tol).sum())
            n_all += d.size
        assert n_out <= FLIP_FRAC * n_all, (n_out, n_all)
    # Every rank gathered the same parameters.
    for got in ranks[1:]:
        for k, v in got["train"][name]["params"].items():
            assert np.array_equal(v, ranks[0]["train"][name]["params"][k]), k


# --------------------------------------------------------------------- (e)
@pytest.mark.parametrize("case", W.BGV_CASES, ids=[c[0] for c in W.BGV_CASES])
@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_bgv_cells_on_ranks_are_the_one_rank_step(runs, case, shape):
    want = runs["one_bgv"][case[0]]
    for got in runs[W.world_of(shape)]:
        outs = got["bgv"][(case[0], shape)]
        assert len(outs) == len(want)
        for i, w in enumerate(want):
            g = outs[f"out{i}"]
            assert g.dtype == w.dtype and g.shape == w.shape
            assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), (case[0], i)


# ------------------------------------------------------- building the cells
_FAKE = {s: ModelMesh(("data", "model"), {"data": s[0], "model": s[1]}, 0,
                      {"data": 0, "model": 0}, torch.device("cpu"), {})
         for s in ((1, 2), (2, 2))}


def _train_and_bgv_cells():
    return [(a.name, s.name) for a, s in all_cells()
            if not s.skip and (s.kind in ("train", "graph_train") or a.family == "bgv")]


@pytest.mark.parametrize("name,cell", _train_and_bgv_cells())
def test_every_training_and_bgv_cell_builds_on_a_mesh(name, cell):
    arch = get_config(name)
    for shape, mesh in _FAKE.items():
        built = build_step(arch, arch.shapes[cell], mesh)
        assert built.in_specs is not None and len(built.in_specs) == len(built.abstract_args)
        one = build_step(arch, arch.shapes[cell])
        assert built.meta == one.meta and one.in_specs is None
        if arch.family != "bgv":
            p_specs = built.in_specs[0]
            for spec, a in zip(_leaves(p_specs), _leaves(built.abstract_args[0])):
                for e, n in zip(spec, a.shape):  # every split dim divides
                    assert n % mesh.extent(rules.entry_axes(e)) == 0


@pytest.mark.parametrize("name,cell", [("yi-6b", "prefill_32k"), ("yi-6b", "decode_32k"),
                                       ("sasrec", "serve_p99"), ("sasrec", "retrieval_cand")])
def test_serving_cells_on_a_mesh_raise_naming_the_roadmap(name, cell):
    arch = get_config(name)
    with pytest.raises(NotImplementedError, match="15f"):
        build_step(arch, arch.shapes[cell], _FAKE[(2, 2)])


def test_meshes_of_the_wrong_size_raise():
    host = make_host_mesh(device="cpu")
    assert (host.axis_names, host.shape, host.size) == (("data", "model"),
                                                        {"data": 1, "model": 1}, 1)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_model_mesh((2, 1), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="256"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512"):
        make_production_mesh(multi_pod=True, device="cpu")
    assert [mesh_coords(r, ("pod", "data", "model"), (2, 2, 2)) for r in (0, 5, 7)] == [
        {"pod": 0, "data": 0, "model": 0}, {"pod": 1, "data": 0, "model": 1},
        {"pod": 1, "data": 1, "model": 1}]


# --------------------------------------------------------------------- (f)
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
    """``launch/train.py --mesh 1x2`` on two ranks under
    ``torch.distributed.run`` (the kill harness's ranks each kill
    themselves), started; ``.communicate()`` waits."""
    args = ["--device", "cpu", "--arch", "yi-6b", "--mesh", "1x2", "--steps", "8",
            "--ckpt-every", "3", "--batch", "4", "--seq", "16", "--ckpt-dir", str(tmp_path / ckpt)]
    if kill_at is None:
        entry = ["-m", "repro_torch.launch.train"]
    else:
        harness = tmp_path / "kill_harness.py"
        harness.write_text(KILL_AFTER_STEP)
        entry = [str(harness), str(kill_at)]
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         *entry, *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2"))


def _done(proc):
    out, err = proc.communicate(timeout=300)
    return proc.returncode, out, err


def test_train_launcher_mesh_kill_and_resume_is_bitwise(tmp_path):
    """Two ranks on a (1, 2) mesh, each writing its own blocks: killed
    (SIGKILL) after step 5, resumed from the step-3 checkpoints, the final
    blocks of both ranks equal an uninterrupted run's bit for bit (the
    uninterrupted and the killed run at once)."""
    whole, killed = _launch(tmp_path, "whole"), _launch(tmp_path, "killed", kill_at=5)
    rc, _, err = _done(whole)
    assert rc == 0, err[-4000:]
    rc, out, err = _done(killed)
    assert rc != 0 and "step 5: killed" in out, err[-4000:]
    rc, out, err = _done(_launch(tmp_path, "killed"))
    assert rc == 0, err[-4000:]
    assert "restored checkpoint @ step 3" in out
    for r in range(2):
        a = np.load(tmp_path / "whole" / f"rank{r:03d}" / "step_00000007.npz")
        b = np.load(tmp_path / "killed" / f"rank{r:03d}" / "step_00000007.npz")
        assert sorted(a.files) == sorted(b.files) and len(a.files) > 10
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
