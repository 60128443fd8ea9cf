"""The serving mesh on the CPU: prefill with sequence parallelism, decode on
the sequence-sharded KV cache, SASRec serve and retrieval, and microbatches
in the reference's order (fault F3), on ``torch.distributed`` ranks under
gloo against the reference's sharded steps.

The port's ranks run every case of a world size once (2 and 4 ranks,
``tests/torch_serve_mesh_worker.py``, spawned by a module-scoped fixture);
the reference runs in processes of their own with four host devices
(``tests/torch_serve_mesh_ref.py``) on meshes with Auto axes (fault R3).
Inputs are made here from numpy seeds.

* (a) F3: a dense LM with a ragged loss mask and 2 microbatches on (2, 1)
  and (2, 2), and granite with a capacity that drops tokens on (2, 2),
  against the reference's sharded microbatched step, with
  ``tests/test_torch_train.py``'s tolerances; the dense cases also against
  the port's one-rank microbatched step (the (2, 1) case differed from it
  by 4.1e-4 of the loss before the repair); G1: 8 rows in 4 microbatches
  on (4, 1), whose shares are uneven (two ranks a row, two none), and on
  (2, 2), dense against the reference's sharded step and the port's
  one-rank step, granite on (2, 2) against the reference (on (4, 1) the
  reference's MoE ``shard_map`` refuses uneven token shards, and the port
  raises there too);
* (b) sequence parallelism: train steps with the sequence split over
  "model" on (1, 2) and (2, 2) bitwise the same step with ``seq_axis``
  None, and within tolerance of the reference's sharded step; granite on
  (1, 2); a sequence that does not divide leaves it off;
* (c) prefill on (1, 2) and (2, 2) (and granite on (1, 2)): the gathered
  logits within PREFILL_TOL·max|logits| of the reference's sharded prefill;
* (d) decode on (1, 2) and (2, 2): against the reference's sharded decode
  with every slot at one length (the slots cross the rank boundary at 16
  on the second step); against the port's one-rank decode with per-slot
  lengths, an inactive slot and a slot crossing the boundary, and on the
  sliding-window config where rank 0's whole range is masked for one
  slot. Split-K sums the softmax in another order, so the logits agree
  within DECODE_TOL·max|logits|; the cache entries a step does not write,
  and layer 0's new ones, are bitwise; two runs on the ranks are bitwise;
* (e) SASRec serve on (1, 2), (2, 1), (2, 2) and retrieval on (1, 2),
  (2, 2) against the reference's sharded steps;
* (f) the cache's and the candidates' blocks against
  ``devices_indices_map``; ``attend_partial`` and ``combine_partials`` on
  one rank.
"""
import os
import pickle
import subprocess
import sys
import threading
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_model_mesh_worker as MW  # noqa: E402
import torch_serve_mesh_worker as W  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.configs.sasrec import smoke_sasrec  # noqa: E402
from repro_torch.launch.mesh import ModelMesh, mesh_coords, spawn_local  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import sasrec as sas_lib  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.params import Placement, local_block  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 300
# tests/test_torch_train.py's tolerances, as tests/test_torch_model_mesh.py
# holds the training mesh.
STEP_TOL, LM_LR_TOL, LOSS_RTOL = 1e-6, 0.1, 1e-5
GNORM_RTOL, GNORM2_RTOL = 5e-5, 2e-4
# Float32 on the CPU, of max|logits|: prefill (products over split heads
# and MLP columns summed across ranks, against another package) and decode
# (split-K: the softmax's sums in another order), about 5× and 8× the
# largest measured: prefill 3.4e-6 (dense, 1x2), 6.4e-6 (dense, 2x2) and
# 9.5e-6 (granite) of the reference's; decode 1.4e-6 and 1.9e-6 of the
# reference's, up to 2.4e-6 (sliding) of the port's one-rank decode.
PREFILL_TOL, DECODE_TOL = 5e-5, 2e-5
# SASRec's scores, of max|scores|: against the reference (the two packages'
# float32 encoders differ by up to 4.0e-6 of it, measured), and against
# the port's one-rank step (the same products on fewer rows, and sums over
# "model" with one non-zero term: bitwise on this CPU when measured).
SAS_TOL, SAS_ONE_TOL = 2e-5, 1e-6


def _cfg(cfg_name):
    return W.port_arch(cfg_name)[1]


def _inputs() -> dict:
    params, batch, decode, sas = {}, {}, {}, {}
    for i, case in enumerate(W.TRAIN_CASES + W.PREFILL_CASES):
        name, cfg_name, _, (rows, seq) = case[:4]
        cfg = _cfg(cfg_name)
        params[name] = MW.np_params(MW.spec_leaves(tfm.param_specs(cfg)), seed=300 + i)
        batch[name] = W.lm_batch(cfg, rows, seq, seed=400 + i)
    for i, case in enumerate(W.DECODE_CASES):
        cfg = _cfg(case[1])
        params[case[0]] = MW.np_params(MW.spec_leaves(tfm.param_specs(cfg)), seed=500 + i)
        decode[case[0]] = W.decode_inputs(cfg, case, seed=600 + i)
    for i, case in enumerate(W.SAS_CASES):
        cfg = smoke_sasrec()
        params[case[0]] = MW.np_params(MW.spec_leaves(sas_lib.param_specs(cfg)), seed=700 + i)
        sas[case[0]] = W.sas_inputs(cfg, seed=800 + i)
    return {"params": params, "batch": batch, "decode": decode, "sas": sas,
            "blocks": W.BLOCK_CASES}


def _read_ranks(out_dir, world):
    got = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's processes and the port's 2- and 4-rank groups, at
    once; then the port's one-rank runs."""
    d = tmp_path_factory.mktemp("serve_mesh")
    inputs = _inputs()
    inp = d / "inputs.pkl"
    with open(inp, "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    groups = [["--blocks", *W.REF_GROUPS[0]], *W.REF_GROUPS[1:]]
    refs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_serve_mesh_ref.py"),
                              str(inp), str(d / f"ref{i}.pkl"), *names], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i, names in enumerate(groups)]
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
    one = {"train": {c[0]: W.port_train(None, c, inputs) for c in W.TRAIN_CASES
                     if "one" in c[5]},
           "decode": {c[0]: W.port_decode(None, c, inputs) for c in W.DECODE_CASES
                      if not isinstance(c[3], int)},
           "sas": {c[0]: W.port_sas(None, c, inputs) for c in W.SAS_CASES}}
    for t in threads:
        t.join()
    reference = {}
    for i, ref in enumerate(refs):
        out, _ = ref.communicate(timeout=SPAWN_TIMEOUT)
        assert ref.returncode == 0, out[-4000:]
        with open(d / f"ref{i}.pkl", "rb") as f:
            part = pickle.load(f)
        for k, v in part.items():
            reference.setdefault(k, {}).update(v)
    if errors:
        raise errors[0]
    return {"ref": reference, "one": one, "inputs": inputs,
            2: _read_ranks(d / "w2", 2), 4: _read_ranks(d / "w4", 4)}


def _hold_train(res, want):
    """A port run against another within the train tolerances (lr W.LR)."""
    for i, ((l, g), (jl, jg)) in enumerate(zip(res["metrics"], want["metrics"])):
        np.testing.assert_allclose(l, jl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(g, jg, rtol=GNORM_RTOL if i == 0 else GNORM2_RTOL)
    for k, w in want["params"].items():
        p = res["params"][k]
        assert p.shape == w.shape and np.isfinite(p).all(), k
        d = np.abs(p - w)
        tol = STEP_TOL * np.abs(w).max() + LM_LR_TOL * W.LR
        assert (d <= tol).all(), (k, float(d.max()) / W.LR)


def _ranks_agree(ranks, kind, name, key):
    for got in ranks[1:]:
        a, b = got[kind][name][key], ranks[0][kind][name][key]
        if isinstance(a, dict):
            for k in a:
                assert np.array_equal(a[k], b[k]), (name, k)
        elif isinstance(a, list):
            for x, y in zip(a, b):
                assert np.array_equal(x, y), name
        else:
            assert np.array_equal(a, b), name


# --------------------------------------------------------------------- (a)
F3_CASES = [c for c in W.TRAIN_CASES if c[0].startswith("f3")]
G1_CASES = [c for c in W.TRAIN_CASES if c[0].startswith("g1")]
SP_CASES = [c for c in W.TRAIN_CASES if c[0].startswith("sp")]


@pytest.mark.parametrize("case", F3_CASES, ids=[c[0] for c in F3_CASES])
def test_microbatches_on_a_mesh_follow_the_reference(runs, case):
    """Microbatch i is global rows [i·B/n, (i+1)·B/n) on every mesh: the
    sharded microbatched step matches the reference's, and the dense
    cases the port's one-rank step (loss within LOSS_RTOL)."""
    name = case[0]
    ranks = runs[W.world_of(case[2])]
    for got in ranks:
        res = got["train"][name]
        _hold_train(res, runs["ref"]["train"][name])
        if "one" in case[5]:
            _hold_train(res, runs["one"]["train"][name])
    _ranks_agree(ranks, "train", name, "params")


@pytest.mark.parametrize("case", G1_CASES, ids=[c[0] for c in G1_CASES])
def test_uneven_microbatch_shares_follow_the_reference(runs, case):
    """B/n rows that do not split evenly over the batch shards (fault G1):
    each rank takes its padded block of every microbatch, possibly none,
    and the step matches the reference's sharded step (and the dense
    cases the port's one-rank step) within the train tolerances."""
    test_microbatches_on_a_mesh_follow_the_reference(runs, case)


def test_microbatches_that_do_not_split_raise():
    """Global rows that do not split into n microbatches raise, as the
    reference's reshape does; uneven shares of an expert model raise, as
    the reference's MoE ``shard_map`` does."""
    mesh = ModelMesh(("data", "model"), {"data": 2, "model": 1}, 0, {"data": 0, "model": 0},
                     torch.device("cpu"), {})
    from repro_torch.train.train_loop import _microbatches

    place = Placement(mesh, {}, ("data",), {"tokens": rules.P("data", None)})
    with pytest.raises(NotImplementedError, match="microbatches"):
        _microbatches({"tokens": torch.zeros((3, 4), dtype=torch.int32)}, 4, place)
    moe = replace(place, specs={"layers": {"router": rules.P()}})
    with pytest.raises(NotImplementedError, match="shard_map"):
        _microbatches({"tokens": torch.zeros((3, 4), dtype=torch.int32)}, 2, moe)


# --------------------------------------------------------------------- (b)
@pytest.mark.parametrize("case", SP_CASES, ids=[c[0] for c in SP_CASES])
def test_sequence_parallel_steps(runs, case):
    """With the sequence split the step is bitwise the replicated one (the
    same products and norms on the same operands) and within tolerance of
    the reference's sharded step; a sequence that does not divide leaves
    it off."""
    name = case[0]
    ranks = runs[W.world_of(case[2])]
    divides = case[3][1] % case[2][1] == 0
    for got in ranks:
        res = got["train"][name]
        assert res["seq_axis"] == ("model" if divides else None)
        _hold_train(res, runs["ref"]["train"][name])
        if "nosp" in case[5]:
            off = got["nosp"][name]
            assert off["seq_axis"] is None
            assert res["metrics"] == off["metrics"]
            for k, v in off["params"].items():
                assert np.array_equal(res["params"][k], v), k
    _ranks_agree(ranks, "train", name, "params")


_FAKE = {s: ModelMesh(("data", "model"), {"data": s[0], "model": s[1]}, 0,
                      {"data": 0, "model": 0}, torch.device("cpu"), {})
         for s in ((1, 2), (2, 1), (2, 2))}


def test_sequence_parallelism_follows_the_reference_rule():
    """``seq_axis`` is "model" for train and prefill when the sequence
    divides over it (the reference's ``steps.py:125``), else None; decode
    never splits the sequence of its activations."""
    arch = get_config("yi-6b")
    for shape, mesh in _FAKE.items():
        for kind, seq, want in (("train", 4096, "model"), ("prefill", 32768, "model"),
                                ("train", 4095, None if shape[1] > 1 else "model"),
                                ("decode", 32768, None)):
            spec = ShapeSpec("c", kind, seq_len=seq, global_batch=4)
            built = build_step(arch, spec, mesh)
            assert built.place.seq_axis == want, (shape, kind, seq)
            assert built.place.sp == (want is not None and shape[1] > 1)


# --------------------------------------------------------------------- (c)
@pytest.mark.parametrize("case", W.PREFILL_CASES, ids=[c[0] for c in W.PREFILL_CASES])
def test_prefill_matches_the_reference_sharded_prefill(runs, case):
    want = runs["ref"]["prefill"][case[0]]["logits"]
    scale = np.abs(want).max()
    for got in runs[W.world_of(case[2])]:
        res = got["prefill"][case[0]]
        assert res["sp"] and res["logits"].shape == want.shape
        np.testing.assert_allclose(res["logits"], want, rtol=0, atol=PREFILL_TOL * scale)


# --------------------------------------------------------------------- (d)
REF_DECODE = [c for c in W.DECODE_CASES if isinstance(c[3], int)]
SLOT_DECODE = [c for c in W.DECODE_CASES if not isinstance(c[3], int)]


def _hold_decode(res, want, start_cache, written):
    """Logits within DECODE_TOL; the cache after each step: the entries not
    written by this or an earlier step bitwise the seeded ones, layer 0's
    bitwise ``want``'s, every entry within DECODE_TOL·max|cache|."""
    for t, (lg, wl) in enumerate(zip(res["logits"], want["logits"])):
        assert lg.shape == wl.shape and np.isfinite(lg).all()
        np.testing.assert_allclose(lg, wl, rtol=0, atol=DECODE_TOL * np.abs(wl).max())
        for k in ("k", "v"):
            c, w = res["caches"][t][k], want["caches"][t][k]
            keep = ~written[t]
            assert np.array_equal(c[:, keep], start_cache[k][:, keep]), (t, k)
            np.testing.assert_allclose(c, w, rtol=0, atol=DECODE_TOL * np.abs(w).max())


def _written(case, inputs):
    """[steps, B, S_max] bool: the entries written by step t or before."""
    d = inputs["decode"][case[0]]
    cur = np.broadcast_to(np.asarray(d["cur_len"]), (W.DECODE_ROWS,)).astype(np.int64)
    act = np.asarray(d.get("active", np.ones(W.DECODE_ROWS, bool)), bool)
    out = np.zeros((W.DECODE_STEPS, W.DECODE_ROWS, W.DECODE_SMAX), bool)
    for t in range(W.DECODE_STEPS):
        if t:
            out[t] = out[t - 1]
        out[t, np.arange(W.DECODE_ROWS)[act], (cur + t * act)[act]] = True
    return out


@pytest.mark.parametrize("case", REF_DECODE, ids=[c[0] for c in REF_DECODE])
def test_decode_matches_the_reference_sharded_decode(runs, case):
    """Every slot at one length, as the reference writes (R5); its cache
    is split by position over "model" as the port's."""
    inputs = runs["inputs"]
    want = runs["ref"]["decode"][case[0]]
    ranks = runs[W.world_of(case[2])]
    for got in ranks:
        _hold_decode(got["decode"][case[0]], want, inputs["decode"][case[0]],
                     _written(case, inputs))
        assert all(np.array_equal(a, b) for a, b in zip(got["decode"][case[0]]["logits"],
                                                        got["decode2"][case[0]]["logits"]))
    _ranks_agree(ranks, "decode", case[0], "logits")


@pytest.mark.parametrize("case", SLOT_DECODE, ids=[c[0] for c in SLOT_DECODE])
def test_decode_with_slot_lengths_matches_one_rank(runs, case):
    """Per-slot lengths and ``active`` against the port's one-rank decode:
    logits within DECODE_TOL, a slot crossing the rank boundary, the
    inactive slot left alone, layer 0's new K/V bitwise, two runs bitwise,
    and (sliding) a rank whose whole range is masked adds zeros, not NaN."""
    inputs = runs["inputs"]
    want = runs["one"]["decode"][case[0]]
    written = _written(case, inputs)
    for got in runs[W.world_of(case[2])]:
        res = got["decode"][case[0]]
        _hold_decode(res, want, inputs["decode"][case[0]], written)
        for t in range(W.DECODE_STEPS):
            for k in ("k", "v"):
                assert np.array_equal(res["caches"][t][k][0], want["caches"][t][k][0]), (t, k)
        again = got["decode2"][case[0]]
        for a, b in zip(res["logits"] + [c["k"] for c in res["caches"]],
                        again["logits"] + [c["k"] for c in again["caches"]]):
            assert np.array_equal(a, b)


def test_a_masked_range_adds_exact_zeros():
    """``attend_partial`` over a range that the window masks whole gives
    m = finfo.min and exact zeros; over a live range, combined on one rank,
    it is ``gqa_attention`` within rounding."""
    g = torch.Generator().manual_seed(3)
    b, h, kv, hd, s = 2, 4, 2, 16, 32
    q = torch.randn((b, 1, h, hd), generator=g)
    k, v = torch.randn((b, s, kv, hd), generator=g), torch.randn((b, s, kv, hd), generator=g)
    qpos = torch.tensor([[28], [20]], dtype=torch.int32)
    kpos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    valid = qpos[:, 0] + 1
    m, lsum, o = L.attend_partial(q, k[:, :16], v[:, :16], qpos, kpos[:, :16], window=8,
                                  kv_valid_len=valid)
    assert bool((m[0] == torch.finfo(torch.float32).min).all())
    assert not bool(lsum[0].any()) and not bool(o[0].any())
    assert bool((lsum[1] > 0).all())
    one = ModelMesh(("data", "model"), {"data": 1, "model": 1}, 0, {"data": 0, "model": 0},
                    torch.device("cpu"), {})
    m, lsum, o = L.attend_partial(q, k, v, qpos, kpos, window=8, kv_valid_len=valid)
    got = L.combine_partials(m, lsum, o, one, "model", torch.float32)
    want = L.gqa_attention(q, k, v, qpos, kpos, window=8, kv_valid_len=valid)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))


# --------------------------------------------------------------------- (e)
@pytest.mark.parametrize("case", W.SAS_CASES, ids=[c[0] for c in W.SAS_CASES])
def test_sasrec_serving_matches_the_reference(runs, case):
    """The gathered scores against the reference's sharded step and the
    port's one-rank step."""
    want = runs["ref"]["sas"][case[0]]["scores"]
    one = runs["one"]["sas"][case[0]]["scores"]
    ranks = runs[W.world_of(case[2])]
    for got in ranks:
        res = got["sas"][case[0]]["scores"]
        assert res.shape == want.shape == one.shape
        np.testing.assert_allclose(res, want, rtol=0, atol=SAS_TOL * np.abs(want).max())
        np.testing.assert_allclose(res, one, rtol=0, atol=SAS_ONE_TOL * np.abs(one).max())
    _ranks_agree(ranks, "sas", case[0], "scores")


# --------------------------------------------------------------------- (f)
def test_cache_and_candidate_blocks_match_devices_indices_map(runs):
    """A rank's block of the decode cache (its sequence slice over "model")
    and of the retrieval candidates (every axis) is the one
    ``devices_indices_map`` gives the reference's device of the same
    linear index; the built steps use these specs."""
    for key, (shape, spec, mesh_shape) in W.BLOCK_CASES.items():
        mesh = rules.AbstractMesh(mesh_shape, ("data", "model"))
        for r, want in enumerate(runs["ref"]["blocks"][key]):
            coords = mesh_coords(r, ("data", "model"), mesh_shape)
            got = local_block(shape, rules.P(*spec), mesh, coords)
            assert tuple((s.start or 0, s.stop if s.stop is not None else n)
                         for s, n in zip(got, shape)) == want, (key, r)
    lm = replace(get_config("yi-6b"), model=_cfg("dense"))
    sas = replace(get_config("sasrec"), model=smoke_sasrec())
    for s, mesh in _FAKE.items():
        built = build_step(lm, ShapeSpec("d", "decode", seq_len=W.DECODE_SMAX,
                                         global_batch=W.DECODE_ROWS), mesh)
        want = rules.filter_spec(rules.P(*W.BLOCK_CASES[f"cache-{s[0]}x{s[1]}"][1]), mesh)
        assert [tuple(rules.entry_axes(e)) for e in built.in_specs[1]["k"]] == \
            [tuple(rules.entry_axes(e)) for e in want]
        built = build_step(sas, ShapeSpec("r", "retrieval", global_batch=1,
                                          n_candidates=W.SAS_CANDIDATES), mesh)
        assert tuple(built.in_specs[1]["candidates"]) == (("data", "model"),)
        assert tuple(built.out_specs) == (("data", "model"),)


def test_init_kv_cache_gives_the_rank_block():
    """On a mesh the zero cache is the rank's block of the decode cell's
    cache spec; positions that do not split over "model" raise."""
    cfg = _cfg("dense")
    lm = replace(get_config("yi-6b"), model=cfg)
    for s, mesh in _FAKE.items():
        built = build_step(lm, ShapeSpec("d", "decode", seq_len=W.DECODE_SMAX,
                                         global_batch=W.DECODE_ROWS), mesh)
        cache = tfm.init_kv_cache(cfg, W.DECODE_ROWS, W.DECODE_SMAX, "cpu", built.place)
        shape = (cfg.n_layers, W.DECODE_ROWS, W.DECODE_SMAX, cfg.n_kv_heads, cfg.head_dim)
        want = torch.zeros(shape)[local_block(shape, built.in_specs[1]["k"], mesh, mesh.coords)]
        assert tuple(cache["k"].shape) == tuple(want.shape) == tuple(cache["v"].shape)
        assert tfm.abstract_kv_cache(cfg, W.DECODE_ROWS, W.DECODE_SMAX,
                                     built.place)["k"].shape == cache["k"].shape
    with pytest.raises(ValueError, match="positions"):
        tfm.init_kv_cache(cfg, W.DECODE_ROWS, 31, "cpu", built.place)
