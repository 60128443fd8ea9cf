"""The continuous-batching LM engine on the CPU: the cases of
``tests/test_serve_engine.py`` against the reference's engine with the
reference's parameters (``params_from_reference``), and the port's repair
of fault R5: requests served together get the tokens each gets alone.

The reference's engine is right only while one request is live (it steps
every slot at one shared length), so it is compared only there. Logits
are float32 on both sides and agree within 2e-4 of their largest
magnitude (different summation orders); a greedy token is compared only
where its top two logits are further apart than that.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.lm_archs import smoke_lm as jsmoke_lm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.param import init_params as jinit_params  # noqa: E402
from repro.serve.engine import LMEngine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402

from repro_torch.configs.lm_archs import smoke_lm  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serve.engine import LMEngine, Request  # noqa: E402

TOL = 2e-4


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jsmoke_lm(moe=False), smoke_lm(moe=False)
    jp = jinit_params(jax.random.PRNGKey(2), jtfm.param_specs(jcfg))
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jp, cfg, tp


def _drain(engine, reqs):
    backlog, done, ticks = list(reqs), [], 0
    while (backlog or engine.n_live) and ticks < 200:
        while backlog and engine.submit(backlog[0]):
            backlog.pop(0)
        done += engine.tick()
        ticks += 1
    return done


def _margin_ok(logits_row, vocab):
    top2 = np.sort(np.asarray(logits_row)[:vocab])[-2:]
    return top2[1] - top2[0] > TOL * np.abs(logits_row).max()


def test_engine_serves_all_requests(setup):
    jcfg, jp, cfg, tp = setup
    engine = LMEngine(cfg, tp, n_slots=3, max_len=48, device="cpu")
    rng = np.random.default_rng(1)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, size=4), max_new=5) for _ in range(5)]
    done = _drain(engine, reqs)
    assert len(done) == 5 and engine.n_live == 0
    for r in done:
        assert len(r.out) == 5
        assert all(0 <= t < cfg.vocab for t in r.out)
    # the reference's engine serves the same backlog to the same counts
    rng = np.random.default_rng(1)
    jdone = _drain(JEngine(jcfg, jp, n_slots=3, max_len=48),
                   [JRequest(prompt=rng.integers(1, cfg.vocab, size=4), max_new=5)
                    for _ in range(5)])
    assert sorted(len(r.out) for r in jdone) == sorted(len(r.out) for r in done)


def test_engine_matches_prefill_argmax(setup):
    """The first generated token is the greedy argmax of a one-shot
    prefill of the prompt; the prefill logits equal the reference's."""
    jcfg, jp, cfg, tp = setup
    prompt = np.random.default_rng(7).integers(1, cfg.vocab, size=6)
    logits = tfm.make_prefill(cfg)(tp, {"tokens": torch.as_tensor(prompt)[None, :]})
    jlogits = jax.jit(jtfm.make_prefill(jcfg))(jp, {"tokens": jnp.asarray(prompt)[None, :]})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=TOL * np.abs(np.asarray(jlogits)).max())
    want = int(torch.argmax(logits[0, -1, : cfg.vocab]))

    engine = LMEngine(cfg, tp, n_slots=2, max_len=32, device="cpu")
    assert engine.submit(Request(prompt=prompt, max_new=1))
    (done,) = engine.tick()
    assert done.out[0] == want
    jengine = JEngine(jcfg, jp, n_slots=2, max_len=32)
    jengine.submit(JRequest(prompt=prompt, max_new=1))
    (jdone,) = jengine.tick()
    if _margin_ok(logits[0, -1].numpy(), cfg.vocab):
        assert jdone.out[0] == want


def _serve_alone(cfg, tp, prompt, max_new, n_slots=1):
    engine = LMEngine(cfg, tp, n_slots=n_slots, max_len=32, device="cpu")
    engine.submit(Request(prompt=prompt, max_new=max_new))
    out = []
    while engine.n_live:
        out += [r.out for r in engine.tick()]
    return out


def test_slot_reuse_is_clean(setup):
    """A new tenant in a freed slot does not see the old tenant's KV; the
    tokens are the reference's where their margins allow a comparison."""
    jcfg, jp, cfg, tp = setup
    rng = np.random.default_rng(9)
    prompt = rng.integers(1, cfg.vocab, size=5)
    ref_out = _serve_alone(cfg, tp, prompt, 3)

    reused = LMEngine(cfg, tp, n_slots=1, max_len=32, device="cpu")
    first = rng.integers(1, cfg.vocab, size=9)
    reused.submit(Request(prompt=first, max_new=2))
    while reused.n_live:
        reused.tick()
    reused.submit(Request(prompt=prompt, max_new=3))
    out2 = []
    while reused.n_live:
        out2 += [r.out for r in reused.tick()]
    assert ref_out == out2

    jengine = JEngine(jcfg, jp, n_slots=1, max_len=32)
    jengine.submit(JRequest(prompt=prompt, max_new=3))
    jout = []
    while jengine.n_live:
        jout += [r.out for r in jengine.tick()]
    full = np.concatenate([prompt, ref_out[0]])[None, :]
    logits = tfm.make_prefill(cfg)(tp, {"tokens": torch.as_tensor(full)})[0].numpy()
    for j, (got, want) in enumerate(zip(ref_out[0], jout[0])):
        if not _margin_ok(logits[len(prompt) - 1 + j], cfg.vocab):
            break  # later tokens follow a near-tie; nothing more to compare
        assert got == want


def test_concurrent_requests_equal_solo_runs(setup):
    """Fault R5's repair: four requests of prompt lengths 4–9, live
    together in 4 slots, each get the tokens they get alone, and the
    decode logits at every generated position match a prefill of the
    prompt plus the emitted tokens."""
    _, _, cfg, tp = setup
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab, size=p) for p in (4, 9, 6, 5)]
    engine = LMEngine(cfg, tp, n_slots=4, max_len=32, device="cpu")
    seen = []
    decode = engine._decode

    def recording(params, cache, batch):
        logits, cache = decode(params, cache, batch)
        seen.append((batch["active"].clone(), logits[:, 0].clone()))
        return logits, cache

    engine._decode = recording
    reqs = [Request(prompt=p, max_new=6) for p in prompts]
    for r in reqs:
        assert engine.submit(r)
    assert engine.n_live == 4
    while engine.n_live:
        engine.tick()
    prefill = tfm.make_prefill(cfg)
    for r in reqs:
        assert r.out == _serve_alone(cfg, tp, r.prompt, 6, n_slots=4)[0]
        # the decode logits of this slot, in order, at its generated positions
        rows = [lg[r.slot] for act, lg in seen if act[r.slot]][-6:]
        full = np.concatenate([r.prompt, r.out[:-1]])[None, :]
        want = prefill(tp, {"tokens": torch.as_tensor(full)})[0, len(r.prompt) - 1:]
        got = torch.stack(rows)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=TOL * float(want.abs().max()))
