"""The outputs check catches a broken timed path: each fault is planted
under the harness at a CPU test's size and the run must come out not
correct. The cells run on one card, so no exchange between cards can be
left out. The picture faults run on the test's own picture cell, since no
cell of BENCHMARK.json runs the picture unit yet."""
import time
from types import SimpleNamespace

import numpy as np
import pytest

from bgvbench import harness
from bgvbench import program as program_mod
from conftest import PICTURE_CELL


def run(tiny, cell, program=None, seconds=0.1):
    return harness.run_cell(cell, 2**31 + 21, seconds, False, t0=time.perf_counter(),
                            device="cpu", disc=tiny, program=program)


def test_control_run_is_correct(tiny):
    assert run(tiny, PICTURE_CELL)["correct"]


@pytest.mark.parametrize("cell", [PICTURE_CELL, "graph500.fa2_full"])
def test_layout_step_returning_its_state_unchanged(tiny, cell, monkeypatch):
    from repro_torch.core import forceatlas2 as fa2

    real = fa2._apply_speed

    def frozen(state, f, mass, cfg):
        _, row = real(state, f, mass, cfg)
        return state, row

    monkeypatch.setattr(fa2, "_apply_speed", frozen)
    assert not run(tiny, cell)["correct"]


def test_detection_block_returning_its_state_unchanged(tiny, monkeypatch):
    from repro_torch.core import scoda

    monkeypatch.setattr(scoda, "_block_update", lambda state, block, **kw: state)
    out = run(tiny, PICTURE_CELL)
    assert not out["correct"] and out["compared"]["labels"]["value"] > 0


def test_half_of_each_chunk_left_out(tiny, monkeypatch):
    from repro_torch.core import stream

    real = stream.sanitize_edges

    def half(edges, n):
        out = real(edges, n).clone()
        out[1::2] = n  # every other edge to the trash node
        return out

    monkeypatch.setattr(stream, "sanitize_edges", half)
    assert not run(tiny, PICTURE_CELL)["correct"]


def test_half_of_the_attraction_left_out(tiny, monkeypatch):
    from repro_torch.core import forceatlas2 as fa2

    real = fa2._attraction_sorted

    def half(pos, dst, w, layout):
        keep = w.clone()
        keep[1::2] = 0
        return real(pos, dst, keep, layout)

    monkeypatch.setattr(fa2, "_attraction_sorted", half)
    assert not run(tiny, "graph500.fa2_full")["correct"]


def altered_program(which: str):
    real = program_mod.load()

    def biggraphvis(*args, **kw):
        res = real.biggraphvis(*args, **kw)
        if which == "label":
            res.labels = res.labels.copy()
            res.labels[0] += 1
        elif which == "position":
            res.positions = res.positions.copy()
            res.positions *= np.float32(1.5)
        elif which == "pixel":
            render = res.render

            def altered(*a, **k):
                image, stats = render(*a, **k)
                image = image.copy()
                image[0, 0] = 255 - image[0, 0]
                return image, stats

            res.render = altered
        return res

    def layout(*args, **kw):
        pos, trace, iters = real.layout(*args, **kw)
        pos = pos.clone()
        pos *= 1.5
        return pos, trace, iters

    return SimpleNamespace(**{**vars(real), "biggraphvis": biggraphvis, "layout": layout})


@pytest.mark.parametrize("which", ["label", "position", "pixel"])
def test_picture_answer_altered_where_it_is_produced(tiny, which):
    out = run(tiny, PICTURE_CELL, altered_program(which))
    assert not out["correct"]


def test_layout_answer_altered_where_it_is_produced(tiny):
    assert not run(tiny, "graph500.fa2_full", altered_program("position"))["correct"]


def test_an_answer_that_differs_between_units_is_caught(tiny, monkeypatch):
    real = program_mod.load()
    calls = []

    def biggraphvis(*args, **kw):
        res = real.biggraphvis(*args, **kw)
        calls.append(1)
        if len(calls) == 2:  # the warm-up is call 1, the window's first is call 2
            res.positions = res.positions + np.float32(1.0)
        return res

    clock = iter(range(10**6))  # a clock that moves 0.1 s a reading: several units
    monkeypatch.setattr(harness, "time", SimpleNamespace(perf_counter=lambda: 0.1 * next(clock)))
    out = run(tiny, PICTURE_CELL,
              SimpleNamespace(**{**vars(real), "biggraphvis": biggraphvis}), seconds=1.0)
    assert out["attempted"] >= 2
    assert not out["correct"] and out["compared"]["units_differ"]["value"] >= 1
