"""The control, at a CPU test's size: the reference's floating-point stages
in bfloat16 put in the program's place come out not correct under each
cell's limits, while the program's own outputs come out correct."""
import pytest
import torch

from bgvbench import program as program_mod
from conftest import PICTURE_CELL


@pytest.mark.parametrize("cell", ["graph500.fa2_full", PICTURE_CELL])
def test_control_fails_and_program_passes(tiny, cell):
    w = tiny.workload(cell)
    config, mix = tiny.config(w["config"]), tiny.mix(w["traffic"])
    config["pipeline"]["iterations"] = 100  # the cells' own layout length
    gen = tiny.generator(config["graph"]["generator"])
    edges = gen.generate(config["graph"], 2**31 + 5)
    dev = torch.device("cpu")
    unit = tiny.unit(mix["unit"])(program_mod.load(), config, mix, edges,
                                  gen.nodes(config["graph"]), 2**31 + 5, dev)
    digest = unit.run()["digest"]
    unit.release()
    ref = unit.reference(dev)
    limits = tiny.limits(cell)
    program = unit.compare([digest], ref)
    assert all(program[k] <= lim for k, lim in limits.items()), program
    control = unit.compare([digest], ref, **unit.control(ref, dev))
    failed = [k for k, lim in limits.items() if control[k] > lim]
    assert failed, control
