"""The reference against the port on small graphs on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

from bgvbench.reference import fa2 as ref_fa2
from bgvbench.reference import prng as ref_prng
from bgvbench.reference import raster as ref_raster
from bgvbench.reference import scoda as ref_scoda
from bgvbench.reference import supergraph as ref_sg


def graph(n=3000, k=30, seed=1):
    from repro_torch.graph.generators import planted_partition

    return planted_partition(n, k, 0.04, 0.0008, seed=seed)[0]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_uniform_draw_is_the_ports_bitwise(seed):
    from repro_torch.core import prng

    want = prng.uniform(prng.key(seed), (4096, 2), -1000.0, 1000.0, torch.float32)
    assert torch.equal(ref_prng.uniform_f32(seed, (4096, 2), -1000.0, 1000.0), want)


@pytest.mark.parametrize("block", [256, 1024])
def test_scoda_labels_are_the_ports_bitwise(block):
    from repro_torch.core.scoda import ScodaConfig, detect_communities
    from repro_torch.graph.utils import pad_edges

    e = graph()
    delta = ref_sg.mode_degree(e, 3000)
    want, _ = detect_communities(torch.as_tensor(pad_edges(e, len(e), 3000)), 3000,
                                 ScodaConfig(degree_threshold=delta, block_size=block))
    got = ref_scoda.detect(torch.as_tensor(e), 3000, delta, 4, block)
    assert torch.equal(got, want.long())


@pytest.mark.parametrize("cap", [256, 4096])  # 256 overflows the capacity
def test_supergraph_sizes_modularity_groups_are_the_ports(cap):
    import repro_torch

    n, e = 3000, graph(seed=2)
    delta = ref_sg.mode_degree(e, n)
    cfg = repro_torch.default_config(n, len(e), delta, iterations=2)
    cfg = dataclasses.replace(cfg, scoda=dataclasses.replace(cfg.scoda, block_size=512),
                              s_cap=512, max_super_edges=cap)
    res = repro_torch.biggraphvis(e, n, cfg, stream=repro_torch.StreamConfig(chunk_size=2048),
                                  device="cpu")
    et = torch.as_tensor(e)
    labels, live = ref_sg.dense(ref_scoda.detect(et, n, delta, 4, 512))
    assert np.array_equal(labels.numpy(), res.labels) and live == res.n_supernodes
    sizes = ref_sg.cms_sizes(labels, ref_sg.degrees(et, n), live, 512, 4,
                             max(256, len(e) // 1000), 0x5EED)
    assert np.array_equal(sizes.numpy(), res.sizes)
    a, b, w, count = ref_sg.superedges(et, labels, 512, cap, 2048)
    sg = res.supergraph
    assert count == int(sg.n_superedges)
    assert np.array_equal(a.numpy(), sg.edges[:, 0].numpy())
    assert np.array_equal(b.numpy(), sg.edges[:, 1].numpy())
    assert np.array_equal(w.numpy(), sg.weights.numpy())
    assert ref_sg.modularity(et, labels) == pytest.approx(res.modularity, abs=1e-6)
    assert np.array_equal(ref_sg.color_groups(sizes).numpy(), res.groups)


@pytest.mark.parametrize("repulsion,radii", [("exact", True), ("grid", False)])
def test_layout_follows_the_ports_for_a_few_iterations(repulsion, radii):
    from repro_torch.core import forceatlas2 as fa2

    n, e = 3000, graph(seed=3)
    mass = torch.as_tensor(np.bincount(e.reshape(-1), minlength=n) + 1.0,
                           dtype=torch.float32)
    w = torch.ones(len(e))
    cfg = fa2.FA2Config(iterations=4, repulsion=repulsion, use_radii=radii, seed=11)
    want, want_trace, _ = fa2.layout(torch.as_tensor(e), w, mass, n, cfg, device="cpu")
    lay = ref_fa2.Layout(torch.as_tensor(e), w, mass, n, iterations=4, kr=80.0, kg=1.0,
                         tau=1.0, repulsion=repulsion, use_radii=radii)
    got, trace = lay.run(ref_prng.uniform_f32(11, (n, 2), -1000.0, 1000.0))
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-4 * scale
    assert np.allclose(trace.numpy()[:, :2], want_trace.double().numpy()[:, :2], rtol=1e-4)


def test_picture_is_the_ports_image():
    import repro_torch

    n, e = 3000, graph(seed=4)
    cfg = repro_torch.default_config(n, len(e), ref_sg.mode_degree(e, n), iterations=10)
    res = repro_torch.biggraphvis(e, n, cfg, device="cpu")
    image, _ = res.render()
    sg = res.supergraph
    got = ref_raster.picture(res.positions, res.sizes, res.groups, sg.edges[:, 0].numpy(),
                             sg.edges[:, 1].numpy(), sg.weights.numpy())
    assert np.array_equal(got, image)
