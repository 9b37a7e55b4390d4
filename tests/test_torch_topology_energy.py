"""The port's energy model, topologies and numpy mixing helpers against
the JAX package's, exactly (float64 joules; float32 σ built from the same
integer-valued sums)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import consensus as jcons  # noqa: E402
from repro.core import energy as jen  # noqa: E402
from repro.core import multitask as jmt  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro import comms as jcomms  # noqa: E402
from repro_torch.comms import codecs  # noqa: E402
from repro_torch.core import consensus, energy, multitask, topology  # noqa: E402

K = 16


def _pair(name):
    if name == "small_world":
        return (topology.small_world(K, k=4, seed=1),
                jtopo.small_world(K, k=4, seed=1))
    return topology.make(name, K), jtopo.make(name, K)


@pytest.mark.parametrize("regime", ["table1", "fig3", "fig4", "swapped",
                                    "no_sidelink"])
def test_energy_equations_exact(regime):
    def params(mod):
        if regime == "table1":
            return mod.PAPER_TABLE_I
        if regime == "swapped":
            return mod.swap_ul_sl(mod.paper_calibrated("fig3"))
        if regime == "no_sidelink":
            return dataclasses.replace(mod.paper_calibrated("fig4"),
                                       sidelink_available=False)
        return mod.paper_calibrated(regime)

    p, jp = params(energy), params(jen)
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    assert p.E0_C == jp.E0_C and p.Ek_C == jp.Ek_C
    for t0 in (0, 1, 42, 210):
        assert energy.maml_energy(p, t0, 3) == jen.maml_energy(jp, t0, 3)
    cl, jcl = topology.clusters(1, 2), jtopo.clusters(1, 2)
    for t in (1, 17, 400):
        assert energy.fl_energy(p, t) == jen.fl_energy(jp, t)
        for codec in (None, "int8", "int8:b64", "bf16", "topk:0.05"):
            assert energy.fl_energy(p, t, cl, codec) == \
                jen.fl_energy(jp, t, jcl, codec)
            assert energy.fl_comm_energy(p, t, None, codec) == \
                jen.fl_comm_energy(jp, t, None, codec)
    tis = [12, 30, 7, 55, 3, 19]
    assert energy.total_energy(p, 210, 3, tis, cl, "int4") == \
        jen.total_energy(jp, 210, 3, tis, jcl, "int4")
    table = {0: [90] * 6, 42: [30] * 6, 132: [12] * 6}
    assert energy.optimize_split(p, 3, table) == jen.optimize_split(jp, 3, table)
    assert dataclasses.asdict(energy.from_grad_per_joule()) == \
        dataclasses.asdict(jen.from_grad_per_joule())


@pytest.mark.parametrize("name", jtopo.FAMILIES)
def test_topologies_match(name):
    ours, theirs = _pair(name)
    np.testing.assert_array_equal(ours.adjacency, theirs.adjacency)
    np.testing.assert_array_equal(ours.link_class, theirs.link_class)
    assert ours.links_per_round() == theirs.links_per_round()
    assert ours.max_degree == theirs.max_degree
    assert ours.is_connected() == theirs.is_connected()
    assert ours.is_symmetric == theirs.is_symmetric
    p, jp = energy.paper_calibrated("fig3"), jen.paper_calibrated("fig3")
    for codec in (None, "int8", "int8:b64", "bf16"):
        assert ours.round_comm_joules(p, codec=codec) == \
            theirs.round_comm_joules(jp, codec=codec)
        assert ours.round_comm_joules(p, 1e6, codecs.resolve_codec(codec)) \
            == theirs.round_comm_joules(jp, 1e6, jcomms.resolve_codec(codec))
    eff = np.where(ours.adjacency, np.arange(K * K).reshape(K, K) % 5 * 1e5,
                   0.0)
    assert ours.with_edge_efficiency(eff).round_comm_joules(p, codec="int8") \
        == theirs.with_edge_efficiency(eff).round_comm_joules(jp,
                                                              codec="int8")


@pytest.mark.parametrize("name", ["ring", "cluster", "small_world"])
def test_mixing_and_sparse_structure_exact(name, monkeypatch):
    ours, theirs = _pair(name)
    sig = ours.mixing()
    assert sig.dtype == np.float32
    np.testing.assert_array_equal(sig, np.asarray(theirs.mixing()))
    np.testing.assert_array_equal(ours.mixing(include_self=False),
                                  np.asarray(theirs.mixing(include_self=False)))
    sizes = np.arange(1, K + 1, dtype=np.float32)
    np.testing.assert_allclose(ours.mixing(sizes),
                               np.asarray(theirs.mixing(sizes)), rtol=1e-6)
    # metropolis rows sum unequal addends, so the order may differ by an ulp
    np.testing.assert_allclose(ours.mixing(kind="metropolis"),
                               np.asarray(theirs.mixing(kind="metropolis")),
                               rtol=0, atol=1e-7)
    for a, b in zip(consensus.sparse_structure(sig),
                    jcons.sparse_structure(np.asarray(theirs.mixing()))):
        np.testing.assert_array_equal(a, b)
    # the port's floor was measured on the card (PERF.md); the
    # reference's rule with the port's floor picks what the port picks
    monkeypatch.setattr(jcons, "SPARSE_GATHER_FLOOR",
                        consensus.SPARSE_GATHER_FLOOR)
    for codec in (None, "int8", "int8:b64", "bf16"):
        assert consensus.auto_path(sig, codecs.resolve_codec(codec)) == \
            jcons.auto_path(sig, jcomms.resolve_codec(codec))


def test_consensus_helpers_match(monkeypatch):
    # the floor moved in the port only, set from the H100's rows
    # (repro_torch.launch.consensus_scale; PERF.md): the first f32
    # row where the sparse plan wins is the 12-ring, K·H = 24
    assert consensus.SPARSE_GATHER_FLOOR == 24
    assert jcons.SPARSE_GATHER_FLOOR == 512
    monkeypatch.setattr(jcons, "SPARSE_GATHER_FLOOR",
                        consensus.SPARSE_GATHER_FLOOR)
    for hops in (1, 2):
        np.testing.assert_array_equal(consensus.ring_adjacency(9, hops),
                                      jcons.ring_adjacency(9, hops))
    np.testing.assert_array_equal(consensus.full_adjacency(5),
                                  jcons.full_adjacency(5))
    w = np.random.default_rng(0).uniform(0, 1, (8, 8)).astype(np.float32)
    np.fill_diagonal(w, 0)
    np.testing.assert_allclose(consensus.mixing_weights(np.ones(8), w),
                               np.asarray(jcons.mixing_weights(np.ones(8), w)),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="metropolis"):
        consensus.mixing_weights(np.ones(3), np.eye(3, dtype=bool), "metro")
    for name in ("ring", "full", "star"):
        m = topology.make(name, 64).mixing()
        assert consensus.auto_path(m) == jcons.auto_path(m)


def test_cluster_network_matches():
    net = multitask.ClusterNetwork(6, 2, (0, 1, 5))
    jnet = jmt.ClusterNetwork(6, 2, (0, 1, 5))
    assert (net.K, net.Q) == (jnet.K, jnet.Q)
    np.testing.assert_array_equal(net.adjacency(), jnet.adjacency())
    np.testing.assert_array_equal(net.topology().adjacency,
                                  jnet.topology().adjacency)
    np.testing.assert_array_equal(net.cluster_topology().adjacency,
                                  jnet.cluster_topology().adjacency)
    assert net.neighbors_of(3) == jnet.neighbors_of(3)
    reg = multitask.TaskRegistry()
    reg.add(multitask.TaskSpec("b"))
    reg.add(multitask.TaskSpec("a"))
    assert reg.names() == ["a", "b"] and len(reg) == 2


def test_topology_validation():
    A = np.zeros((3, 3), bool)
    A[0, 0] = True
    with pytest.raises(ValueError, match="self loops"):
        topology.Topology("bad", A, A.astype(np.int8))
    with pytest.raises(ValueError):
        topology.small_world(8, k=3)
    with pytest.raises(ValueError):
        topology.make("cluster", 10, devices_per_cluster=4)
