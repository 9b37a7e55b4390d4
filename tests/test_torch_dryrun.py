"""The port's dry run (A17) and its H100 pricing, on the CPU.

* ``RooflineTerms``, ``single_chip_terms`` and ``gpu_energy_params``
  given the JAX package's ``TPU_V5E`` constants ``==`` the reference's
  (the port holds no TPU constant; the same formulas);
* ``probes``' analytic xLSTM terms ``==`` the reference's for every arch
  and shape; ``subquadratic`` / ``is_decoder`` ``==`` for every arch;
* ``collective_bytes`` and ``square_buffers`` on hand-made records;
* in ONE spawned process (so no fake process group leaks into this
  worker), each task starting and tearing down its own ``FakeStore``
  group:
  - every reduced LM family x {train, prefill, decode} on a fake data 2 x
    model 2 group: a dense model's FLOPs ``==`` an analytic count of its
    matmuls and kernel work, and the transformer's model-axis collective
    bytes ``==`` the Megatron count;
  - a reduced dense config's FLOPs against the JAX package's
    ``cost_analysis()`` of its ``lower_step`` on a one-device
    (``data``, ``model``) mesh with ``unroll_layers=True``, within
    :data:`XLA_BAND`;
  - granite-8b x train_4k at full size on the fake 16 x 16 group: it
    fits in 80 GB and ``model_flops / FLOPs`` lies in [0.6, 1.0];
  - ``dry_run_sharded`` (K = 4096 on 8 ranks) and ``dry_run_distributed``
    (K = 8) with no violation;
  - the ``consensus_volume`` twin at reduced width on a fake data 4 x
    model 2 group: the ring ships 2·b(its shard) per device a round, bf16
    half of f32, and the joules ``==`` the reference's
    ``round_comm_joules``.
"""
import concurrent.futures
import dataclasses
import multiprocessing as mp

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import InputShape as JInputShape  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.launch import probes as jprobes  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch.configs import (INPUT_SHAPES, InputShape, get_arch,  # noqa
                                 list_archs, reduced)
from repro_torch.core import energy  # noqa: E402
from repro_torch.kernels import work  # noqa: E402
from repro_torch.launch import consensus_volume, dryrun, multichip  # noqa
from repro_torch.launch import probes  # noqa: E402
from repro_torch.launch.hlo_analysis import (collective_bytes,  # noqa: E402
                                             square_buffers)
from repro_torch.analysis.costmodel import Collective  # noqa: E402

ARCHS = [a for a in list_archs() if a != "paper-dqn"]
#: the reduced step shapes of the fake-group runs
SHAPES = {"train": InputShape("t", 32, 4, "train"),
          "prefill": InputShape("p", 32, 4, "prefill"),
          "decode": InputShape("d", 32, 4, "decode")}
FAMILIES = {"granite-8b": {}, "qwen2-moe-a2.7b": {},
            "recurrentgemma-9b": {"num_layers": 5}, "xlstm-125m": {},
            "whisper-large-v3": {}}
#: the port's counted FLOPs against XLA's: the eager count has no
#: elementwise flops, B4 counts its visible pairs where XLA's attention
#: computes every (query, key) pair, and the plain backward of B4
#: recomputes its forward; at this size the matmuls dominate
XLA_BAND = 0.15


# -- pricing -------------------------------------------------------------------


def _terms(mod, **kw):
    return mod.RooflineTerms(flops=3.1e15, hbm_bytes=2.7e12,
                             collective_bytes=4.4e10, chips=256, **kw)


def test_roofline_terms_equal_reference_on_tpu_constants():
    tpu = jenergy.TPU_V5E
    kw = dict(peak_flops=tpu["peak_flops_bf16"], hbm_bw=tpu["hbm_bw"],
              link_bw=tpu["ici_bw"])
    got, want = _terms(energy, **kw), _terms(jenergy)
    for name in ("t_compute", "t_memory", "t_collective", "bottleneck",
                 "step_time"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.energy_per_step(tpu["chip_power"], tpu["host_pue"]) == \
        want.energy_per_step()
    one, jone = (energy.single_chip_terms(got),
                 jenergy.single_chip_terms(want))
    assert (one.chips, one.collective_bytes, one.step_time) == (
        jone.chips, jone.collective_bytes, jone.step_time)
    fields = dataclasses.asdict
    assert fields(energy.gpu_energy_params(got, 3.3e10, chip=tpu)) == \
        fields(jenergy.tpu_energy_params(want, 3.3e10))
    assert fields(energy.gpu_energy_params(got, 3.3e10, chip=tpu,
                                           B_i=7)) == \
        fields(jenergy.tpu_energy_params(want, 3.3e10, B_i=7))


def test_h100_constants_and_links():
    h = energy.H100_SXM
    assert (h["peak_flops_bf16"], h["hbm_bw"], h["hbm_bytes"],
            h["nvlink_bw"], h["ib_bw"], h["chip_power"]) == (
        989.4e12, 3.35e12, 80e9, 450e9, 50e9, 700.0)
    t = _terms(energy)
    assert t.peak_flops == 989.4e12 and t.link_bw == h["ib_bw"]
    p = energy.gpu_energy_params(t, 1e9, chip_power=650.0)
    assert p.P_device == 650.0 and p.P_datacenter == 650.0 * 256
    assert energy.link_bw(8) == 450e9 and energy.link_bw(9) == 50e9


# -- the small helpers ---------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_properties_equal_reference(arch):
    assert get_arch(arch).subquadratic == jget_arch(arch).subquadratic
    assert get_arch(arch).is_decoder == jget_arch(arch).is_decoder


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_probe_formulas_equal_reference(arch, shape):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    s = INPUT_SHAPES[shape]
    js = JInputShape(s.name, s.seq_len, s.global_batch, s.mode)
    assert probes.slstm_recurrent_flops(cfg, s, 256) == \
        jprobes.slstm_recurrent_flops(jcfg, js, 256)
    assert probes.mlstm_intra_flops(cfg, s) == \
        jprobes.mlstm_intra_flops(jcfg, js)
    assert probes.ssm_analytic_correction(cfg, s) == \
        jprobes.ssm_analytic_correction(jcfg, js)


def _rec(kind, shape, dtype="float32", elem=4):
    return Collective(kind, f"{dtype}{list(shape)}",
                      int(np.prod(shape)) * elem, frozenset({dtype}))


def test_collective_bytes_by_reference_names():
    recs = [("model", _rec("allreduce_", (4, 8))),
            ("model", _rec("allgather_", (2, 4, 8))),
            ("data", _rec("_allgather_base_", (16,), "int8", 1)),
            ("data", _rec("send", (3,))), ("data", _rec("recv_", (3,))),
            ("data", _rec("reduce_scatter_", (5,))),
            ("data", _rec("alltoall_base_", (6,)))]
    assert collective_bytes(recs) == {
        "all-reduce": 128, "all-gather": 256 + 16, "reduce-scatter": 20,
        "all-to-all": 24, "collective-permute": 12}
    with pytest.raises(ValueError, match="barrier"):
        collective_bytes([_rec("barrier", (1,))])


def test_square_buffers():
    shapes = {("float32", (4096, 4096)), ("float32", (4096, 64)),
              ("bfloat16", (8192, 8192)), ("float32", (100, 100)),
              ("int8", (4096, 4096, 2))}
    assert square_buffers(shapes, 4096) == [
        ("bfloat16", 8192, 8192 * 8192 * 2),
        ("float32", 4096, 4096 * 4096 * 4)]
    assert square_buffers(shapes, 10000) == []


def test_kernel_work_counts():
    assert work.visible_pairs(4, 4, True, 0) == 10
    assert work.visible_pairs(4, 4, True, 2) == 7
    assert work.visible_pairs(2, 5, False, 0) == 10
    assert work.flash_attention(1, 4, 4, 2, 1, 8, causal=True, window=0,
                                elem=2) == (2 * (2 * 4 * 2 * 8 + 2 * 4 * 8),
                                            4 * 8 * 10 * 2)
    assert work.rglru_scan(2, 3, 4, with_h0=False) == (12 * 24 + 4 * 8,
                                                       3 * 24)


def test_kernels_on_meta_launch_nothing_and_report_work():
    from repro_torch.kernels import ops
    seen = []
    before = (ops.flash_attention.launches, ops.rglru_scan.launches)
    q = torch.empty(2, 8, 4, 16, device="meta")
    k = torch.empty(2, 8, 2, 16, device="meta")
    with work.counting(lambda *a: seen.append(a)):
        out = ops.flash_attention(q, k, k, causal=True, window=4)
        h, last = ops.rglru_scan(torch.empty(2, 8, 6, device="meta"),
                                 torch.empty(2, 8, 6, device="meta"))
    assert out.shape == q.shape and out.device.type == "meta"
    assert h.shape == (2, 8, 6) and last.shape == (2, 6)
    assert last.dtype == torch.float32
    assert (ops.flash_attention.launches, ops.rglru_scan.launches) == before
    nb, fl = work.flash_attention(2, 8, 8, 4, 2, 16, causal=True, window=4,
                                  elem=4)
    assert seen == [("flash_attention", fl, nb),
                    ("rglru_scan", 3 * 96, 12 * 96 + 4 * 12)]
    with pytest.raises(ValueError, match="tensors on"):
        cpu = torch.empty(2, 8, 2, 16)
        ops.flash_attention(q, cpu, cpu)


# -- the spawned process: fake groups ------------------------------------------


@pytest.fixture(scope="module")
def pool():
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=mp.get_context("spawn")) as ex:
        yield ex


@pytest.fixture(scope="module")
def family_reports(pool):
    cases = [(arch, SHAPES[m], over) for arch, over in FAMILIES.items()
             for m in ("train", "prefill", "decode")]
    return dict(zip([(a, s.mode) for a, s, _ in cases],
                    pool.submit(dryrun.reduced_reports, cases).result()))


def _dense_flops(cfg, shape):
    """Analytic FLOPs of reduced granite's step on the whole mesh: 2 a
    multiply-add of every projection, MLP and unembedding matmul (x3 in
    training: the forward and two backward products), B4's count of its
    visible pairs, its backward B4′'s (five products per visible pair),
    and at decode the plain attention over the cache (2 products)."""
    d, L, V, f = cfg.d_model, cfg.num_layers, cfg.vocab_size, cfg.d_ff
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    B, S = shape.global_batch, shape.seq_len
    proj = 2 * d * (2 * H * hd + 2 * K * hd) + 3 * 2 * d * f
    if shape.mode == "train":
        kern = work.flash_attention(B, S, S, H, K, hd, causal=True,
                                    window=0, elem=4)[1]
        bwd = work.flash_attention_backward(B, S, S, H, K, hd, causal=True,
                                            window=0, elem=4)[1]
        return 3 * B * S * (L * proj + 2 * d * V) + L * (kern + bwd)
    if shape.mode == "prefill":
        kern = work.flash_attention(B, S, S, H, K, hd, causal=True,
                                    window=0, elem=4)[1]
        return B * S * L * proj + L * kern + B * 2 * d * V
    return B * (L * proj + 2 * d * V) + L * 2 * 2 * B * H * S * hd


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_dense_flops_equal_analytic_count(family_reports, mode):
    cfg = reduced(get_arch("granite-8b"))
    r = family_reports[("granite-8b", mode)]
    assert r["flops"] == _dense_flops(cfg, SHAPES[mode])
    assert r["chips"] == 4 and r["mesh"] == "2x2"


def test_transformer_collectives_equal_megatron_count(family_reports):
    """Per device, over the model axis: two all-reduces of the (B/2, S, d)
    activations a layer forward (attention, MLP) and two backward (their
    f), the embedding's reduce, the unembedding's f in the backward, the
    gradient norm's scalar; the logits' all-gather (B/2, S, V)."""
    cfg = reduced(get_arch("granite-8b"))
    s = SHAPES["train"]
    act = s.global_batch // 2 * s.seq_len * cfg.d_model * 4
    want_ar = 4 * cfg.num_layers * act + act + act + 4
    want_ag = s.global_batch // 2 * s.seq_len * cfg.vocab_size * 4
    r = family_reports[("granite-8b", "train")]
    model = r["collectives_by_axis"]["model"]
    assert model == {"all-reduce": 4 * want_ar, "all-gather": 4 * want_ag}
    # the data axis: every gradient shard, the valid-label count, the loss
    assert "all-reduce" in r["collectives_by_axis"]["data"]


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_every_family_dry_runs(family_reports, arch):
    for mode in ("train", "prefill", "decode"):
        r = family_reports[(arch, mode)]
        assert r["flops"] > 0 and r["hbm_bytes"] > 0
        assert r["bytes_per_device"] > 0 and r["fits"]
        assert r["roofline"]["step_time"] > 0
        if mode != "decode" and arch != "xlstm-125m":
            assert r["kernel_calls"], (arch, mode)   # B3 / B4 counted


def test_flops_against_xla_cost_analysis(pool):
    """Reduced granite's train step: the port's count on the fake 2 x 2
    group against XLA's ``cost_analysis()`` of the reference's step on one
    device, every layer unrolled (so no scan body is counted once)."""
    shape = InputShape("t", 32, 4, "train")
    got = pool.submit(dryrun.reduced_reports,
                      [("granite-8b", shape, {})]).result()[0]["flops"]
    jcfg = dataclasses.replace(jreduced(jget_arch("granite-8b")),
                               unroll_layers=True)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    ca = jsteps.lower_step(jcfg, mesh, JInputShape(
        "t", 32, 4, "train")).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    want = float(ca["flops"])
    assert abs(got - want) <= XLA_BAND * want, (got, want)


def test_granite_train_4k_on_the_production_mesh(pool):
    from repro_torch.launch.roofline import model_flops
    r = pool.submit(dryrun.production_report, "granite-8b",
                    "train_4k").result()
    assert r["mesh"] == "16x16" and r["chips"] == 256
    assert r["fits"], r["bytes_per_device"]
    ratio = model_flops("granite-8b", "train_4k") / r["flops"]
    assert 0.6 <= ratio <= 1.0, ratio
    assert abs(model_flops("granite-8b", "train_4k") - 5.19e16) < 0.01e16
    # both axes span HGX nodes: every collective at InfiniBand
    assert set(r["axis_link_bw"].values()) == {energy.H100_SXM["ib_bw"]}


def test_consensus_dry_runs_have_no_violation(pool):
    sharded = pool.submit(multichip.dry_run_sharded, 4096,
                          verbose=False).result()
    dist_ = pool.submit(multichip.dry_run_distributed, 8,
                        verbose=False).result()
    assert sharded["violations"] == [] and dist_["violations"] == []
    assert sharded["square_buffers"] == []
    assert "int8" in sharded["wire_dtypes"] and "int8" in dist_["wire_dtypes"]
    assert dist_["collectives"]["collective-permute"] > 0


def test_consensus_volume_twin(pool):
    rows = {r["name"]: r for r in pool.submit(
        consensus_volume.reduced_rows).result()}
    cfg = reduced(get_arch("granite-8b"))
    from repro_torch.launch.steps import abstract_params
    from repro_torch.sharding import rules
    from repro_torch.sharding.parallel import local_shape
    p = abstract_params(cfg)
    specs = rules.param_specs(p, cfg, {"data": 4, "model": 2})
    shard = sum(int(np.prod(local_shape(tuple(v.shape), specs[k],
                                        {"model": 2}))) * 4
                for k, v in p.items())
    f32, bf16 = rows["ring_consensus_f32"], rows["ring_consensus_bf16"]
    assert f32["per_device_bytes"] == 2 * shard
    assert 2 * bf16["per_device_bytes"] == f32["per_device_bytes"]
    assert rows["fedavg_allreduce"]["per_device_bytes"] == shard
    p_cal = jenergy.paper_calibrated("fig3")
    for name, codec in (("ring_consensus_f32", None),
                        ("ring_consensus_bf16", "bf16")):
        assert rows[name]["joules"] == jtopo.ring(4).round_comm_joules(
            p_cal, model_bits=cfg.param_count() * 32.0, codec=codec)


# -- the multichip CLI and the agent-mesh parity -------------------------------


def test_multichip_default_refuses_without_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit, match="--backend nccl needs one card"):
        multichip.main(["--world", "2"])


def test_multichip_gloo_says_h1_did_not_run(tmp_path, capsys):
    import json
    out = tmp_path / "mc.json"
    multichip.main(["--world", "2", "--backend", "gloo", "--out", str(out)])
    report = json.loads(out.read_text())
    assert report["backend"] == "gloo" and "h1" not in report
    assert "did not run" in report["h1_not_run"]
    assert "H1 did not run" in capsys.readouterr().out
    assert all(row["ok"] for row in report["parity"])


def test_parity_mesh_vs_emulation_on_eight_ranks():
    """``parity_mesh_vs_emulation`` (its ranks build their mesh with
    ``agent_mesh(8)``) on a gloo group of 8."""
    out = multichip.parity_mesh_vs_emulation(32, num_blocks=8,
                                             verbose=False)
    assert out["violations"] == []
    rows = out["rows"]
    assert {r["rank"] for r in rows} == set(range(8))
    assert {(r["plan"], r["K"], r["positions"]) for r in rows} == {
        ("sharded", 32, 8), ("distributed", 8, 8)}
    assert all(r["bit_equal"] for r in rows if r["plan"] == "sharded")
