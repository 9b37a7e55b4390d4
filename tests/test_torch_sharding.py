"""The port's placement table and the LM zoo on a data x model mesh
(``repro_torch.sharding``), on the CPU.

* Exact placement parity with ``repro.sharding.rules``: every registered
  arch but paper-DQN at full width (the port's params on ``meta``, the
  reference's shapes from ``jax.eval_shape``) at model sizes 1, 2, 7 and
  16, leaf by leaf; ``tests/test_sharding.py``'s cases (dense, MoE, the
  divisibility fallback, the tuple-path detection); every cache leaf
  against ``cache_shardings`` (the port's per-layer caches against the
  reference's stacked leaves, the layer dim dropped); the batch against
  ``data_shardings``; and on 256- and 512-rank ``FakeStore`` groups the
  production meshes' ``shardings_for`` against the reference's.
* Gloo parity: one group of 4 spawned ranks (data 2 x model 2) runs the
  tensor- and data-parallel transformer on reduced granite-8b (kv heads
  split; one kv head, inside one kv group; 3 kv heads, repeated per query
  head) and reduced qwen2-moe-a2.7b, and both again with ``cfg.remat``:
  each rank's logits, the loss, the gradient norm and the full gradient
  against the JAX package on the same params (``forward`` per data shard,
  ``jax.grad`` of the shards' mean ``lm_loss``: the MoE routed per data
  shard, as on the mesh), and against the one-process port as a second
  witness, within f32 tolerances stated below; and
  ``moe_block_distributed`` on each data rank's rows against the JAX
  ``moe_block`` of that shard at its local capacity, aux averaged.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_arch, list_archs  # noqa
from repro_torch import convert  # noqa: E402
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import multichip, steps  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import clip_scale  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.context import mesh_shape  # noqa: E402

ARCHS = [a for a in list_archs() if a != "paper-dqn"]
MODEL_SIZES = (1, 2, 7, 16)
#: f32 gates of the gloo parity against the one-process port (observed:
#: logits 3.8e-6, gradients 1.6e-7, loss and norm 4.8e-7 on 4 ranks)
LOGIT_ATOL, GRAD_ATOL, SCALAR_RTOL = 2e-5, 2e-6, 1e-5
#: and against the JAX package: the one-process JAX tests' f32 gates
#: (``test_torch_transformer.py``'s logits, ``test_torch_autograd.py``'s
#: gradients relative to each leaf's largest entry, the scalars';
#: observed: logits 5.2e-6, gradients 2.2e-6 of the leaf's largest, loss
#: 1.5e-7 and norm 3.5e-8 relative)
JAX_LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
JAX_GRAD_RTOL, JAX_SCALAR_RTOL = 1e-4, 1e-5


def _spec(p, ndim):
    """A PartitionSpec as the port's spec tuple (padded with None)."""
    t = tuple(p)
    return t + (None,) * (ndim - len(t))


_JAX_PARAMS = {}


def _jax_params(arch):
    if arch not in _JAX_PARAMS:
        cfg = jget_arch(arch)
        model = jget_model(cfg)
        tree = jax.eval_shape(lambda k: model.init(k, cfg),
                              jax.random.PRNGKey(0))
        _JAX_PARAMS[arch] = (cfg, jax.tree_util.tree_flatten_with_path(
            tree)[0])
    return _JAX_PARAMS[arch]


@pytest.mark.parametrize("model_size", MODEL_SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, model_size):
    jcfg, flat = _jax_params(arch)
    port = steps.abstract_params(get_arch(arch))
    specs = rules.param_specs(port, get_arch(arch),
                              {"data": 16, "model": model_size})
    want = {".".join(jrules._path_names(p)): (leaf, jrules.param_spec(
        p, leaf, jcfg, model_size=model_size)) for p, leaf in flat}
    assert set(specs) == set(want)
    for name, (leaf, spec) in want.items():
        assert tuple(port[name].shape) == tuple(leaf.shape), name
        assert specs[name] == _spec(spec, leaf.ndim), name


def _reduced_specs(arch, model_size):
    cfg = reduced(get_arch(arch))
    return rules.param_specs(steps.abstract_params(cfg), cfg,
                             {"data": 1, "model": model_size})


def test_dense_param_specs():
    specs = _reduced_specs("granite-8b", 2)
    assert specs["embed"] == ("model", None)          # vocab 512 % 2 == 0
    assert specs["blocks.attn.wq"] == (None, None, "model", None)
    assert specs["blocks.mlp.w_gate"] == (None, None, "model")
    assert specs["blocks.mlp.w_down"] == (None, "model", None)
    assert specs["blocks.attn_norm"] == (None, None)  # replicated


def test_moe_param_specs():
    specs = _reduced_specs("mixtral-8x7b", 2)
    # stacked (L, E, d, f): shard f
    assert specs["blocks.mlp.w_gate"] == (None, None, None, "model")
    assert specs["blocks.mlp.w_down"] == (None, None, "model", None)
    assert specs["blocks.mlp.router"] == (None, None, None)


def test_divisibility_fallback():
    """A model size that divides nothing yields full replication."""
    for name, s in _reduced_specs("granite-8b", 7).items():
        assert all(x is None for x in s), (name, s)


def test_stack_vs_tuple_path_detection():
    # xlstm params are tuple-of-blocks (digit in path) -> no stack offset
    keys = [k for k in _reduced_specs("xlstm-125m", 2) if "w_up" in k]
    assert keys and all(any(part.isdigit() for part in k.split("."))
                        for k in keys)
    assert rules._is_stacked(["blocks", "attn"])
    assert not rules._is_stacked(["blocks", "0", "mlp"])


def _ref_cache_path(cfg, path):
    """(the JAX cache leaf's path, stacked on a layer dim) of the port's
    per-layer cache leaf at ``path``."""
    if cfg.family == "encdec":
        return (path[0],) + path[2:], True
    if cfg.family == "hybrid":
        P = len(cfg.rglru.block_pattern)
        i, j = divmod(int(path[0]), P)
        if i < cfg.num_layers // P:
            return ("periods", str(j)) + path[1:], True
        return ("rem", str(j)) + path[1:], False
    if cfg.family == "ssm":
        return path, False
    return path[1:], True


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flatten(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flatten(v, path + (str(i),))]
    return [(path, tree)]


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("model_size", MODEL_SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, model_size, shape_name):
    """Every cache leaf (kv: the stationary rule, kv heads or head_dim;
    recurrent states; xLSTM cells) against ``cache_shardings``."""
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = {"data": 16, "model": model_size}
    jmesh = AbstractMesh((16, model_size), ("data", "model"))
    jc = jax.eval_shape(lambda: jget_model(jcfg).init_cache(
        jcfg, shape.global_batch, shape.seq_len))
    jsh = jrules.cache_shardings(jc, jcfg, jmesh)
    want = {tuple(jrules._path_names(p)): (leaf.shape, sh.spec)
            for (p, leaf), sh in zip(jax.tree_util.tree_flatten_with_path(
                jc)[0], jax.tree.leaves(jsh))}
    caches = steps.abstract_caches(cfg, shape)
    specs = rules.cache_specs(caches, mesh)
    for path, t in _flatten(caches):
        ref_path, stacked = _ref_cache_path(cfg, path)
        ref_shape, ref_spec = want[ref_path]
        ref = _spec(ref_spec, len(ref_shape))
        assert tuple(t.shape) == tuple(ref_shape[1:] if stacked
                                       else ref_shape), path
        got = specs
        for key in path:
            got = got[key if isinstance(got, dict) else int(key)]
        assert got == (ref[1:] if stacked else ref), path


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ["granite-8b", "whisper-large-v3"])
def test_batch_specs_match_reference(arch, shape_name):
    jmesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    spec_in = steps.input_specs(get_arch(arch), INPUT_SHAPES[shape_name])
    jin = jsteps.input_specs(jget_arch(arch), JSHAPES[shape_name])
    assert {k: tuple(v.shape) for k, v in spec_in.items()} == \
        {k: tuple(v.shape) for k, v in jin.items()}
    want = jrules.data_shardings(jin, jmesh)
    got = rules.data_specs(spec_in, mesh_shape(
        {"pod": 2, "data": 16, "model": 16}))
    for k, sh in want.items():
        assert got[k] == _spec(sh.spec, len(jin[k].shape)), k


def _fake_group(world):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shardings_match_reference(multi_pod):
    """The 16 x 16 (2 x 16 x 16) production mesh on a FakeStore group of
    256 (512) ranks: ``shardings_for`` placements of granite-8b and
    qwen2-moe-a2.7b (params, Adam state, caches' kv leaves, batch) equal
    the reference's NamedShardings read as placements. No compute runs."""
    from torch.distributed.tensor import Replicate
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _fake_group(int(np.prod(shape)))
    try:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device_type="cpu")
        assert mesh.mesh_dim_names == axes
        assert tuple(mesh.mesh.shape) == shape
        with pytest.raises(ValueError, match="production mesh"):
            mesh_lib.make_production_mesh(multi_pod=not multi_pod,
                                          device_type="cpu")
        jmesh = AbstractMesh(shape, axes)
        for arch, sname in (("granite-8b", "train_4k"),
                            ("qwen2-moe-a2.7b", "decode_32k")):
            p, o, c, b = steps.shardings_for(
                get_arch(arch), mesh, INPUT_SHAPES[sname], with_opt=True)
            jp, jo, jc, jb = jsteps.shardings_for(
                jget_arch(arch), jmesh, JSHAPES[sname], with_opt=True)
            port_abs = steps.abstract_params(get_arch(arch))
            for path, sh in jax.tree_util.tree_flatten_with_path(jp)[0]:
                name = ".".join(jrules._path_names(path))
                want = rules.placements(
                    _spec(sh.spec, port_abs[name].ndim), mesh)
                assert p[name] == want and o["mu"][name] == want, name
            assert o["step"] == [Replicate()] * len(axes)
            for k, sh in jb.items():
                want = rules.placements(
                    _spec(sh.spec, len(steps.input_specs(
                        get_arch(arch), INPUT_SHAPES[sname])[k].shape)),
                    mesh)
                assert b[k] == want, k
            if c is not None:
                assert c[0]["k"] == rules.placements(
                    _spec(jc["k"].spec, 5)[1:], mesh)
    finally:
        mesh_lib.destroy_local_group()


def test_host_mesh_clamps_and_refuses(tmp_path):
    mesh_lib.init_local_group(0, 1, str(tmp_path / "store"))
    try:
        mesh = mesh_lib.make_host_mesh(4, 8)          # clamped to (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="production mesh"):
            mesh_lib.make_production_mesh()
    finally:
        mesh_lib.destroy_local_group()
    with pytest.raises(RuntimeError, match="initialised process group"):
        mesh_lib.make_host_mesh(1, 1)


# -- the gloo group: data 2 x model 2 ------------------------------------------------

MOE_X = np.random.default_rng(3).standard_normal((4, 8, 256)).astype(
    np.float32)
CASES = [dict(arch="granite-8b", batch=4, seq=16),
         dict(arch="granite-8b", batch=4, seq=16,
              overrides=dict(num_kv_heads=1)),
         dict(arch="granite-8b", batch=4, seq=16,
              overrides=dict(num_heads=6, num_kv_heads=3, head_dim=32)),
         dict(arch="qwen2-moe-a2.7b", batch=4, seq=16, moe_x=MOE_X),
         # cfg.remat: each block is recomputed in the backward, between
         # the model group's collectives and the MoE's data mean
         dict(arch="granite-8b", batch=4, seq=16, overrides=dict(remat=True)),
         dict(arch="qwen2-moe-a2.7b", batch=4, seq=16,
              overrides=dict(remat=True))]


def _case_inputs(case):
    """The case's config, full params and batch, drawn as every gloo rank
    draws them (:func:`repro_torch.launch.multichip.lm_mesh_case`)."""
    cfg = dataclasses.replace(reduced(get_arch(case["arch"])),
                              **case.get("overrides", {}))
    gen = torch.Generator().manual_seed(0)
    full = transformer.stack_params(transformer.init(cfg, generator=gen,
                                                     device="cpu"))
    toks = torch.randint(0, cfg.vocab_size, (case["batch"], case["seq"] + 1),
                         generator=gen)
    return cfg, full, toks[:, :-1], toks[:, 1:]


def _one_process(case, dp=2):
    """The one-process port on the case's params and batch: logits of each
    data shard's rows, and the loss (the MoE routed per data shard, its aux
    averaged over the shards, as on the mesh), its gradient and norm."""
    cfg, full, tokens, labels = _case_inputs(case)
    rows = case["batch"] // dp
    logits = []

    def loss(p, _):
        nll, aux_sum = 0.0, 0.0
        for s in range(dp):
            lg, _, aux = transformer.forward(p, cfg,
                                             tokens[s * rows:(s + 1) * rows])
            logits.append(lg.detach())
            logp = torch.log_softmax(lg.to(torch.float32), dim=-1)
            nll = nll - logp.gather(
                -1, labels[s * rows:(s + 1) * rows, :, None]).sum()
            aux_sum = aux_sum + aux
        return nll / labels.numel() + aux_sum / dp

    val, grads = value_and_grad(loss, full, None)
    _, gnorm = clip_scale(grads, 1.0)
    return cfg, full, dict(logits=logits[:dp], loss=float(val),
                           grad_norm=float(gnorm), grads=grads)


def _jax_reference(case, dp=2):
    """The JAX package on the same params (the ``stack_params`` dict is
    the JAX leaf structure: ``convert.params_to_numpy``) and batch: ``forward``'s logits of each data shard's rows, and the
    loss of the whole batch with the MoE routed per data shard, its aux
    averaged over the shards — every label is valid and each shard holds
    as many, so that is the mean of the shards' ``lm_loss`` — with its
    ``jax.grad`` and the gradient's global norm."""
    cfg, full, tokens, labels = _case_inputs(case)
    jcfg = dataclasses.replace(jreduced(jget_arch(case["arch"])),
                               **case.get("overrides", {}))
    jp = jax.tree.map(jnp.asarray, convert.params_to_numpy(full))
    rows = case["batch"] // dp
    shards = [(jnp.asarray(tokens[s * rows:(s + 1) * rows].numpy()),
               jnp.asarray(labels[s * rows:(s + 1) * rows].numpy()))
              for s in range(dp)]
    val, g = jax.value_and_grad(lambda p: sum(
        japi.lm_loss(p, jcfg, t, lb) for t, lb in shards) / dp)(jp)
    grads = {k: v.numpy() for k, v in
             convert.params_from_numpy(g, device="cpu").items()}
    gnorm = np.sqrt(sum(np.sum(np.square(v.astype(np.float64)))
                        for v in grads.values()))
    logits = [np.asarray(jtransformer.forward(jp, jcfg, t)[0])
              for t, _ in shards]
    return dict(logits=logits, loss=float(val), grad_norm=float(gnorm),
                grads=grads)


@pytest.fixture(scope="module")
def gloo_rows():
    return multichip.run_lm_parity(CASES, data=2, model=2)


@pytest.mark.parametrize("ci", range(len(CASES)))
def test_mesh_transformer_matches_jax(gloo_rows, ci):
    """Each rank's logits, the step's loss and gradient norm and every
    gathered gradient of the tensor- and data-parallel port against the
    JAX package on the same params, per data shard."""
    want = _jax_reference(CASES[ci])
    for rank_rows in gloo_rows:
        row = rank_rows[ci]
        np.testing.assert_allclose(row["logits"],
                                   want["logits"][row["data_rank"]],
                                   **JAX_LOGIT_TOL)
        assert abs(row["loss"] - want["loss"]) <= JAX_SCALAR_RTOL * want[
            "loss"]
        assert (abs(row["grad_norm"] - want["grad_norm"])
                <= JAX_SCALAR_RTOL * want["grad_norm"])
        assert set(row["grads"]) == set(want["grads"])
        for k, g in want["grads"].items():
            err = float(np.abs(row["grads"][k] - g).max())
            assert err <= JAX_GRAD_RTOL * max(float(np.abs(g).max()),
                                              1e-30), (k, err)


@pytest.mark.parametrize("ci", range(len(CASES)))
def test_mesh_transformer_matches_one_process(gloo_rows, ci):
    case = CASES[ci]
    _cfg, _full, want = _one_process(case)
    for rank_rows in gloo_rows:
        row = rank_rows[ci]
        ref = want["logits"][row["data_rank"]].numpy()
        np.testing.assert_allclose(row["logits"], ref, rtol=0,
                                   atol=LOGIT_ATOL)
        assert abs(row["loss"] - want["loss"]) <= SCALAR_RTOL * want["loss"]
        assert (abs(row["grad_norm"] - want["grad_norm"])
                <= SCALAR_RTOL * want["grad_norm"])
        for k, g in want["grads"].items():
            np.testing.assert_allclose(row["grads"][k], g.numpy(), rtol=0,
                                       atol=GRAD_ATOL, err_msg=k)
    # the model axis really split the heads, the MLP and the vocab
    split = gloo_rows[0][ci]["split"]
    assert split["blocks.attn.wq"] and split["embed"]
    assert split["blocks.attn.wk"] == (case.get("overrides", {}).get(
        "num_kv_heads", 4) % 2 == 0)


def test_moe_block_distributed_matches_jax_per_shard(gloo_rows):
    """Each data rank's ``moe_block_distributed`` (experts split over the
    model axis) equals the JAX ``moe_block`` of its shard at the shard's
    own capacity; the aux is the mean over the shards on every rank."""
    ci = next(i for i, c in enumerate(CASES) if "moe_x" in c)
    cfg, full, _ = _one_process(CASES[ci])
    jcfg = jreduced(jget_arch(CASES[ci]["arch"]))
    p = {k.split(".", 2)[2]: v[0].numpy() for k, v in full.items()
         if k.startswith("blocks.mlp.")}
    jp = {k: v for k, v in p.items() if "." not in k}
    jp["shared"] = {k.split(".")[1]: v for k, v in p.items()
                    if k.startswith("shared.")}
    rows = MOE_X.shape[0] // 2
    ys, auxes = [], []
    for s in range(2):
        y, aux = jmoe.moe_block(jp, jcfg, MOE_X[s * rows:(s + 1) * rows])
        ys.append(np.asarray(y))
        auxes.append(float(aux))
    for rank_rows in gloo_rows:
        row = rank_rows[ci]
        want = ys[row["data_rank"]]
        # the experts' outputs reach ~1e3 (C7's expert scale): f32 ulps
        # of the largest value, as the sparse-vs-dense gate counts them
        np.testing.assert_allclose(row["moe_y"], want, rtol=0,
                                   atol=4e-6 * np.abs(want).max())
        assert abs(row["moe_aux"] - np.mean(auxes)) <= 1e-6
