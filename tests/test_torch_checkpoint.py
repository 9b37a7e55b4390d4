"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's on-disk format: a file the port saves restores in the JAX
package bit for bit, and the reverse, for LM params (``blocks`` stacked on
the layer axis), an Adam state, a bf16 leaf (f32 on disk) and the
federated population with its error-feedback residuals; the manager's
step directories, ``meta.json`` and retention; and
``convert.lm_params_to_numpy``, the inverse of ``lm_params_from_numpy``."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import checkpoint, optim  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy, params_from_numpy)
from repro_torch.launch.train import init_params  # noqa: E402
from repro_torch.models import transformer  # noqa: E402


def _jax_params(arch="granite-8b", num_layers=3):
    cfg = jreduced(jget_arch(arch), num_layers=num_layers)
    return jtransformer.init(jax.random.PRNGKey(0), cfg)


def _leaves_equal(jtree, tree):
    """Every JAX leaf equals the port's leaf of the same dotted path."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    assert len(flat) == len(tree)
    for path, leaf in flat:
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        got = tree[name]
        want = np.asarray(leaf)
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32), err_msg=name)


def test_port_checkpoint_restores_in_jax(tmp_path):
    jp = _jax_params()
    params = params_from_numpy(jp, device="cpu")
    params["final_norm"] = params["final_norm"].to(torch.bfloat16)
    path = str(tmp_path / "port")
    checkpoint.save_pytree(path, params)
    with np.load(path + ".npz") as data:
        assert "blocks/attn/wq" in data.files
        assert data["blocks/attn/wq"].shape == (3,) + jp["blocks"]["attn"][
            "wq"].shape[1:]
        assert data["final_norm"].dtype == np.float32        # bf16 → f32
    like = jax.tree.map(lambda x: x, jp)
    like["final_norm"] = like["final_norm"].astype(jnp.bfloat16)
    restored = jckpt.restore_pytree(path, like)
    assert restored["final_norm"].dtype == jnp.bfloat16
    _leaves_equal(restored, params)


def test_jax_checkpoint_restores_in_port(tmp_path):
    jp = _jax_params()
    path = str(tmp_path / "jax")
    jckpt.save_pytree(path, jp)
    like = init_params(reduced(get_arch("granite-8b"), num_layers=3),
                       torch.Generator().manual_seed(1), "cpu")
    restored = checkpoint.restore_pytree(path, like)
    assert set(restored) == set(like)
    assert all(restored[k].dtype == like[k].dtype for k in like)
    _leaves_equal(jp, restored)


def test_adam_state_crosses_both_ways(tmp_path):
    jp = _jax_params(num_layers=2)
    jst = joptim.adam(1e-3).init(jp)
    g = jax.tree.map(lambda x: jnp.ones_like(x) * 0.5, jp)
    _, jst = joptim.adam(1e-3).update(g, jst, jp)
    jckpt.save_pytree(str(tmp_path / "j"), jst)
    params = params_from_numpy(jp, device="cpu")
    like = optim.adam(1e-3).init(params)
    st = checkpoint.restore_pytree(str(tmp_path / "j"), like)
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 1
    _leaves_equal(jst["mu"], st["mu"])
    _leaves_equal(jst["nu"], st["nu"])
    checkpoint.save_pytree(str(tmp_path / "p"), st)
    back = jckpt.restore_pytree(str(tmp_path / "p"), jst)
    assert int(back["step"]) == 1
    _leaves_equal(back["nu"], st["nu"])


def test_manager_steps_meta_and_retention(tmp_path):
    """The twin of ``tests/test_system.py::test_checkpoint_roundtrip_with_
    trainer``, with retention: 3 kept of 4 saves, the latest restored."""
    cfg = reduced(get_arch("granite-8b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cm = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=3)
    for step in (5, 10, 15, 20):
        cm.save(step, {"params": {k: v + step for k, v in params.items()}},
                metadata={"loss": 1.0 / step})
    assert cm.steps() == [10, 15, 20]
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000010", "step_00000015", "step_00000020"]
    with open(tmp_path / "step_00000020" / "meta.json") as f:
        assert json.load(f) == {"step": 20, "loss": 0.05}
    restored, step = cm.restore({"params": params})
    assert step == 20
    for k, v in params.items():
        assert torch.equal(restored["params"][k], v + 20)
    older, step = cm.restore({"params": params}, step=10)
    assert step == 10 and torch.equal(older["params"]["embed"],
                                      params["embed"] + 10)
    # the JAX manager reads the port's directory
    jm = jckpt.CheckpointManager(str(tmp_path))
    jrest, jstep = jm.restore({"params": _jax_params(num_layers=2)})
    assert jstep == 20
    _leaves_equal(jrest["params"], {k: v + 20 for k, v in params.items()})


def test_manager_restore_of_empty_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        checkpoint.CheckpointManager(str(tmp_path)).restore({})


def test_federated_population_round_trip_with_ef_state(tmp_path):
    """A (K, L, ...) population and its residuals: bit for bit through the
    port, and readable by the JAX manager into its own stacked tree."""
    cfg = reduced(get_arch("granite-8b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    K = 4
    pop = {k: torch.stack([v + i for i in range(K)]) for k, v in
           params.items()}
    ef = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(1))
          for k, v in pop.items()}
    cm = checkpoint.CheckpointManager(str(tmp_path))
    cm.save(3, {"params": pop, "codec_state": ef})
    state, _ = cm.restore({"params": pop, "codec_state": ef})
    for k in pop:
        assert torch.equal(state["params"][k], pop[k])
        assert torch.equal(state["codec_state"][k], ef[k])
    jpop = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (K,) + x.shape),
                        _jax_params(num_layers=2))
    jstate, _ = jckpt.CheckpointManager(str(tmp_path)).restore(
        {"params": jpop, "codec_state": jpop})
    _leaves_equal(jstate["params"], pop)
    _leaves_equal(jstate["codec_state"], ef)


@pytest.mark.parametrize("arch,num_layers", [
    ("granite-8b", 3), ("qwen2-moe-a2.7b", 2), ("recurrentgemma-9b", 5),
    ("recurrentgemma-9b", 7)])
def test_lm_params_to_numpy_inverts_from_numpy(arch, num_layers):
    """The JAX tree → the port's state dict → back: the same tree
    structure (tuples, None) and every leaf bit for bit; and the module's
    ``stack_params`` equals ``params_from_numpy`` of that tree."""
    cfg = reduced(get_arch(arch), num_layers=num_layers)
    jcfg = jreduced(jget_arch(arch), num_layers=num_layers)
    jmod = jrglru if cfg.rglru is not None else jtransformer
    jp = jmod.init(jax.random.PRNGKey(0), jcfg)
    sd = lm_params_from_numpy(jp, cfg, device="cpu")
    back = lm_params_to_numpy(sd, cfg)
    a, ta = jax.tree_util.tree_flatten(jp)
    b, tb = jax.tree_util.tree_flatten(back)
    assert ta == tb
    assert all(np.array_equal(np.asarray(x), y) for x, y in zip(a, b))
    if cfg.rglru is None:
        model = transformer.init(cfg, device="cpu")
        model.load_state_dict(sd)
        assert np.all([np.array_equal(np.asarray(x), y) for x, y in zip(
            a, jax.tree_util.tree_leaves(lm_params_to_numpy(model, cfg)))])
        stacked = transformer.stack_params(model)
        want = params_from_numpy(jp, device="cpu")
        assert set(stacked) == set(want)
        assert all(torch.equal(stacked[k], want[k]) for k in want)


@pytest.mark.parametrize("arch", ["granite-8b", "recurrentgemma-9b",
                                  "whisper-large-v3", "xlstm-125m"])
def test_lm_params_from_numpy_refuses_a_tree_of_another_depth(arch):
    """Each family's ``jax_name`` rule places every leaf: a 3-layer JAX
    tree read as a 2-layer model raises (a stacked leaf's layer axis, the
    hybrid's periods, xLSTM's extra tuple entry), where slicing a leaf's
    first axis would pass without an error."""
    from repro.models.api import get_model as jget_model
    jcfg = jreduced(jget_arch(arch), num_layers=3)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    lm_params_from_numpy(jp, reduced(get_arch(arch), num_layers=3),
                         device="cpu")
    with pytest.raises(ValueError):
        lm_params_from_numpy(jp, reduced(get_arch(arch), num_layers=2),
                             device="cpu")
