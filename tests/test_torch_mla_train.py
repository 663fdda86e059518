"""Port parity of MLA training: the deepseek-v3 cut's expanded MLA path
(``models/mla.py`` without a cache: every projection, ``wkv_b`` included,
through TimeFloats ``dense``, so its backward runs the transposed read)
against the JAX reference's train step on the CPU.

Vehicle: reduced deepseek-v3 with both layers dense (``first_k_dense=2``,
``dense_d_ff=256``), as tests/test_torch_mla.py builds it, f32
activations, TimeFloats ``mode="separable"``. Parameters cross from the
reference through ``convert.from_jax_params``, batches through numpy. The
reference runs once per module (a fixture): three steps of plain,
unclipped SGD at a constant rate, so its step-0 gradients read back as
(p0 - p1) / LR. Tolerances and their reasons are tests/test_torch_train.py's:
loss within 1e-3 relative, per-leaf gradient cosine > 0.999 (attention,
norms and softmax sum in another order than XLA, and an ulp can move a
5-bit code).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import to_numpy  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_for_smoke as jreduced  # noqa: E402
from repro.core.timefloats import TFConfig as JTF  # noqa: E402
from repro.data.pipeline import DataPipeline as JPipeline  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get_config, reduced_for_smoke  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core.timefloats import TFConfig  # noqa: E402
from repro_torch.optim.optimizers import OptimizerConfig  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

LOSS_RTOL = 1e-3
GRAD_COSINE = 0.999
LR = 0.1


def _cut(cfg, base, tf):
    return dataclasses.replace(
        base(cfg), n_layers=2, tf=tf, dtype="float32",
        moe=dataclasses.replace(base(cfg).moe, first_k_dense=2,
                                dense_d_ff=256))


def _opt(cls):
    return cls(name="sgd", lr=LR, schedule="constant", momentum=0.0,
               grad_clip=1e9)


@pytest.fixture(scope="module")
def reference():
    """Reference params from PRNGKey(0), three batches, and three steps of
    the reference's jitted train step: the losses and the step-0
    gradients read back from the SGD update."""
    cj = _cut(jget_config("deepseek-v3-671b"), jreduced,
              JTF(mode="separable"))
    jcfg = jstep.TrainConfig(optimizer=_opt(jopt.OptimizerConfig))
    params = to_numpy(jax.jit(lambda k: JM.init(cj, k))(
        jax.random.PRNGKey(0)))
    jparams = jax.tree.map(jnp.asarray, params)
    state = jstep.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        opt=jopt.make_optimizer(jcfg.optimizer).init(jparams),
        rng=jax.random.PRNGKey(1))
    pipe = JPipeline(cj, 2, 32, seed=0, kind="lm")
    batches = [to_numpy(pipe.batch_at(i)) for i in range(3)]
    step_fn = jax.jit(jstep.make_train_step(cj, jcfg))
    losses = []
    for b in batches:
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
        if len(losses) == 1:
            grads = jax.tree.map(
                lambda p0, p1: (np.float64(p0) - np.float64(p1)) / LR,
                params, to_numpy(state.params))
    ct = _cut(get_config("deepseek-v3-671b"), reduced_for_smoke,
              TFConfig(mode="separable"))
    return {"cfg": ct, "params": params, "batches": batches,
            "losses": losses, "grads": grads}


def _batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / max(float(a.norm() * b.norm()), 1e-300))


def test_vehicle_is_the_dense_mla_cut(reference):
    ct = reference["cfg"]
    assert ct.mla is not None and ct.layer_kinds() == ("dense", "dense")
    assert not ct.tie_embeddings and ct.tf.mode == "separable"
    params = from_jax_params(reference["params"], ct, "cpu")
    assert "wkv_b" in params["layers"][0]["mixer"]


def test_step0_loss_and_grads_match_reference(reference):
    """The step-0 loss within 1e-3 relative and every leaf's gradient at
    cosine > 0.999 to the one the reference's step applied."""
    ct = reference["cfg"]
    params = from_jax_params(reference["params"], ct, "cpu")
    metrics, grads = tstep.loss_and_grads(ct, params,
                                          _batch(reference["batches"][0]))
    want0 = reference["losses"][0]
    assert abs(float(metrics["loss"]) - want0) <= LOSS_RTOL * abs(want0)
    want = from_jax_params(reference["grads"], ct, "cpu")
    for (path, g), w in zip(tree_lib.leaves_with_path(grads),
                            tree_lib.leaves(want)):
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), path
        cos = _cosine(g, w)
        assert cos > GRAD_COSINE, f"{tree_lib.path_str(path)}: cosine {cos}"


def test_three_steps_track_reference(reference):
    ct = reference["cfg"]
    params = from_jax_params(reference["params"], ct, "cpu")
    tcfg = tstep.TrainConfig(optimizer=_opt(OptimizerConfig))
    st = tstep.TrainState(
        step=0, params=params,
        opt=tstep.make_optimizer(tcfg.optimizer).init(params),
        generator=torch.Generator().manual_seed(1))
    step_fn = tstep.make_train_step(ct, tcfg)
    for i, b in enumerate(reference["batches"]):
        st, m = step_fn(st, _batch(b))
        want = reference["losses"][i]
        assert abs(float(m["loss"]) - want) <= LOSS_RTOL * abs(want), (
            i, float(m["loss"]), want)
        assert bool(torch.isfinite(m["grad_norm"]))
    assert st.step == 3 and step_fn.graphs.counts == {"train_step[2x32]": 1}


@pytest.mark.parametrize("graphs", ["--no-graphs", "--graphs"])
def test_train_launcher_graph_flag_on_cpu(graphs, capsys):
    """The launcher trains on the CPU with graphs off; asked for graphs on
    the CPU, it exits non-zero before training."""
    from repro_torch.launch import train

    argv = ["--device", "cpu", "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "16", "--log-every", "1", graphs]
    if graphs == "--graphs":
        with pytest.raises(SystemExit) as e:
            train.main(argv)
        assert e.value.code != 0
        assert "CUDA" in capsys.readouterr().err
        return
    assert train.main(argv) == 0
    out = capsys.readouterr().out
    assert "step     1 loss" in out and "graphs=off" in out
