"""The training step's compile discipline on the CPU: one step program per
batch shape (``StepGraphs(capture=False)`` runs it eagerly here; on the
card it is a captured CUDA graph), state updated in place in the step's
buffers as under the reference's donated jit, and the step's f32 scalars
made on the host.

The oracle is the functional step the port ran before (every optimizer
builds its whole new moment and parameter trees, the clipped gradients are
a copy, the rate is a tensor made inside the step), written out below as
it was. The buffered step must equal it bitwise over 3 steps: losses,
grad norms, every parameter and optimizer leaf, and the rounding
generator's state. Vehicle: reduced qwen3-0.6b at f32, TimeFloats
``mode="pallas"`` (K1/K2's plain versions on the CPU), ``remat="full"``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, reduced_for_smoke  # noqa: E402
from repro_torch.core import float8  # noqa: E402
from repro_torch.core.timefloats import TFConfig  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402
from repro_torch.optim.optimizers import OptimizerConfig  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

B, S, STEPS = 4, 16, 3


def _cfg():
    return dataclasses.replace(reduced_for_smoke(get_config("qwen3-0.6b")),
                               dtype="float32", remat="full",
                               tf=TFConfig(mode="pallas"))


CASES = {
    "adamw": dict(opt=dict(name="adamw", lr=1e-3, warmup=2, total_steps=5,
                           weight_decay=0.1)),
    "sgd_momentum": dict(opt=dict(name="sgd", lr=1e-2, warmup=1,
                                  total_steps=5, momentum=0.9)),
    "adafactor": dict(opt=dict(name="adafactor", lr=1e-2, warmup=2,
                               total_steps=5)),
    "adamw_accum2": dict(opt=dict(name="adamw", lr=1e-3, warmup=2,
                                  total_steps=5), accum=2),
    "insitu_sr": dict(opt=dict(name="adamw", lr=1e-2, warmup=1,
                               total_steps=5, insitu=TFConfig(),
                               stochastic_rounding=True)),
}


def _tcfg(case):
    kw = CASES[case]
    return tstep.TrainConfig(optimizer=OptimizerConfig(**kw["opt"]),
                             accum=kw.get("accum", 1))


# -- the oracle: the functional step as the port ran it before --------------

def _oracle_update(cfg, grads, state, params, step, gen):
    sched = schedules.get(cfg.schedule, cfg.lr, cfg.warmup, cfg.total_steps)
    f32 = lambda t: t.to(torch.float32)  # noqa: E731
    tm = tree_lib.tree_map
    lr = sched(step)
    if cfg.name == "sgd":
        if cfg.momentum:
            delta = tm(lambda m, g: cfg.momentum * m + f32(g), state["mom"],
                       grads)
            state = {"mom": delta}
        else:
            delta = tm(f32, grads)
        new = tm(lambda p, d: (f32(p) - lr * d).to(p.dtype), params, delta)
    elif cfg.name == "adamw":
        t = torch.tensor(step + 1.0, dtype=torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32), t)
        bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32), t)
        m = tm(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * f32(g), state["m"],
               grads)
        v = tm(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * torch.square(f32(g)),
               state["v"], grads)

        def upd(p, m, v):
            step_ = lr * (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if cfg.weight_decay and p.ndim >= 2:
                step_ = step_ + lr * cfg.weight_decay * f32(p)
            return (f32(p) - step_).to(p.dtype)

        new, state = tm(upd, params, m, v), {"m": m, "v": v}
    else:
        decay = 1.0 - torch.pow(torch.tensor(step + 1.0, dtype=torch.float32),
                                -0.8)

        def upd(p, g, s):
            g = f32(g)
            g2 = torch.square(g) + 1e-30
            if p.ndim >= 2:
                vr = decay * s["vr"] + (1 - decay) * g2.mean(dim=-1)
                vc = decay * s["vc"] + (1 - decay) * g2.mean(dim=-2)
                denom = torch.clamp_min(vr.mean(dim=-1, keepdim=True), 1e-30)
                vhat = vr[..., None] * vc[..., None, :] / denom[..., None]
                u, ns = g / (torch.sqrt(vhat) + 1e-30), {"vr": vr, "vc": vc}
            else:
                v = decay * s["v"] + (1 - decay) * g2
                u, ns = g / (torch.sqrt(v) + 1e-30), {"v": v}
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            return (f32(p) - lr * (u / torch.clamp_min(rms, 1.0))).to(
                p.dtype), ns

        out = tm(upd, params, grads, state["fac"])
        new = tm(lambda _, o: o[0], params, out)
        state = {"fac": tm(lambda _, o: o[1], params, out)}
    if cfg.insitu is not None:
        g = gen if cfg.stochastic_rounding else None
        new = tm(lambda x: x if x.ndim < 2 else float8.quantize_scaled(
            x, cfg.insitu.fmt, generator=g), new)
    return new, state


def _oracle_step(mcfg, tcfg, state, batch):
    a = tcfg.accum
    if a == 1:
        metrics, grads = tstep.loss_and_grads(mcfg, state.params, batch)
    else:
        gsum = msum = None
        for i in range(a):
            m, g = tstep.loss_and_grads(
                mcfg, state.params, {k: v[i::a] for k, v in batch.items()})
            gsum = g if gsum is None else tree_lib.tree_map(torch.add, gsum,
                                                            g)
            m = {k: m[k].to(torch.float32) for k in tstep.METRIC_KEYS}
            msum = m if msum is None else {k: msum[k] + m[k] for k in m}
        grads = tree_lib.tree_map(lambda g: (g / a).to(torch.float32), gsum)
        metrics = {k: v / a for k, v in msum.items()}
        metrics["tokens"] = msum["tokens"]
    gn = torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                        for x in tree_lib.leaves(grads)))
    scale = torch.clamp_max(tcfg.optimizer.grad_clip
                            / torch.clamp_min(gn, 1e-9), 1.0)
    grads = tree_lib.tree_map(
        lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads)
    params, opt = _oracle_update(tcfg.optimizer, grads, state.opt,
                                 state.params, state.step, state.generator)
    return state._replace(step=state.step + 1, params=params, opt=opt), \
        dict(metrics, grad_norm=gn)


# -- helpers -----------------------------------------------------------------

def _init(mcfg, tcfg):
    return tstep.init_state(mcfg, tcfg, seed=0, device="cpu")


def _batches(mcfg, n=STEPS, b=B, s=S):
    pipe = DataPipeline(mcfg, b, s, seed=1, kind="lm", device="cpu")
    return [pipe.batch_at(i) for i in range(n)]


def _copy(state):
    gen = torch.Generator().manual_seed(0)
    gen.set_state(state.generator.get_state())
    return state._replace(
        params=tree_lib.tree_map(torch.clone, state.params),
        opt=tree_lib.tree_map(torch.clone, state.opt), generator=gen)


def _same_state(a, b) -> bool:
    return a.step == b.step and all(
        torch.equal(x.view(torch.int32), y.view(torch.int32))
        for x, y in zip(tree_lib.leaves((a.params, a.opt)),
                        tree_lib.leaves((b.params, b.opt)))) and torch.equal(
        a.generator.get_state(), b.generator.get_state())


def _bits(t) -> bytes:
    return np.asarray(t.detach().to(torch.float32).numpy()).tobytes()


# -- tests -------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_buffered_step_equals_functional_step_bitwise(case):
    """3 steps of the buffered step against the functional oracle from the
    same state: every loss and grad norm, every parameter and optimizer
    leaf and the generator's state bitwise."""
    mcfg, tcfg = _cfg(), _tcfg(case)
    init = _init(mcfg, tcfg)
    want, got = _copy(init), init
    step_fn = tstep.make_train_step(mcfg, tcfg)
    for batch in _batches(mcfg):
        want, wm = _oracle_step(mcfg, tcfg, want, batch)
        got, gm = step_fn(got, batch)
        for k in ("loss", "ce", "tokens", "grad_norm"):
            assert _bits(gm[k]) == _bits(wm[k]), (case, k)
    assert _same_state(got, want), case
    if case == "insitu_sr":
        w = got.params["layers"][0]["mixer"]["wq"]
        assert torch.equal(float8.quantize_scaled(w), w)


def test_caller_state_untouched_and_result_is_the_buffers():
    """The caller's initial state is never written; every returned leaf is
    the step's own buffer, which the next call overwrites."""
    mcfg, tcfg = _cfg(), _tcfg("adamw")
    init = _init(mcfg, tcfg)
    before = _copy(init)
    step_fn = tstep.make_train_step(mcfg, tcfg)
    st = init
    for batch in _batches(mcfg):
        st, _ = step_fn(st, batch)
    assert _same_state(init, before)
    own = step_fn.state
    for a, b in zip(tree_lib.leaves((st.params, st.opt)),
                    tree_lib.leaves((own.params, own.opt))):
        assert a is b
    assert st.generator is own.generator and st.step == STEPS
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(
        tree_lib.leaves(init.params), tree_lib.leaves(st.params)))


def test_a_consumed_state_raises():
    """An older returned state aliases the buffers too, but a later call
    consumed it (as a donated JAX buffer): handing it in again raises
    rather than training from the newest buffers with its step's
    scalars. The latest returned state goes on."""
    mcfg, tcfg = _cfg(), _tcfg("adamw")
    batches = _batches(mcfg)
    step_fn = tstep.make_train_step(mcfg, tcfg)
    first, _ = step_fn(_init(mcfg, tcfg), batches[0])
    latest, _ = step_fn(first, batches[1])
    with pytest.raises(ValueError, match="consumed"):
        step_fn(first, batches[2])
    assert latest.step == step_fn.state.step == 2
    latest, _ = step_fn(latest, batches[2])
    assert latest.step == STEPS


def test_buffers_lie_with_the_generator():
    """The buffers are made on the device of the state's generator; a
    leaf that lies neither there nor on the host raises."""
    mcfg, tcfg = _cfg(), _tcfg("adamw")
    st = _init(mcfg, tcfg)
    step_fn = tstep.make_train_step(mcfg, tcfg)
    step_fn(st, _batches(mcfg, n=1)[0])
    assert all(t.device == st.generator.device for t in
               tree_lib.leaves((step_fn.state.params, step_fn.state.opt)))
    meta = st._replace(params=tree_lib.tree_map(
        lambda t: t.to("meta"), st.params))
    with pytest.raises(ValueError, match="meta"):
        tstep.make_train_step(mcfg, tcfg)(meta, _batches(mcfg, n=1)[0])


def test_restored_checkpoint_is_copied_in_and_resumes_bitwise(tmp_path):
    """A state restored from step 2's checkpoint, handed to a step whose
    buffers have moved on to step 3, is copied in: the resumed third step
    equals the uninterrupted one bitwise."""
    mcfg, tcfg = _cfg(), _tcfg("insitu_sr")
    batches = _batches(mcfg)
    ref_fn, st = tstep.make_train_step(mcfg, tcfg), _init(mcfg, tcfg)
    for b in batches:
        st, ref_m = ref_fn(st, b)
    step_fn, st = tstep.make_train_step(mcfg, tcfg), _init(mcfg, tcfg)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    for i, b in enumerate(batches):
        st, _ = step_fn(st, b)
        if i == 1:
            mgr.save(2, st)
    back = mgr.restore(2, st)
    assert back.step == 2 and back.params["embed"] is not st.params["embed"]
    resumed, m = step_fn(back, batches[2])
    assert _bits(m["loss"]) == _bits(ref_m["loss"])
    assert _same_state(resumed, ref_fn.state)


def test_one_program_per_batch_shape():
    mcfg, tcfg = _cfg(), _tcfg("sgd_momentum")
    step_fn, st = tstep.make_train_step(mcfg, tcfg), _init(mcfg, tcfg)
    for b in _batches(mcfg):
        st, _ = step_fn(st, b)
    assert step_fn.graphs.counts == {f"train_step[{B}x{S}]": 1}
    assert not step_fn.graphs.capture
    st, _ = step_fn(st, _batches(mcfg, n=1, b=2, s=8)[0])
    assert step_fn.graphs.counts == {f"train_step[{B}x{S}]": 1,
                                     "train_step[2x8]": 1}


def test_graphs_on_a_cpu_state_raise():
    mcfg, tcfg = _cfg(), _tcfg("adamw")
    step_fn = tstep.make_train_step(mcfg, tcfg, graphs=True)
    with pytest.raises(ValueError, match="CUDA"):
        step_fn(_init(mcfg, tcfg), _batches(mcfg, n=1)[0])


# Operators that wait for the device (a captured step must have none).
SYNCING = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
           "aten.unique", "aten._unique")


def test_step_body_never_syncs():
    """One step program (forward, recomputed blocks, backward, clip and
    the in-situ update) run under a dispatch mode: no operator that reads a
    device value back to the host."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(str(func.overloadpacket.__qualname__)
                           if hasattr(func, "overloadpacket") else str(func))
            self.names.add(str(func))
            return func(*args, **(kwargs or {}))

    mcfg, tcfg = _cfg(), _tcfg("insitu_sr")
    step_fn, st = tstep.make_train_step(mcfg, tcfg), _init(mcfg, tcfg)
    batch = _batches(mcfg, n=1)[0]
    step_fn(st, batch)
    keys = sorted(batch)
    body = step_fn._body(keys)
    scal = step_fn.optimizer.scalars(1)
    with Ops() as ops:
        body(*(batch[k] for k in keys), scal)
    assert any("mm" in n for n in ops.names)   # the mode saw the step
    hits = sorted(n for n in ops.names if any(n.startswith(s)
                                              for s in SYNCING))
    assert not hits, hits


@pytest.mark.parametrize("case", ["adamw", "adafactor"])
def test_host_scalars_bitwise(case):
    """The step's host scalars are the functional step's values bitwise
    per step; the rate equals, bitwise, the rate the reference's jitted
    update computes, over the warmup and past it (the schedule replays
    XLA's cosine and fused multiply-add on the host), and at every step of
    the card's 3-step schedule (warmup 1, total 3)."""
    from repro_torch.optim.optimizers import make_optimizer

    ocfg = _tcfg(case).optimizer
    opt = make_optimizer(ocfg)
    sched = schedules.get(ocfg.schedule, ocfg.lr, ocfg.warmup,
                          ocfg.total_steps)
    jref = jax.jit(jsched.get(ocfg.schedule, ocfg.lr, ocfg.warmup,
                              ocfg.total_steps))
    for step in range(ocfg.total_steps + 2):
        scal = opt.scalars(step)
        assert scal.dtype == torch.float32 and scal.device.type == "cpu"
        t = torch.tensor(step + 1.0, dtype=torch.float32)
        if case == "adamw":
            want = [sched(step),
                    1 - torch.pow(torch.tensor(ocfg.b1), t),
                    1 - torch.pow(torch.tensor(ocfg.b2), t)]
        else:
            want = [sched(step), 1.0 - torch.pow(t, -0.8)]
        assert _bits(scal) == _bits(torch.stack(want)), step
        assert _bits(scal[0]) == np.asarray(
            jref(jnp.int32(step)), np.float32).tobytes(), step
    card = (schedules.warmup_cosine(3e-4, 1, 3), jax.jit(
        jsched.warmup_cosine(3e-4, 1, 3)))
    for step in range(3):
        assert _bits(card[0](step)) == np.asarray(
            card[1](jnp.int32(step)), np.float32).tobytes()


def test_checkpoint_packing_in_slabs_is_the_whole_leaf(monkeypatch):
    """A leaf is packed in slabs of ``PACK_SLAB`` elements (bounded
    temporaries beside a full card's state): the planes equal those of
    one pass, and a leaf whose last slab is off the grid is stored as it
    is."""
    from repro_torch.checkpoint import manager

    rng = np.random.default_rng(11)
    grid = float8.quantize_scaled(torch.from_numpy(
        rng.standard_normal((37, 29)).astype(np.float32)))
    whole = manager._pack_leaf(grid)
    monkeypatch.setattr(manager, "PACK_SLAB", 100)
    slabs = manager._pack_leaf(grid)
    assert whole is not None and slabs is not None
    for k in whole:
        assert whole[k].dtype == slabs[k].dtype
        np.testing.assert_array_equal(whole[k], slabs[k], err_msg=k)
    off = grid.clone()
    off[-1, -1] += 1e-3   # off the grid in the last slab only
    assert manager._pack_leaf(off) is None
