"""Where the port's bf16 training gradients part from the reference's.

Not a test (pytest does not collect it): a diagnostic for ROADMAP Queue 3.
On reduced qwen3-0.6b with bf16 activations (the case of
``tests/test_torch_train.py::test_bf16_loss_and_grads_close_to_reference``)
it takes the step-0 loss and gradients four ways: the reference jitted
(as its train step runs), the reference op by op under
``jax.disable_jit()`` (every bf16 op rounds, as in PyTorch), the reference
compiled with ``xla_allow_excess_precision=False`` (every bf16 op rounds
inside XLA's fusions too; what that test compares against), and the port.
It prints each leaf's cosine for the pairs, then counts the fusions
of the reference's optimized HLO that read bf16 and chain two or more f32
arithmetic ops without rounding between them (XLA's excess precision),
and prints the largest. Run: ``PYTHONPATH=src:tests python
tests/torch_bf16_probe.py`` (about two minutes on a CPU).
"""
import re

import jax
import jax.numpy as jnp

import test_torch_train as T
from repro.data.pipeline import DataPipeline as JPipeline
from repro.models import model as JM
from repro_torch import tree as tree_lib
from repro_torch.convert import from_jax_params
from repro_torch.train import step as tstep
from torch_parity import to_numpy


def main() -> None:
    cj = T._ref_config("bfloat16")
    params = to_numpy(jax.jit(lambda k: JM.init(cj, k))(
        jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, params)
    batch = to_numpy(JPipeline(cj, 2, 32, seed=0, kind="lm").batch_at(0))
    jb = jax.tree.map(jnp.asarray, batch)
    vg = jax.value_and_grad(lambda p, b: JM.loss_fn(p, b, cj)[0])
    loss_jit, g_jit = jax.jit(vg)(jp, jb)
    with jax.disable_jit():
        loss_eager, g_eager = vg(jp, jb)
    loss_strict, g_strict = jax.jit(vg).lower(jp, jb).compile(
        compiler_options={"xla_allow_excess_precision": False})(jp, jb)
    ct = T._port_config(dtype="bfloat16")
    metrics, g_port = tstep.loss_and_grads(
        ct, from_jax_params(params, ct, "cpu"), T._batch(batch))
    print(f"loss: reference jitted {float(loss_jit):.7f}, op by op "
          f"{float(loss_eager):.7f}, strict {float(loss_strict):.7f}, port "
          f"{float(metrics['loss']):.7f}")
    g_jit, g_eager, g_strict = (from_jax_params(to_numpy(g), ct, "cpu")
                                for g in (g_jit, g_eager, g_strict))
    print("leaf: cosine port~jitted, port~op-by-op, op-by-op~jitted, "
          "port~strict")
    for (path, g), a, e, st in zip(tree_lib.leaves_with_path(g_port),
                                   tree_lib.leaves(g_jit),
                                   tree_lib.leaves(g_eager),
                                   tree_lib.leaves(g_strict)):
        print(f"  {tree_lib.path_str(path)}: {T._cosine(g, a):.6f} "
              f"{T._cosine(g, e):.6f} {T._cosine(e, a):.6f} "
              f"{T._cosine(g, st):.11f}")

    hlo = jax.jit(vg).lower(jp, jb).compile().as_text()
    fusions = re.findall(r"(%?fused_computation[\w.\-]*) (\([^\n]*\)) -> "
                         r"[^\n]* \{\n(.*?)\n\}", hlo, re.S)
    arith = re.compile(r"= f32\[[^\]]*\]\S* (multiply|add|subtract|divide|"
                       r"exponential|negate)\(")
    hits = [(name, [ln.strip() for ln in body.split("\n")
                    if arith.search(ln)])
            for name, sig, body in fusions if "bf16" in sig]
    hits = [(n, ops) for n, ops in hits if len(ops) >= 2]
    print(f"optimized HLO: {len(hits)} of {len(fusions)} fused computations "
          "read bf16 and chain >= 2 f32 arithmetic ops")
    name, ops = max(hits, key=lambda h: len(h[1]))
    print(f"largest: {name}, {len(ops)} f32 arithmetic ops, e.g.")
    for ln in ops[:4]:
        print(f"  {ln[:140]}")


if __name__ == "__main__":
    main()
