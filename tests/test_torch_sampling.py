"""Port parity: K3 fused sampling. The port's sampler (its plain version
on these CPU tensors) against the reference's Pallas kernel in interpret
mode and its jnp ``argmax_low``, given the same logits and the same noise:
tokens must be bitwise, ties included. The CUDA kernel is held against the
same plain version on the card by chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import assert_bitwise  # noqa: E402

from repro.kernels import sampling as jsamp  # noqa: E402
from repro_torch.kernels import sampling as tsamp  # noqa: E402


def _case(seed: int, s: int = 6, v: int = 300):
    rng = np.random.default_rng(seed)
    # Coarse logits (multiples of 1/4) so exact ties are common, plus
    # injected ties at the maximum in every row.
    lg = np.round(rng.standard_normal((s, v)) * 8) / 4
    for r in range(s):
        top = lg[r].max() + 1.0
        lg[r, rng.choice(v, 3, replace=False)] = top
    noise = np.round(rng.gumbel(size=(s, v)) * 4) / 4
    temps = np.array([0.0, 0.8, -1.0, 1e-9, 2.0, 0.0][:s], np.float32)
    return lg.astype(np.float32), noise.astype(np.float32), temps


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_matches_interpret_kernel_with_ties(seed):
    lg, noise, temps = _case(seed)
    lg[3, 17] = np.nan  # a NaN row returns V, as the reference's masked min
    want = np.asarray(jsamp._sample_pallas(
        jnp.asarray(lg), jnp.asarray(noise), jnp.asarray(temps),
        interpret=True))
    before = tsamp.sample.launches
    got = tsamp.sample(torch.from_numpy(lg), torch.from_numpy(noise),
                       torch.from_numpy(temps))
    assert tsamp.sample.launches == before  # CPU tensors take the plain path
    assert got.dtype == torch.int32
    assert_bitwise(got.numpy(), want, "sampled tokens")
    assert got[3].item() == lg.shape[1]


def test_argmax_low_lowest_index_ties():
    lg, _, _ = _case(2)
    want = np.asarray(jsamp.argmax_low(jnp.asarray(lg), axis=-1))
    got = tsamp.argmax_low(torch.from_numpy(lg), dim=-1)
    assert_bitwise(got.numpy(), want, "argmax_low")
    all_tied = torch.zeros(2, 5)
    assert tsamp.argmax_low(all_tied).tolist() == [0, 0]


def test_sample_tokens_greedy_rows_ignore_noise():
    lg, _, _ = _case(3)
    temps = torch.zeros(lg.shape[0])
    zero = torch.zeros(lg.shape[0], dtype=torch.int32)
    got = tsamp.sample_tokens(torch.from_numpy(lg), temps,
                              torch.tensor([0, 7]), zero, zero)
    want = np.asarray(jsamp.argmax_low(jnp.asarray(lg), axis=-1))
    assert_bitwise(got.numpy(), want, "greedy rows")


def test_sample_rejects_bad_operands():
    lg = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        tsamp.sample(lg, torch.zeros(2, 7), torch.zeros(2))
    with pytest.raises(TypeError):
        tsamp.sample(lg.double(), lg.double(), torch.zeros(2))
