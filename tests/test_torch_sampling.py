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


V_EDGE = 301  # odd: rows start off the 16-byte grid, as a split row meets


def _edge(case: str):
    """Two rows of V_EDGE, the first greedy and the second at temperature
    0.8, holding one edge a row split over blocks can get wrong; returns
    (lg, noise, temps, expected tokens or None)."""
    rng = np.random.default_rng(7)
    v = V_EDGE
    lg = np.round(rng.standard_normal((2, v)) * 8) / 4
    noise = np.zeros((2, v))
    want = None
    if case == "all_neg_inf":
        lg[:] = -np.inf
        noise = rng.gumbel(size=(2, v))
        want = [0, 0]
    elif case == "max_at_last":
        lg[:, v - 1] = lg.max() + 1.0
        want = [v - 1, v - 1]
    elif case == "tie_first_and_last":
        lg[:, 0] = lg[:, v - 1] = lg.max() + 1.0
        want = [0, 0]
    elif case == "noise_decides":
        lg[:] = 0.0
        noise = np.round(rng.gumbel(size=(2, v)) * 4) / 4
        noise[1, 150] = noise.max() + 1.0
        want = [0, 150]
    elif case == "odd_v_random":
        noise = np.round(rng.gumbel(size=(2, v)) * 4) / 4
        lg[:, rng.choice(v, 4, replace=False)] = lg.max() + 0.5
    temps = np.array([0.0, 0.8], np.float32)
    return lg.astype(np.float32), noise.astype(np.float32), temps, want


@pytest.mark.parametrize("case", ["all_neg_inf", "max_at_last",
                                  "tie_first_and_last", "noise_decides",
                                  "odd_v_random"])
def test_sample_row_edges_match_reference(case):
    """The cases a row cut over a cluster of blocks can get wrong: an all
    -inf row (token 0), the maximum at index V-1, a tie between index 0 and
    V-1, a temperature row won only through its noise, and an odd V. The
    port's sampler against interpret-mode Pallas and ``argmax_low``."""
    lg, noise, temps, want = _edge(case)
    ref = np.asarray(jsamp._sample_pallas(
        jnp.asarray(lg), jnp.asarray(noise), jnp.asarray(temps),
        interpret=True))
    low = np.asarray(jsamp.argmax_low(
        jnp.asarray(np.stack([lg[0], lg[1] / np.float32(0.8) + noise[1]])),
        axis=-1))
    got = tsamp.sample(torch.from_numpy(lg), torch.from_numpy(noise),
                       torch.from_numpy(temps)).numpy()
    assert_bitwise(got, ref, f"{case}: vs Pallas")
    assert_bitwise(got, low, f"{case}: vs argmax_low")
    if want is not None:
        assert got.tolist() == want


@pytest.mark.parametrize("v", [151936, 129280, 151937, V_EDGE, 5, 3])
def test_row_slices_cover_each_row_once(v):
    """The kernel's cut of a row over 1-16 blocks: contiguous, in order,
    covering [0, V) exactly once, with every internal boundary on a
    16-byte-aligned element of the row."""
    for blocks in (1, 4, 8, 16):
        for row in range(4):
            cuts = tsamp.row_slices(v, blocks, row)
            assert len(cuts) == blocks
            assert cuts[0][0] == 0 and cuts[-1][1] == v
            assert all(a <= b for a, b in cuts)
            assert all(cuts[i][1] == cuts[i + 1][0]
                       for i in range(blocks - 1))
            inner = [b for _, b in cuts[:-1] if 0 < b < v]
            assert all((row * v + b) % 4 == 0 for b in inner)


def test_cluster_pick_takes_the_largest_cluster_that_fits():
    """K3's blocks per row: the largest of 16, 8 and 4 of which the card can
    hold a cluster (``cudaOccupancyMaxActiveClusters``, stubbed here: a
    full H100, a partition whose GPCs have at most 8 free SMs, one with
    only 4), asked in that order; none fitting raises."""
    asked = []

    def card(free_sms):
        def max_clusters(p):
            asked.append(p)
            return 7 if p <= free_sms else 0
        return max_clusters

    assert tsamp.pick_blocks_per_row(card(18)) == 16
    assert asked == [16]
    asked.clear()
    assert tsamp.pick_blocks_per_row(card(8)) == 8
    assert asked == [16, 8]
    assert tsamp.pick_blocks_per_row(card(5)) == 4
    with pytest.raises(RuntimeError, match="no cluster"):
        tsamp.pick_blocks_per_row(card(3))
