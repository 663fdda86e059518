"""Port parity of ``repro_torch.random`` (the threefry key chain) and of the
tempered sampling it feeds.

- Keys, ``fold_in``, ``random_bits``, ``uniform`` and ``gumbel`` are held
  bitwise against ``jax.random`` (JAX's default partitionable threefry
  layout) for several seeds and shapes, the sampler's (V,) rows of 512
  and 151936 among them. The Gumbel noise is bitwise: the port's log is
  the replay of the reference CPU backend's Cephes routine
  (``core/float8._log_f32``).
- ``kernels/sampling.sample_tokens`` with temperature rows equals the
  reference's ``sample_tokens`` for the same key, tags and counters.
- Tempered drains of reduced qwen3-0.6b (one layer, f32 activations, the
  reference's parameters through convert.py), dense and paged, give token
  streams identical to the JAX engine's. They run ``quant="none"``: the key
  chain is what they test (TimeFloats serving parity is
  tests/test_torch_engine.py's and test_torch_paged.py's), and the
  reference engine compiles a TimeFloats step about five times slower.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import assert_bitwise, to_numpy  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_for_smoke as jreduced  # noqa: E402
from repro.kernels import sampling as jsamp  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.request import Request as JRequest  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch.configs import get_config, reduced_for_smoke  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.kernels import sampling as tsamp  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.request import Request  # noqa: E402

SEEDS = (0, 42, -1, 2**31 - 1)


def _key_np(k) -> np.ndarray:
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_bitwise(seed):
    kj, kt = jax.random.PRNGKey(seed), rnd.PRNGKey(seed)
    assert np.array_equal(_key_np(kj), kt.numpy())
    for d in (0, 3, 2**31 + 5, 2**32 - 1):
        want = jax.random.fold_in(kj, np.uint32(d))
        assert np.array_equal(_key_np(want), rnd.fold_in(kt, d).numpy()), d
    # Batched data folds every key of a batch at once.
    data = np.array([1, 9, 2**31], np.int64)
    want = np.stack([_key_np(jax.random.fold_in(kj, np.uint32(d)))
                     for d in data])
    assert np.array_equal(want, rnd.fold_in(kt, torch.from_numpy(data))
                          .numpy())


BITS_CASES = [(0, (512,)), (42, (151936,)), (-1, (3, 5)), (7, (7,)),
              (2**31 - 1, (129280,))]


@pytest.mark.parametrize("seed,shape", BITS_CASES)
def test_random_bits_uniform_gumbel_bitwise(seed, shape):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    kt = rnd.fold_in(rnd.PRNGKey(seed), 3)
    bits = np.asarray(jax.random.bits(kj, shape)).astype(np.int64)
    assert np.array_equal(bits, rnd.random_bits(kt, shape).numpy())
    assert_bitwise(rnd.uniform(kt, shape).numpy(),
                   np.asarray(jax.random.uniform(kj, shape)), "uniform")
    assert_bitwise(rnd.gumbel(kt, shape).numpy(),
                   np.asarray(jax.random.gumbel(kj, shape, jnp.float32)),
                   "gumbel")


def test_prng_key_rejects_wide_seeds():
    with pytest.raises(ValueError):
        rnd.PRNGKey(2**31)


def test_tempered_sample_tokens_match_reference():
    rng = np.random.default_rng(5)
    lg = (rng.standard_normal((4, 512)) * 3).astype(np.float32)
    temps = np.array([0.0, 0.7, 1.0, 2.5], np.float32)
    tags = np.array([5, 0, 2**31 - 1, 11], np.int32)
    counters = np.array([0, 1, 7, 3], np.int32)
    want = jsamp.sample_tokens(jnp.asarray(lg), jnp.asarray(temps),
                               jax.random.PRNGKey(4), jnp.asarray(tags),
                               jnp.asarray(counters), use_pallas=False)
    got = tsamp.sample_tokens(torch.from_numpy(lg), torch.from_numpy(temps),
                              rnd.PRNGKey(4), torch.from_numpy(tags),
                              torch.from_numpy(counters))
    assert_bitwise(got.numpy(), np.asarray(want), "tempered tokens")


# ---------------------------------------------------------------------------
# Tempered engine drains against the reference engine.
# ---------------------------------------------------------------------------

PAGE, SLOTS, MAX_LEN = 8, 2, 48


@pytest.fixture(scope="module")
def qwen():
    cj = dataclasses.replace(jreduced(jget_config("qwen3-0.6b")),
                             quant="none", dtype="float32", n_layers=1)
    ct = dataclasses.replace(reduced_for_smoke(get_config("qwen3-0.6b")),
                             quant="none", dtype="float32", n_layers=1)
    pj = jax.jit(lambda k: JM.init(cj, k))(jax.random.PRNGKey(0))
    return cj, ct, pj, from_jax_params(to_numpy(pj), ct, "cpu")


def _tempered_stream(vocab):
    """Four requests, three tempered, all in one prefill bucket (each
    bucket is one more compile of the reference engine)."""
    rng = np.random.default_rng(8)
    return [(u, rng.integers(0, vocab, n).astype(np.int32), t)
            for u, (n, t) in enumerate(zip((17, 23, 20, 18),
                                           (0.8, 1.3, 0.0, 1.0)))]


def _drain(eng, req_cls, stream):
    for uid, prompt, temp in stream:
        eng.submit(req_cls(uid=100 + uid, prompt=prompt.copy(),
                           max_new_tokens=5, temperature=temp))
    return {f.uid: [int(t) for t in f.tokens]
            for f in eng.run_until_drained()}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_tempered_drain_matches_reference_engine(qwen, paged):
    cj, ct, pj, pt = qwen
    stream = _tempered_stream(cj.vocab_size)
    kw = dict(slots=SLOTS, max_len=MAX_LEN, seed=3, paged=paged,
              page_size=PAGE)
    want = _drain(JEngine(pj, cj, track_energy=False, **kw), JRequest,
                  stream)
    got = _drain(Engine(pt, ct, device="cpu", **kw), Request, stream)
    assert got == want
    greedy = _drain(Engine(pt, ct, device="cpu", **dict(kw, seed=4)),
                    Request, stream)
    assert greedy[102] == got[102]  # the greedy row ignores the key
