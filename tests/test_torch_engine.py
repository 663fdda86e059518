"""Port parity and contracts of the dense fused serving engine.

Greedy token streams of the port's Engine must equal the reference
Engine's on reduced qwen3-0.6b (f32 activations, ``mode="pallas"``, the
same parameters through convert.py and the same prompts). The contract
tests pin the reference behaviour the port keeps: one device->host copy
per step, ``max_new_tokens=1`` finishing at prefill, EOS checked on the
prefill token, the cache-full done rule, and submit-time stamping."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from torch_parity import hold_stats, to_numpy  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_for_smoke as jreduced  # noqa: E402
from repro.core.timefloats import TFConfig as JTF  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.request import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config, reduced_for_smoke  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core.timefloats import TFConfig  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.engine import Engine, bucket_for  # noqa: E402
from repro_torch.serve.request import Request, percentile  # noqa: E402


def _cfgs():
    cj = dataclasses.replace(jreduced(jget_config("qwen3-0.6b")),
                             tf=JTF(mode="pallas"), dtype="float32")
    ct = dataclasses.replace(reduced_for_smoke(get_config("qwen3-0.6b")),
                             tf=TFConfig(mode="pallas"), dtype="float32")
    return cj, ct


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {f.uid: [int(t) for t in f.tokens] for f in eng.run_until_drained()}


BUDGETS = [5, 4, 1, 6]  # uid 2 finishes at prefill


@pytest.fixture(scope="module")
def reference_drain():
    """The reference engine's drain of four prompts: (port config, port
    params, prompts, streams, the reference engine)."""
    cj, ct = _cfgs()
    pj = JM.init(cj, jax.random.PRNGKey(0))
    pt = from_jax_params(to_numpy(pj), ct, "cpu")
    prompts = _prompts(cj.vocab_size, [5, 7, 3, 6])
    jeng = JEngine(pj, cj, slots=2, max_len=32, track_energy=False)
    want = _drain(jeng, [JRequest(uid=i, prompt=p, max_new_tokens=b)
                         for i, (p, b) in enumerate(zip(prompts, BUDGETS))])
    return ct, pt, prompts, want, jeng


def _port_drain(reference_drain):
    ct, pt, prompts, _, _ = reference_drain
    teng = Engine(pt, ct, slots=2, max_len=32, device="cpu")
    got = _drain(teng, [Request(uid=i, prompt=p, max_new_tokens=b)
                        for i, (p, b) in enumerate(zip(prompts, BUDGETS))])
    return teng, got


def test_greedy_streams_match_reference_engine(reference_drain):
    want, jeng = reference_drain[3:]
    teng, got = _port_drain(reference_drain)
    assert got == want
    assert [len(got[i]) for i in range(4)] == BUDGETS
    assert teng.steps == jeng.steps
    assert teng.host_transfers == jeng.host_transfers


def test_stats_match_reference_engine(reference_drain):
    """``stats()`` has the reference engine's keys (the port adds the
    twin's books as ``hw_*``) and every value that is not a wall-clock
    time equal to it, the compile and stall counters included."""
    jeng = reference_drain[4]
    teng, _ = _port_drain(reference_drain)
    hold_stats(teng.stats(), jeng.stats())


def _small_engine(**kw):
    _, ct = _cfgs()
    ct = dataclasses.replace(ct, n_layers=1)
    params = TM.init(ct, seed=0, device="cpu")
    return ct, Engine(params, ct, device="cpu", **kw)


def test_one_host_copy_per_step_across_buckets():
    ct, eng = _small_engine(slots=3, max_len=64)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=3)
            for i, p in enumerate(_prompts(ct.vocab_size, [4, 20, 9, 30]))]
    out = _drain(eng, reqs)
    assert sorted(out) == [0, 1, 2, 3]
    assert all(len(t) == 3 for t in out.values())
    assert eng.host_transfers == eng.steps  # every step also decoded
    st = eng.stats()
    assert st["finished"] == 4 and st["new_tokens"] == 12
    assert st["ttft_p50_s"] > 0.0


def test_eos_on_prefill_token_and_cache_full():
    ct, eng = _small_engine(slots=2, max_len=16)
    p = _prompts(ct.vocab_size, [5])[0]
    first = _drain(eng, [Request(uid=0, prompt=p, max_new_tokens=4)])[0][0]
    _, eng2 = _small_engine(slots=2, max_len=16, eos_id=first)
    assert _drain(eng2, [Request(uid=0, prompt=p, max_new_tokens=4)]) == \
        {0: [first]}
    # Cache-full: a slot is done once its length reaches max_len - 1.
    _, eng3 = _small_engine(slots=2, max_len=16)
    long = _drain(eng3, [Request(uid=0, prompt=p, max_new_tokens=100)])[0]
    assert len(long) == 16 - 1 - 5 + 1


def test_submit_stamps_time_and_helpers():
    ct, eng = _small_engine(slots=1, max_len=16)
    r = Request(uid=0, prompt=_prompts(ct.vocab_size, [3])[0])
    r.submit_t = 0.0
    eng.submit(r)
    assert r.submit_t > 0.0
    assert [bucket_for(n, 64) for n in (1, 8, 9, 33, 100)] == \
        [8, 8, 16, 64, 64]
    assert percentile([], 50) == 0.0
    assert percentile([3.0, 1.0, 2.0], 50) == 2.0
