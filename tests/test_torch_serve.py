"""Serving in the port: temperature-0 greedy tokens equal the JAX package's,
and the port's ServeEngine is invisible to any single request (slot refill,
eviction replay, batch composition), with continuous batching taking fewer
ticks than static; its request records pass both packages'
``validate_record``, and the serving plans it does not run raise.  yi-6b
reduced, fp32, on the CPU."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import telemetry as jax_tel
from repro.models.model import Model as JaxModel
from repro.runtime.serve_loop import greedy_generate as jax_greedy_generate
from repro_torch.configs import get_config
from repro_torch.core import telemetry as tel
from repro_torch.core.compute import ComputePolicy
from repro_torch.interop import from_jax_params
from repro_torch.models.model import Model
from repro_torch.runtime.serve_engine import Request, ServeEngine
from repro_torch.runtime.serve_loop import greedy_generate
from repro_torch.runtime.train_loop import ParallelPlan

# tiny shapes: intra-op threads only add overhead here, and they
# oversubscribe the cores shared by parallel test workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(jax_get_config("yi-6b").reduced(), jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config("yi-6b").reduced(), torch.float32,
               compute=ComputePolicy(kernels=True), device="cpu")
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp), tm))
    return jm, jp, tm


def _prompt(seed, length, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, length).astype(np.int32)


def test_greedy_tokens_equal_jax(pair):
    """16 greedy steps for 2 prompts; each step's top-1 margin is above
    1e-3, far beyond the 1e-4 logit agreement, so equality is meaningful."""
    jm, jp, tm = pair
    prompt = np.stack([_prompt(1, 12), _prompt(2, 12)])
    ref = np.asarray(jax_greedy_generate(jm, jp, jnp.asarray(prompt), 16, 32))
    out = greedy_generate(tm, torch.from_numpy(prompt), 16, 32).numpy()
    np.testing.assert_array_equal(out, ref)
    # the margins, from the port's own prefill + decode
    logits, cache = tm.prefill({"tokens": torch.from_numpy(prompt)}, 32)
    for step in range(16):
        top2 = torch.topk(logits, 2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-3, step
        tok = torch.argmax(logits, dim=-1)[:, None]
        np.testing.assert_array_equal(tok[:, 0].numpy(), out[:, step])
        logits, cache = tm.decode_step(cache, {"token": tok})


def test_engine_matches_greedy(pair):
    """3 requests over 2 slots (a mid-run refill): each request's tokens
    equal its solo greedy_generate stream."""
    _, _, tm = pair
    prompts = [_prompt(10 + i, n) for i, n in enumerate([5, 9, 7])]
    refs = [greedy_generate(tm, torch.from_numpy(p)[None], 6, 32)[0].numpy()
            for p in prompts]
    eng = ServeEngine(tm, n_slots=2, cache_len=32, block_size=4)
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=6)
                   for i, p in enumerate(prompts)])
    for i in range(3):
        np.testing.assert_array_equal(out[i], refs[i])
    assert [r["finish_reason"] for r in eng.records] == ["max_new_tokens"] * 3
    for r in eng.records:
        assert r["t_arrival"] <= r["t_admit"] <= r["t_first_token"] <= r["t_done"]


def test_eviction_replays_exactly(pair):
    """6 usable blocks for 2 growing requests: one is evicted, requeued with
    its generated prefix, and still reproduces its solo greedy stream."""
    _, _, tm = pair
    prompts = [_prompt(20 + i, 6) for i in range(2)]
    refs = [greedy_generate(tm, torch.from_numpy(p)[None], 10, 64)[0].numpy()
            for p in prompts]
    eng = ServeEngine(tm, n_slots=2, cache_len=64, block_size=4, n_blocks=7)
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=10)
                   for i, p in enumerate(prompts)])
    assert eng.n_evictions >= 1
    for i in range(2):
        np.testing.assert_array_equal(out[i], refs[i])


def test_continuous_beats_static_ticks(pair):
    """Long-first workload: slot refill finishes the same tokens in fewer
    decode ticks than drain-then-refill batching."""
    _, _, tm = pair

    def reqs():
        return [Request(rid=i, prompt=_prompt(30 + i, 4 + i),
                        max_new_tokens=3 + 4 * (3 - i)) for i in range(4)]

    e_c = ServeEngine(tm, n_slots=2, cache_len=64, block_size=4, continuous=True)
    out_c = e_c.run(reqs())
    e_s = ServeEngine(tm, n_slots=2, cache_len=64, block_size=4, continuous=False)
    out_s = e_s.run(reqs())
    for i in range(4):
        np.testing.assert_array_equal(out_c[i], out_s[i])
    assert e_c.n_ticks < e_s.n_ticks


def test_sampling_stream_independent_of_slot_and_batch(pair):
    """A temperature > 0 request draws the same tokens alone in slot 0 and
    in slot 1 beside other requests, and different tokens under another
    seed."""
    _, _, tm = pair
    target = dict(prompt=_prompt(40, 6), max_new_tokens=8, temperature=1.5,
                  top_p=0.9)
    solo = ServeEngine(tm, n_slots=2, cache_len=32, block_size=4).run(
        [Request(rid=0, seed=7, **target)])[0]
    crowd = ServeEngine(tm, n_slots=2, cache_len=32, block_size=4).run(
        [Request(rid=1, prompt=_prompt(41, 5), max_new_tokens=3),
         Request(rid=0, seed=7, **target),
         Request(rid=2, prompt=_prompt(42, 9), max_new_tokens=4, temperature=1.0,
                 seed=3)])
    np.testing.assert_array_equal(crowd[0], solo)
    other = ServeEngine(tm, n_slots=2, cache_len=32, block_size=4).run(
        [Request(rid=0, seed=8, **target)])[0]
    assert not np.array_equal(other, solo)


def test_stop_token_finishes_request(pair):
    _, _, tm = pair
    p = _prompt(50, 6)
    ref = greedy_generate(tm, torch.from_numpy(p)[None], 6, 32)[0].numpy()
    eng = ServeEngine(tm, n_slots=2, cache_len=32, block_size=4)
    out = eng.run([Request(rid=0, prompt=p, max_new_tokens=6,
                           stop_tokens=(int(ref[2]),))])
    first = int(np.argmax(ref == ref[2]))
    np.testing.assert_array_equal(out[0], ref[:first + 1])
    assert eng.records[0]["finish_reason"] == "stop_token"


def test_request_records_validate_under_both(pair, tmp_path):
    """One ``request`` record per finished request, in ``records`` and in a
    JSONL sink: each passes the port's and the reference's
    ``validate_record``, and the file both ``validate_jsonl``."""
    _, _, tm = pair
    path = str(tmp_path / "serve.jsonl")
    with tel.JsonlSink(path) as sink:
        eng = ServeEngine(tm, n_slots=2, cache_len=64, block_size=4, n_blocks=7,
                          telemetry_sink=sink)
        eng.run([Request(rid=i, prompt=_prompt(60 + i, 6), max_new_tokens=10)
                 for i in range(2)])
    assert eng.n_evictions >= 1
    assert sorted(r["rid"] for r in eng.records) == [0, 1]
    for rec in eng.records:
        assert rec["kind"] == "request" and rec["n_generated"] == 10
        tel.validate_record(rec)
        jax_tel.validate_record(rec)
    assert sum(r["evictions"] for r in eng.records) == eng.n_evictions
    assert tel.validate_jsonl(path) == jax_tel.validate_jsonl(path) == eng.records
    bad = dict(eng.records[0], t_done=eng.records[0]["t_arrival"] - 1.0)
    for validate in (tel.validate_record, jax_tel.validate_record):
        with pytest.raises(ValueError, match="monotone"):
            validate(bad)


@pytest.mark.parametrize("plan", [dict(tp=2), dict(pp=2), dict(dp=2, zero=1)],
                         ids=["tp", "pp", "zero1"])
def test_serving_plans_not_ported_raise(pair, plan):
    """dp slots only: tp, pp and ZeRO serving raise before any group is
    touched."""
    _, _, tm = pair
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeEngine(tm, n_slots=2, cache_len=32, mesh=object(), plan=ParallelPlan(**plan))
