"""The port's dense generative serving (``serving/generative.py`` and its
host modules) against the JAX package, on the CPU.

The JAX package's config of ``tests/test_generative.py`` (vocab 64,
hidden 32, 2 layers, 2 heads, max_seq 32) and GPT_TINY; the same weights
go into both packages through ``convert.samediff_arrays_from_jax``,
float32 on both sides. Tolerances: the decode-mode prefill's logits
against the training graph's at 1e-5 of their largest magnitude;
``sample_token`` gives the JAX package's ids exactly (it is a copy over
the same float64 host math). The server's greedy tokens equal the JAX
package's ``greedy_decode`` tokens; inside the port they equal the port's
``greedy_decode`` bit for bit, whatever shares the batch. The server cases
(retirement paths, deadlines, cancel, admission, crash requeue) mirror
``tests/test_generative.py``.
"""
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving.generative import \
    greedy_decode as jax_greedy_decode
from deeplearning4j_tpu.serving.sampling import \
    sample_token as jax_sample_token
from deeplearning4j_tpu.zoo import gpt as jgpt
from deeplearning4j_tpu_torch.convert import samediff_arrays_from_jax
from deeplearning4j_tpu_torch.memory import AllocationsTracker
from deeplearning4j_tpu_torch.monitor.steptime import RollingPercentiles
from deeplearning4j_tpu_torch.monitor.trace import TRACER
from deeplearning4j_tpu_torch.serving import (GenerativeMetrics,
                                              GenerativeServer,
                                              LatencyHistogram,
                                              RequestTimeoutError,
                                              ResilienceConfig,
                                              RetryableServingError,
                                              ServerClosedError,
                                              ServerOverloadedError,
                                              ServingError,
                                              ServingTimeoutError,
                                              SlotAllocator, greedy_decode,
                                              pow2_buckets, sample_token)
from deeplearning4j_tpu_torch.serving.batching import BucketSpec
from deeplearning4j_tpu_torch.zoo import gpt as pgpt

MSL = 32
JCFG = jgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                      num_heads=2, intermediate_size=64, max_seq_len=MSL)
PCFG = pgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                      num_heads=2, intermediate_size=64, max_seq_len=MSL)


def _port_from_jax(jsd, cfg):
    sd = pgpt.build_gpt(cfg, batch=2, seq_len=8, seed=5, device="cpu")
    return samediff_arrays_from_jax(
        {n: np.asarray(a, np.float32)
         for n, a in jsd.trainable_params().items()}, sd)


@pytest.fixture(scope="module")
def jsd():
    return jgpt.build_gpt(JCFG, batch=2, seq_len=8, seed=0)


@pytest.fixture(scope="module")
def psd(jsd):
    return _port_from_jax(jsd, PCFG)


@pytest.fixture(scope="module")
def spec(psd):
    return pgpt.gpt_generative_spec(psd, PCFG)


def make_server(spec, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_seq_len", MSL)
    kw.setdefault("warmup", False)
    kw.setdefault("device", "cpu")
    return GenerativeServer(spec, **kw)


def ref_tokens(spec, prompt, n, eos_id=None):
    return greedy_decode(spec, prompt, n, eos_id=eos_id, max_seq_len=MSL,
                         device="cpu")


def mixed_prompts(n=6, seed=0, max_len=12, vocab=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(1, max_len + 1)))
            .astype(np.int32) for _ in range(n)]


# ----------------------------------------------------------------------
# host modules
class TestSlotAllocator:
    def test_alloc_free_cycle(self):
        a = SlotAllocator(3)
        s = [a.alloc() for _ in range(3)]
        assert sorted(s) == [0, 1, 2] and a.free_count() == 0
        with pytest.raises(RuntimeError):
            a.alloc()
        for x in s:
            a.free(x)
        assert a.free_count() == 3

    def test_double_free_raises(self):
        a = SlotAllocator(2)
        s = a.alloc()
        a.free(s)
        with pytest.raises(RuntimeError, match="twice"):
            a.free(s)


class TestHostModules:
    def test_latency_histogram_guards(self):
        h = LatencyHistogram()
        assert h.percentile(99) == 0.0 and h.mean() == 0.0
        h.record(float("nan"))
        assert h.max_ms == 0.0 and h.count == 1
        for ms in range(31):
            h.record(float(ms))
        assert h.summary()["low_sample"] is False

    def test_generative_metrics_record(self):
        m = GenerativeMetrics(max_slots=4)
        m.observe_decode_step(3, 2.0)
        m.observe_ttft(5.0)
        rec = m.to_record()
        assert rec["generative"]["slot_occupancy"] == 0.75
        assert rec["latency_ms"]["ttft"]["count"] == 1
        assert "generative:" in m.stats()

    def test_buckets_and_rolling_percentiles(self):
        assert pow2_buckets(32, n_buckets=6) == (1, 2, 4, 8, 16, 32)
        assert BucketSpec((4, 1, 16)).bucket_for(5) == 16
        r = RollingPercentiles(window=4)
        for v in (5, 1, 9, 3, 7):
            r.add(v)
        assert len(r) == 4 and r.percentile(100) == 9.0

    def test_typed_sheds_are_retryable_with_their_hint(self):
        e = ServerOverloadedError("full", retry_after_s=0.5)
        assert isinstance(e, RetryableServingError)
        assert isinstance(e, ServingError) and e.retry_after_s == 0.5

    def test_tracer_records_only_when_enabled(self):
        TRACER.reset()
        with TRACER.span("off"):
            pass
        TRACER.enable()
        try:
            with TRACER.span("outer", cat="t"):
                with TRACER.span("inner", k=1):
                    pass
        finally:
            TRACER.disable()
        spans = TRACER.spans()
        assert [s.name for s in spans] == ["inner", "outer"]
        assert spans[0].parent == spans[1].sid
        TRACER.reset()

    @pytest.mark.parametrize("temp,top_k,top_p", [
        (0.0, None, None), (1.0, None, None), (0.7, 5, None),
        (1.3, None, 0.9), (0.5, 3, 0.5)])
    def test_sample_token_gives_the_jax_values(self, temp, top_k, top_p):
        rng = np.random.default_rng(11)
        for seed in range(6):
            logits = rng.normal(size=64).astype(np.float32)
            logits[seed] = np.nan
            for index in (0, 7, 31):
                assert sample_token(logits, temp, top_k, top_p, seed,
                                    index) == jax_sample_token(
                    logits, temp, top_k, top_p, seed, index)


# ----------------------------------------------------------------------
# the decode math
def test_prefill_matches_the_training_graph_forward(psd, spec):
    prompt = np.asarray([5, 17, 40, 2, 33], np.int32)
    L = prompt.size
    full = pgpt.build_gpt(PCFG, batch=1, seq_len=L, seed=0, device="cpu")
    for n in pgpt.gpt_param_names(PCFG):
        full.set_arr_for_var(n, psd.get_arr_for_var(n))
    out = full.output({"input_ids": prompt[None],
                       "targets": np.zeros((1, L), np.int32)}, ["logits"])
    want = out["logits"][0, L - 1].numpy()
    z = torch.zeros(spec.kv_shape(1, MSL))
    with torch.inference_mode():
        _, _, nxt, logits = spec.prefill(
            spec.params(), z, z.clone(),
            {"tokens": np.pad(prompt, (0, 3)), "length": np.int32(L),
             "slot": np.int32(0)})
    err = float((logits - torch.from_numpy(want)).abs().max())
    assert err <= 1e-5 * float(np.abs(want).max())
    assert int(nxt) == int(np.argmax(want))


def test_greedy_decode_deterministic_and_stops_at_eos(spec):
    p = np.asarray([3, 9, 1], np.int32)
    full = ref_tokens(spec, p, 8)
    assert full == ref_tokens(spec, p, 8)
    eos = full[2]
    assert ref_tokens(spec, p, 8, eos_id=eos) == full[:full.index(eos) + 1]


@pytest.mark.parametrize("cfgs", ["small", "gpt_tiny"])
def test_server_greedy_tokens_match_jax_greedy_decode(cfgs, jsd, spec):
    if cfgs == "small":
        jspec, pspec, vocab, msl = (jgpt.gpt_generative_spec(jsd, JCFG),
                                    spec, 64, MSL)
    else:
        jtiny = jgpt.build_gpt(jgpt.GPT_TINY, batch=2, seq_len=8, seed=0)
        ptiny = pgpt.build_gpt(pgpt.GPT_TINY, batch=2, seq_len=8, seed=5,
                               device="cpu")
        samediff_arrays_from_jax({n: np.asarray(a, np.float32) for n, a in
                                  jtiny.trainable_params().items()}, ptiny)
        jspec = jgpt.gpt_generative_spec(jtiny, jgpt.GPT_TINY)
        pspec = pgpt.gpt_generative_spec(ptiny, pgpt.GPT_TINY)
        vocab, msl = 256, 64
    prompts = mixed_prompts(6, seed=4, max_len=20, vocab=vocab)
    with make_server(pspec, max_seq_len=msl) as srv:
        got = [h.result(timeout=120) for h in
               [srv.submit(p, max_new_tokens=9) for p in prompts]]
    want = [jax_greedy_decode(jspec, p, 9, max_seq_len=msl)
            for p in prompts]
    assert got == want


# ----------------------------------------------------------------------
# the server, inside the port
class TestServer:
    def test_mixed_run_bit_identical_to_unbatched(self, spec):
        prompts = mixed_prompts(8, seed=1)
        with make_server(spec, max_slots=4) as srv:
            handles = [srv.submit(p, max_new_tokens=6 + i % 5)
                       for i, p in enumerate(prompts)]
            results = [h.result(timeout=120) for h in handles]
        for i, (p, got) in enumerate(zip(prompts, results)):
            assert got == ref_tokens(spec, p, 6 + i % 5), f"request {i}"

    def test_static_admission_gives_the_same_tokens(self, spec):
        prompts = mixed_prompts(6, seed=8)
        with make_server(spec, max_slots=2, admit="static") as srv:
            got = [h.result(timeout=120) for h in
                   [srv.submit(p, max_new_tokens=5) for p in prompts]]
        assert got == [ref_tokens(spec, p, 5) for p in prompts]

    def test_streaming_on_token_and_future_agree(self, spec):
        seen = []
        with make_server(spec) as srv:
            h = srv.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=7,
                           on_token=seen.append)
            streamed = list(h.tokens(timeout=120))
            assert streamed == h.result(timeout=5) == seen
            assert len(streamed) == 7

    def test_eos_and_sequence_capacity_retire(self, spec):
        p = np.asarray([7, 7], np.int32)
        full = ref_tokens(spec, p, 10)
        eos = full[3]
        long = np.arange(MSL - 1, dtype=np.int32) % PCFG.vocab_size
        with make_server(spec) as srv:
            got_eos = srv.submit(p, max_new_tokens=10,
                                 eos_id=eos).result(timeout=120)
            got_cap = srv.generate(long, max_new_tokens=50)
            assert srv._slots.free_count() == srv.max_slots
        assert got_eos == full[:full.index(eos) + 1]
        assert got_cap == ref_tokens(spec, long, 50)
        assert 1 <= len(got_cap) <= 2

    def test_deadline_mid_generation_typed_with_partial(self, spec):
        with make_server(spec) as srv:
            h = srv.submit(np.asarray([9], np.int32), max_new_tokens=50,
                           timeout_ms=150,
                           on_token=lambda t: time.sleep(0.05))
            with pytest.raises(ServingTimeoutError) as ei:
                h.result(timeout=120)
            assert len(ei.value.tokens) >= 1
            assert ei.value.tokens == h.partial()
            with pytest.raises(ServingTimeoutError):
                list(h.tokens(timeout=5))
        assert srv.metrics.counters["requests_timed_out"] >= 1

    def test_cancel_resolves_partial_and_clean_stream(self, spec):
        with make_server(spec) as srv:
            h = srv.submit(np.asarray([8], np.int32), max_new_tokens=30,
                           on_token=lambda t: time.sleep(0.02))
            time.sleep(0.08)
            h.cancel()
            got = h.result(timeout=120)
            assert 1 <= len(got) < 30
            assert list(h.tokens(timeout=5)) == got
        assert srv.metrics.counters["requests_cancelled"] == 1

    def test_queued_deadline_expires_before_prefill(self, spec):
        srv = make_server(spec, start=False)
        try:
            h = srv.submit(np.asarray([5], np.int32), max_new_tokens=4,
                           timeout_ms=1)
            time.sleep(0.05)
            srv.start()
            with pytest.raises(RequestTimeoutError):
                h.result(timeout=60)
        finally:
            srv.shutdown()

    def test_kv_poison_no_bleed_on_slot_reuse(self, spec):
        p2 = np.asarray([11, 3, 7], np.int32)
        with make_server(spec, max_slots=2) as srv:
            srv.generate(np.asarray([1, 2, 3, 4, 5], np.int32),
                         max_new_tokens=8)
            time.sleep(0.05)
            with srv._exec_lock, torch.inference_mode():
                srv._kc.fill_(float("nan"))
                srv._vc.fill_(float("nan"))
            got = srv.generate(p2, max_new_tokens=8)
        assert got == ref_tokens(spec, p2, 8)

    def test_warmup_then_traffic_runs_no_new_shape(self, psd):
        fresh = pgpt.gpt_generative_spec(psd, PCFG)
        with make_server(fresh, warmup=True) as srv:
            assert srv.warmup_report["prefill_buckets"] == \
                [1, 2, 4, 8, 16, 32]
            assert srv.metrics.counters["warmup_compiles"] == 7
            for i, p in enumerate(mixed_prompts(6, seed=3, max_len=20)):
                srv.generate(p, max_new_tokens=3 + i % 4)
            assert srv.metrics.counters["compiles"] == 0

    def test_admission_sheds_typed_on_estimated_ttft(self, spec):
        cfg = ResilienceConfig(min_exec_samples=4, percentile=99.0)
        srv = make_server(spec, resilience=cfg, start=False)
        try:
            for _ in range(8):
                srv.admission.observe(50.0)
            srv.submit(np.asarray([1], np.int32), 4)
            with pytest.raises(ServerOverloadedError) as ei:
                srv.submit(np.asarray([2], np.int32), 4, timeout_ms=20.0)
            assert ei.value.retry_after_s > 0
            assert srv.metrics.counters["requests_shed"] == 1
        finally:
            srv.shutdown(drain=False)

    def test_queue_full_rejects_typed(self, spec):
        srv = make_server(spec, max_queue_len=2, start=False,
                          resilience=False)
        try:
            srv.submit(np.asarray([1], np.int32), 2)
            srv.submit(np.asarray([2], np.int32), 2)
            with pytest.raises(ServerOverloadedError):
                srv.submit(np.asarray([3], np.int32), 2)
            assert srv.metrics.counters["requests_rejected"] == 1
        finally:
            srv.shutdown(drain=False)

    def test_submit_validation_and_closed(self, spec):
        with make_server(spec, start=False) as srv:
            for bad in ([], np.arange(MSL), [PCFG.vocab_size]):
                with pytest.raises(ValueError):
                    srv.submit(np.asarray(bad, np.int32), 4)
            with pytest.raises(ValueError):
                srv.submit(np.asarray([1], np.int32), 0)
            with pytest.raises(ValueError):
                srv.submit(np.asarray([1], np.int32), 4, temperature=-1)
        with pytest.raises(ServerClosedError):
            srv.submit(np.asarray([1], np.int32), 4)

    def test_shutdown_never_started_fails_queued_typed(self, spec):
        srv = make_server(spec, start=False)
        h = srv.submit(np.asarray([1], np.int32), 4)
        srv.shutdown()
        with pytest.raises(ServerClosedError):
            h.result(timeout=5)

    def test_update_model_serves_new_params(self, spec, psd):
        p = np.asarray([6, 6, 6], np.int32)
        with make_server(spec) as srv:
            before = srv.generate(p, max_new_tokens=6)
            old = psd.get_arr_for_var("wte")
            try:
                psd.set_arr_for_var("wte", old + 0.5)
                srv.update_model()
                after = srv.generate(p, max_new_tokens=6)
                want = ref_tokens(spec, p, 6)
            finally:
                psd.set_arr_for_var("wte", old)
                srv.update_model()
            assert after == want
            assert srv.generate(p, max_new_tokens=6) == before

    def test_a_set_reaches_the_server_only_through_update_model(self, spec,
                                                                psd):
        """The server decodes with the tensors it pulled: a later
        set_arr_for_var stores a new tensor and leaves those as they
        were, so the server sees the new weights only after
        update_model()."""
        p = np.asarray([6, 6, 6], np.int32)
        name = "ln_f/beta"
        with make_server(spec) as srv:
            before = srv.generate(p, max_new_tokens=6)
            old = psd.get_arr_for_var(name)
            kept = old.clone()
            shift = np.random.default_rng(1).normal(0, 3, tuple(old.shape))
            try:
                psd.set_arr_for_var(name, shift.astype(np.float32))
                assert torch.equal(old, kept)
                assert srv.generate(p, max_new_tokens=6) == before
                srv.update_model()
                after = srv.generate(p, max_new_tokens=6)
                want = ref_tokens(spec, p, 6)
            finally:
                psd.set_arr_for_var(name, old)
                srv.update_model()
            assert after == want and after != before
            assert srv.generate(p, max_new_tokens=6) == before

    def test_sampled_tokens_reproduce_whatever_shares_the_batch(self, spec):
        p = np.asarray([4, 20, 9], np.int32)
        kw = dict(max_new_tokens=6, temperature=0.8, top_k=10, seed=42)
        with make_server(spec, max_slots=1) as srv:
            alone = srv.submit(p, **kw).result(timeout=60)
        with make_server(spec, max_slots=4) as srv:
            hs = [srv.submit(q, max_new_tokens=6)
                  for q in mixed_prompts(3, seed=9)]
            shared = srv.submit(p, **kw).result(timeout=60)
            [h.result(timeout=60) for h in hs]
        assert alone == shared

    def test_kv_slab_bytes_tracked_and_released(self, spec):
        tr = AllocationsTracker.get_instance()
        before = tr.bytes_tracked("kv_slab")
        srv = make_server(spec, max_slots=2)
        assert tr.bytes_tracked("kv_slab") - before == \
            srv.kv_slab_bytes == 2 * 2 * 2 * 2 * MSL * 16 * 4
        assert tuple(srv._kc.shape) == (2, 2, 2, MSL, 16)
        srv.shutdown()
        assert tr.bytes_tracked("kv_slab") == before

    def test_decode_spans_when_tracing(self, spec):
        TRACER.reset()
        TRACER.enable()
        try:
            with make_server(spec) as srv:
                srv.generate(np.asarray([1, 2], np.int32), max_new_tokens=3)
        finally:
            TRACER.disable()
        names = {s.name for s in TRACER.spans()}
        TRACER.reset()
        assert {"serving.enqueue", "serving.prefill", "serving.decode",
                "serving.reply"} <= names

    def test_not_ported_options_raise(self, spec, psd):
        """The telemetry endpoint is refused by name; int8 KV, refused
        here until it was ported, now serves through the dense server,
        equal to ``greedy_decode`` of its spec."""
        with pytest.raises(NotImplementedError, match="telemetry"):
            make_server(spec, telemetry_port=0)
        qspec = pgpt.gpt_generative_spec(psd, PCFG, quantize_kv=True)
        prompt = np.array([4, 1, 7], np.int32)
        with make_server(qspec) as srv:
            assert srv._kc.dtype == torch.int8
            got = srv.submit(prompt, max_new_tokens=6).result(timeout=60)
        assert got == greedy_decode(qspec, prompt, 6, max_seq_len=MSL,
                                    device="cpu")


# ----------------------------------------------------------------------
class TestCrashRecovery:
    @pytest.mark.chaos
    def test_worker_crash_requeues_at_prefill_exactly_once(self, spec):
        prompts = mixed_prompts(3, seed=7)
        srv = make_server(spec, max_slots=2, start=False,
                          resilience=ResilienceConfig(
                              worker_backoff_base_s=0.01,
                              worker_backoff_max_s=0.05))
        real = srv._decode_disp
        state = {"calls": 0, "fired": False}

        def crash_once(*args):
            state["calls"] += 1
            if not state["fired"] and state["calls"] > 2:
                state["fired"] = True
                raise RuntimeError("chaos: decode worker dies")
            return real(*args)

        srv._decode_disp = crash_once
        try:
            srv.start()
            results = [h.result(timeout=120) for h in
                       [srv.submit(p, max_new_tokens=8) for p in prompts]]
        finally:
            srv.shutdown()
        assert state["fired"]
        for p, got in zip(prompts, results):
            assert got == ref_tokens(spec, p, 8)
        assert srv.metrics.counters["worker_restarts"] >= 1
        assert srv.metrics.counters["requests_requeued"] >= 1

    @pytest.mark.chaos
    def test_twice_lost_request_fails_typed(self, spec):
        srv = make_server(spec, max_slots=2, start=False,
                          resilience=ResilienceConfig(
                              worker_backoff_base_s=0.01,
                              worker_backoff_max_s=0.05))

        def always_crash(*args):
            raise RuntimeError("chaos: decode always dies")

        srv._decode_disp = always_crash
        try:
            srv.start()
            h = srv.submit(np.asarray([1, 2], np.int32), max_new_tokens=8)
            with pytest.raises(ServingError, match="twice"):
                h.result(timeout=120)
        finally:
            srv.shutdown(drain=False)

    def test_unsupervised_crash_fails_inflight(self, spec):
        srv = make_server(spec, max_slots=2, start=False, resilience=False)

        def crash(*args):
            raise RuntimeError("decode crash, no supervisor")

        srv._decode_disp = crash
        try:
            srv.start()
            h = srv.submit(np.asarray([1], np.int32), max_new_tokens=8)
            with pytest.raises(RuntimeError, match="no supervisor"):
                h.result(timeout=60)
        finally:
            srv.shutdown(drain=False)
